"""CLI: ``python -m remotesensingproject_tpu_torch.cli.main <command>``.

Counterpart of ``remotesensingproject_tpu/cli/main.py``, with the same
commands and arguments, headless (windows become written PNGs):

  read-img        read one image, print stats
  build-epi       build and save one EPI (row ``--row``)
  gallery         dump the frames scaled to bytes
  depth1d         single-EPI depth (row ``--row``): coloured_epi.png
  pile            one s_hat, all rows: disparity_map.png, coloured_epi.png
  depth2d         full 2-D propagation: disparity_XXX.png
  fine-to-coarse  the pyramid pipeline: depth_map_XXX.png
  info            versions and the CUDA device
  bench           the benchmark (``remotesensingproject_tpu_torch.bench``:
                  bench.py's scenes and gates, chosen by its BENCH_*
                  environment variables; one JSON line)

Each depth command also writes its arrays to ``<command>_results.npz``
and runs on CUDA unless ``--device`` names another device.  ``--score``
and ``--fast`` set the params of every depth command (``depth1d``
included); ``--ckpt-dir`` saves and resumes the levels of
``fine-to-coarse``; ``--no-pallas`` runs the plain PyTorch versions on the
device (``pile``, ``depth2d``, ``fine-to-coarse``: the JAX package's XLA
path); ``--sharded`` runs ``fine-to-coarse`` over a process group: the
ranks of ``torchrun`` (``torchrun --nproc-per-node N -m
remotesensingproject_tpu_torch.cli.main fine-to-coarse --sharded ...``),
else one rank per visible card (one rank on ``--device``'s device when
it is given); rank 0 writes the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _add_io_args(p):
    p.add_argument("folder", help="folder of frames")
    p.add_argument("--ext", default="tif")
    p.add_argument("--transpose", action="store_true")
    p.add_argument("--rotate180", action="store_true")
    p.add_argument("--out", default="output")


def _add_depth_args(p):
    p.add_argument("--dmin", type=float, default=-1.0)
    p.add_argument("--dmax", type=float, default=4.0)
    p.add_argument("--dim-d", type=int, default=120)
    p.add_argument("--s-hat", type=int, default=-1)
    p.add_argument("--scale-factor", type=float, default=-1.0)
    p.add_argument("--no-pallas", action="store_true",
                   help="run the plain PyTorch versions instead of the "
                        "CUDA kernels, on the device (pile, depth2d, "
                        "fine-to-coarse)")
    p.add_argument("--sharded", action="store_true",
                   help="fine-to-coarse over a process group: torchrun's "
                        "ranks, else one rank per visible card")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint/resume directory (fine-to-coarse)")
    p.add_argument("--score", choices=["edge", "disp", "line"],
                   default="edge", help="confidence criterion")
    p.add_argument("--fast", action="store_true",
                   help="quality-gated fast mode: cap the pixel sweep's "
                        "mean shift at 5 iterations")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, required)")


def _make_params(args):
    from ..config import DEFAULT_PARAMS

    return dataclasses.replace(DEFAULT_PARAMS, score_version=args.score,
                               fast=args.fast)


def _use_pallas(args):
    return False if args.no_pallas else None


def _read_frames(args):
    from ..utils import io

    return io.read_imgs_from_folder(args.folder, args.ext,
                                    transpose=args.transpose,
                                    rotate_180=args.rotate180)


def _read_volume(args):
    from ..utils import io

    t0 = time.perf_counter()
    imgs = _read_frames(args)
    print(f"read {imgs.shape[0]} frames {imgs.shape[1]}x{imgs.shape[2]} "
          f"in {time.perf_counter() - t0:.2f}s")
    return io.build_epis_from_imgs(imgs)


def _numpy(**tensors):
    return {k: v.cpu().numpy() for k, v in tensors.items()}


def _squeeze(a):
    return a[..., 0] if a.shape[-1] == 1 else a


def cmd_read_img(args):
    from ..utils import io

    img = io.read_img_from_file(args.folder, args.name, args.ext)
    print(f"shape={img.shape} dtype={img.dtype} "
          f"min={img.min()} max={img.max()}")
    print(img[:3, :3])


def cmd_build_epi(args):
    from ..utils import io
    from ..utils.plot import copy_and_scale_uchar, draw_red_lines

    imgs = _read_frames(args)
    row = args.row if args.row >= 0 else imgs.shape[1] // 2
    epi = io.build_row_epi_from_imgs(imgs, row)
    io.write_img(draw_red_lines(_squeeze(imgs[0]), fill_row_red=row),
                 args.out, "epi_1st")
    io.write_img(copy_and_scale_uchar(_squeeze(epi)), args.out, "epi")
    print(f"EPI {epi.shape} written to {args.out}/")


def cmd_gallery(args):
    from ..utils import io
    from ..utils.plot import ImageConverterUint8

    imgs = _read_frames(args)
    conv = ImageConverterUint8().fit(imgs[0], saturate=True)
    for s in range(imgs.shape[0]):
        io.write_img(_squeeze(conv.copy_and_scale(imgs[s])), args.out,
                     f"frame_{s:03d}")
    print(f"{imgs.shape[0]} frames written to {args.out}/")


def cmd_depth1d(args):
    from ..models.depth1d import Depth1DComputer
    from ..utils import io

    params = _make_params(args)
    epis = _read_volume(args)
    v = args.row if args.row >= 0 else epis.shape[0] // 2
    t0 = time.perf_counter()
    computer = Depth1DComputer(epis[v], args.dmin, args.dmax, args.dim_d,
                               s_hat=args.s_hat,
                               epi_scale_factor=args.scale_factor,
                               params=params, device=args.device)
    res = computer.run()
    arrays = _numpy(**res._asdict())
    print(f"depth1d (row {v}) in {time.perf_counter() - t0:.2f}s")
    io.write_img(computer.get_coloured_epi(), args.out, "coloured_epi")
    path = io.write_npz(args.out, "depth1d_results", **arrays)
    print(f"PNG + npz written to {path}")


def cmd_pile(args):
    from ..models.pile import Depth1DComputerPile
    from ..utils import io

    params = _make_params(args)
    epis = _read_volume(args)
    t0 = time.perf_counter()
    computer = Depth1DComputerPile(
        epis, args.dmin, args.dmax, args.dim_d, s_hat=args.s_hat,
        epi_scale_factor=args.scale_factor, params=params,
        device=args.device, use_pallas=_use_pallas(args))
    res = computer.run()
    arrays = _numpy(**res._asdict())
    print(f"pile in {time.perf_counter() - t0:.2f}s")
    io.write_img(computer.get_disparity_map(), args.out, "disparity_map")
    io.write_img(computer.get_coloured_epi(), args.out, "coloured_epi")
    path = io.write_npz(args.out, "pile_results", **arrays)
    print(f"PNGs + npz written to {path}")


def cmd_depth2d(args):
    from ..models.depth2d import Depth2DComputer
    from ..utils import io
    from ..utils.plot import apply_colormap, copy_and_scale_uchar

    params = _make_params(args)
    epis = _read_volume(args)
    t0 = time.perf_counter()
    computer = Depth2DComputer(
        epis, args.dmin, args.dmax, args.dim_d,
        epi_scale_factor=args.scale_factor, params=params, verbose=True,
        device=args.device, use_pallas=_use_pallas(args))
    state = computer.run()
    arrays = _numpy(best_depth=state.best_depth,
                    disp_confidence=state.disp_conf,
                    edge_confidence=state.ce,
                    validity=computer.get_valid_depths_mask_s_v_u())
    print(f"depth2d in {time.perf_counter() - t0:.2f}s "
          f"({computer.passes_run} passes)")
    depths, masks = arrays["best_depth"], arrays["validity"]
    for s in range(depths.shape[0]):
        rgb = apply_colormap(copy_and_scale_uchar(depths[s]))
        rgb[~masks[s]] = 0
        io.write_img(rgb, args.out, f"disparity_{s:03d}")
    path = io.write_npz(args.out, "depth2d_results", **arrays)
    print(f"maps + npz written to {path}")


def cmd_fine_to_coarse(args, mesh=None):
    from ..models.fine_to_coarse import FineToCoarse
    from ..utils import io

    if args.sharded and mesh is None:
        return _run_sharded(args)
    params = _make_params(args)
    writer = mesh is None or mesh.rank == 0
    epis = _read_volume(args)
    t0 = time.perf_counter()
    ftc = FineToCoarse(epis, args.dmin, args.dmax, args.dim_d,
                       epi_scale_factor=args.scale_factor, params=params,
                       verbose=writer, device=args.device,
                       use_pallas=_use_pallas(args), mesh=mesh)
    ftc.run(ckpt_dir=args.ckpt_dir)
    maps = ftc.get_coloured_depth_maps()
    fused, validity = ftc.get_results()
    if not writer:
        return
    arrays = _numpy(fused=fused, validity=validity)
    print(f"fine-to-coarse in {time.perf_counter() - t0:.2f}s"
          + ("" if mesh is None else f" on {mesh.world} ranks"))
    for s in range(maps.shape[0]):
        io.write_img(maps[s], args.out, f"depth_map_{s:03d}")
    path = io.write_npz(args.out, "fine_to_coarse_results", **arrays)
    print(f"maps + npz written to {path}")


def _sharded_rank(rank, args):
    """One rank of ``fine-to-coarse --sharded`` in a started process
    group."""
    from ..parallel.mesh import make_mesh

    cmd_fine_to_coarse(args, make_mesh())


def _run_sharded(args):
    """``fine-to-coarse --sharded``: the ranks of torchrun (from the
    environment), else one rank per visible card, or one rank on
    ``--device``'s device when it is given."""
    import os

    import torch
    import torch.distributed as dist

    from ..parallel import distributed

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        distributed.initialize(device=args.device)
        try:
            _sharded_rank(dist.get_rank(), args)
        finally:
            dist.destroy_process_group()
        return
    if args.device is None:
        from ..types import resolve_device

        resolve_device(None)  # raises without a card
    world = 1 if args.device is not None else torch.cuda.device_count()
    distributed.spawn(_sharded_rank, world, args=(args,),
                      device=args.device)


def cmd_info(args):
    import torch

    import remotesensingproject_tpu_torch as rs

    print(f"remotesensingproject_tpu_torch {rs.__version__}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"cuda available: {torch.cuda.device_count()} device(s), "
              f"{torch.cuda.get_device_name(0)}")
    else:
        print("cuda available: no")


def cmd_bench(args):
    from .. import bench

    bench.main()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="remotesensingproject_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("read-img")
    p.add_argument("folder")
    p.add_argument("name")
    p.add_argument("--ext", default="tif")
    p.set_defaults(fn=cmd_read_img)

    p = sub.add_parser("build-epi")
    _add_io_args(p)
    p.add_argument("--row", type=int, default=-1)
    p.set_defaults(fn=cmd_build_epi)

    p = sub.add_parser("gallery")
    _add_io_args(p)
    p.set_defaults(fn=cmd_gallery)

    for name, fn in (("depth1d", cmd_depth1d), ("pile", cmd_pile),
                     ("depth2d", cmd_depth2d),
                     ("fine-to-coarse", cmd_fine_to_coarse)):
        p = sub.add_parser(name)
        _add_io_args(p)
        _add_depth_args(p)
        if name == "depth1d":
            p.add_argument("--row", type=int, default=-1)
        p.set_defaults(fn=fn)

    p = sub.add_parser("info")
    p.set_defaults(fn=cmd_info)
    p = sub.add_parser("bench", help="bench.py's scenes and gates on the "
                       "card (BENCH_HR, BENCH_D240, BENCH_RGB, BENCH_SCORE, "
                       "...); one JSON line")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
