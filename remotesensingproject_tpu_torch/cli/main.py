"""CLI: ``python -m remotesensingproject_tpu_torch.cli.main <command>``.

Counterpart of the ``pile``, ``depth2d`` and ``fine-to-coarse`` commands of
``remotesensingproject_tpu/cli/main.py``, with the same arguments: read a
folder of frames, run the computation, write its arrays to
``pile_results.npz``, ``depth2d_results.npz`` or
``fine_to_coarse_results.npz``.  Runs on CUDA unless ``--device`` names
another device.  ``--score line`` runs line mode and ``--fast`` caps the
pixel sweep's mean shift at 5 steps, as in the JAX commands.  The coloured
PNGs, ``--sharded``, ``--ckpt-dir``, ``--no-pallas`` and the other commands
are not ported yet (ROADMAP.md) and raise NotImplementedError.
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
                   help="not ported: use --device cpu for the plain "
                        "PyTorch versions")
    p.add_argument("--sharded", action="store_true", help="not ported")
    p.add_argument("--ckpt-dir", default=None, help="not ported")
    p.add_argument("--score", choices=["edge", "disp", "line"],
                   default="edge", help="confidence criterion")
    p.add_argument("--fast", action="store_true",
                   help="quality-gated fast mode: cap the pixel sweep's "
                        "mean shift at 5 iterations")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, required)")


def _make_params(args):
    from ..config import DEFAULT_PARAMS

    for flag, name in ((args.no_pallas, "--no-pallas"),
                       (args.sharded, "--sharded"),
                       (args.ckpt_dir, "--ckpt-dir")):
        if flag:
            raise NotImplementedError(f"{name} is not ported yet")
    return dataclasses.replace(DEFAULT_PARAMS, score_version=args.score,
                               fast=args.fast)


def _read_volume(args):
    from ..utils import io

    t0 = time.perf_counter()
    imgs = io.read_imgs_from_folder(args.folder, args.ext,
                                    transpose=args.transpose,
                                    rotate_180=args.rotate180)
    print(f"read {imgs.shape[0]} frames {imgs.shape[1]}x{imgs.shape[2]} "
          f"in {time.perf_counter() - t0:.2f}s")
    return io.build_epis_from_imgs(imgs)


def _numpy(**tensors):
    return {k: v.cpu().numpy() for k, v in tensors.items()}


def cmd_pile(args):
    from ..models.pile import Depth1DComputerPile
    from ..utils import io

    params = _make_params(args)
    epis = _read_volume(args)
    t0 = time.perf_counter()
    computer = Depth1DComputerPile(
        epis, args.dmin, args.dmax, args.dim_d, s_hat=args.s_hat,
        epi_scale_factor=args.scale_factor, params=params,
        device=args.device)
    res = computer.run()
    arrays = _numpy(**res._asdict())
    print(f"pile in {time.perf_counter() - t0:.2f}s")
    path = io.write_npz(args.out, "pile_results", **arrays)
    print(f"npz written to {path}")


def cmd_depth2d(args):
    from ..models.depth2d import Depth2DComputer
    from ..utils import io

    params = _make_params(args)
    epis = _read_volume(args)
    t0 = time.perf_counter()
    computer = Depth2DComputer(
        epis, args.dmin, args.dmax, args.dim_d,
        epi_scale_factor=args.scale_factor, params=params,
        device=args.device)
    state = computer.run()
    arrays = _numpy(best_depth=state.best_depth,
                    disp_confidence=state.disp_conf,
                    edge_confidence=state.ce,
                    validity=computer.get_valid_depths_mask_s_v_u())
    print(f"depth2d in {time.perf_counter() - t0:.2f}s "
          f"({computer.passes_run} passes)")
    path = io.write_npz(args.out, "depth2d_results", **arrays)
    print(f"npz written to {path}")


def cmd_fine_to_coarse(args):
    from ..models.fine_to_coarse import FineToCoarse
    from ..utils import io

    params = _make_params(args)
    epis = _read_volume(args)
    t0 = time.perf_counter()
    ftc = FineToCoarse(epis, args.dmin, args.dmax, args.dim_d,
                       epi_scale_factor=args.scale_factor, params=params,
                       verbose=True, device=args.device)
    ftc.run()
    fused, validity = ftc.get_results()
    arrays = _numpy(fused=fused, validity=validity)
    print(f"fine-to-coarse in {time.perf_counter() - t0:.2f}s")
    path = io.write_npz(args.out, "fine_to_coarse_results", **arrays)
    print(f"npz written to {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="remotesensingproject_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("pile", cmd_pile), ("depth2d", cmd_depth2d),
                     ("fine-to-coarse", cmd_fine_to_coarse)):
        p = sub.add_parser(name)
        _add_io_args(p)
        _add_depth_args(p)
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
