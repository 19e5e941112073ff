"""CLI: ``python -m remotesensingproject_tpu_torch.cli.main fine-to-coarse``.

Counterpart of the ``fine-to-coarse`` command of
``remotesensingproject_tpu/cli/main.py``: read a folder of frames, run the
pyramid, write ``fine_to_coarse_results.npz`` (fused maps and validity).
Runs on CUDA unless ``--device`` names another device.  The coloured
PNGs and the other commands are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys
import time


def cmd_fine_to_coarse(args):
    from ..models.fine_to_coarse import FineToCoarse
    from ..utils import io

    t0 = time.perf_counter()
    imgs = io.read_imgs_from_folder(args.folder, args.ext,
                                    transpose=args.transpose,
                                    rotate_180=args.rotate180)
    print(f"read {imgs.shape[0]} frames {imgs.shape[1]}x{imgs.shape[2]} "
          f"in {time.perf_counter() - t0:.2f}s")
    epis = io.build_epis_from_imgs(imgs)
    t0 = time.perf_counter()
    ftc = FineToCoarse(epis, args.dmin, args.dmax, args.dim_d,
                       epi_scale_factor=args.scale_factor, verbose=True,
                       device=args.device)
    ftc.run()
    fused, validity = ftc.get_results()
    fused, validity = fused.cpu().numpy(), validity.cpu().numpy()
    print(f"fine-to-coarse in {time.perf_counter() - t0:.2f}s")
    path = io.write_npz(args.out, "fine_to_coarse_results", fused=fused,
                        validity=validity)
    print(f"npz written to {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="remotesensingproject_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("fine-to-coarse")
    p.add_argument("folder", help="folder of frames")
    p.add_argument("--ext", default="tif")
    p.add_argument("--transpose", action="store_true")
    p.add_argument("--rotate180", action="store_true")
    p.add_argument("--out", default="output")
    p.add_argument("--dmin", type=float, default=-1.0)
    p.add_argument("--dmax", type=float, default=4.0)
    p.add_argument("--dim-d", type=int, default=120)
    p.add_argument("--scale-factor", type=float, default=-1.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, required)")
    p.set_defaults(fn=cmd_fine_to_coarse)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
