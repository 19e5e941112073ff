"""sweep_tiles_roofline (row and tile sweeps): the least time of a
scene's tile sweeps at the card's fp32 peak over their device time (the
kernels ``sweep_tiles.device_ms`` reads), in %; bound by operations.  The
operations are the benchmark's own count (``counts.py``): each call's
valid samples of the candidates it may run, from its inputs (in tile mode
the tile grid ``dmin_v_u`` / ``dmax_v_u`` and each pixel's allowed range
``pdmin_v_u`` / ``pdmax_v_u``: a masked candidate counts nothing, so it
shows as lost roofline), x the mean-shift steps, which the tile sweep
never caps, x (4 C + 5), counted in the untimed replay of one scene."""

import math

from benchmark import counts, kernel_names

TARGET = "remotesensingproject_tpu_torch.models.depth2d:sweep_pile_tiles"
SPANS = {"depth2d.sweep_pile_tiles": TARGET}


def _flops(args, cell):
    V, S, U, C = args["epis_v_s_u_c"].shape
    valid = counts.sweep_valid_samples(
        args["active_v_u"], S, int(args["s_hat"]), int(args["dim_d"]),
        cell.config["dmin"], cell.config["dmax"], U / cell.config["U"],
        cell.params["interpolation"], args["dmin_v_u"], args["dmax_v_u"],
        pdmin_v_u=args.get("pdmin_v_u"), pdmax_v_u=args.get("pdmax_v_u"))
    return counts.sweep_flops(valid, counts.MEAN_SHIFT_STEPS, C)


COUNTERS = {"sweep_tiles.flops": (TARGET, _flops)}


def tile_sweep(k) -> bool:
    rule = kernel_names.sweep_rule(k.name)
    return (rule is not None and rule != "PcRuleRow"
            and "depth2d.sweep_pile_tiles" in k.spans)


def read(trace, cell):
    flops = trace.counters.get("sweep_tiles.flops")
    s = trace.kernel_seconds(tile_sweep)
    if not flops or not math.isfinite(flops) or s <= 0:
        return None
    return counts.roofline_pct(flops / counts.PEAK_FP32, s / trace.scenes)
