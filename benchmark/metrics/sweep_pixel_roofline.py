"""sweep_pixel_roofline (pixel sweep): the least time of a scene's
pixel sweeps at the card's fp32 peak over their device time (the kernels
``sweep_pixel.device_ms`` reads), in %; bound by operations.  The
operations are the benchmark's own count (``counts.py``): each call's
valid samples, from its inputs, x the mean-shift steps x (4 C + 5),
counted in the untimed replay of one scene."""

import math

from benchmark import counts, kernel_names

TARGET = "remotesensingproject_tpu_torch.models.depth2d:sweep_pile_pixel"
SPANS = {"depth2d.sweep_pile_pixel": TARGET}


def _flops(args, cell):
    V, S, U, C = args["epis_v_s_u_c"].shape
    valid = counts.sweep_valid_samples(
        args["active_v_u"], S, int(args["s_hat"]), int(args["dim_d"]),
        args["dmin"], args["dmax"], U / cell.config["U"],
        cell.params["interpolation"], args.get("dmin_v_u"),
        args.get("dmax_v_u"))
    return counts.sweep_flops(valid, cell.steps, C)


COUNTERS = {"sweep_pixel.flops": (TARGET, _flops)}


def pixel_sweep(k) -> bool:
    rule = kernel_names.sweep_rule(k.name)
    return (rule is not None and rule != "PcRuleRow"
            and "depth2d.sweep_pile_pixel" in k.spans)


def read(trace, cell):
    flops = trace.counters.get("sweep_pixel.flops")
    s = trace.kernel_seconds(pixel_sweep)
    if not flops or not math.isfinite(flops) or s <= 0:
        return None
    return counts.roofline_pct(flops / counts.PEAK_FP32, s / trace.scenes)
