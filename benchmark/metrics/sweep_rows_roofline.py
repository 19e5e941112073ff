"""sweep_rows_roofline (row and tile sweeps): the least time of a scene's
row sweeps at the card's fp32 peak over their device time (the kernels
``sweep_rows.device_ms`` reads), in %; bound by operations.  The
operations are the benchmark's own count (``counts.py``): each call's
valid samples under the row rule (``counts.row_valid_samples``), from its
inputs, x the mean-shift steps, which the row sweep never caps, x
(4 C + 5), counted in the untimed replay of one scene."""

import math

from benchmark import counts, kernel_names

TARGET = "remotesensingproject_tpu_torch.models.depth2d:sweep_pile_rows"
SPANS = {"depth2d.sweep_pile_rows": TARGET}


def _flops(args, cell):
    V, S, U, C = args["epis_v_s_u_c"].shape
    valid = counts.row_valid_samples(
        args["active_v_u"], S, int(args["s_hat"]), int(args["dim_d"]),
        args["dmin"], args["dmax"], U / cell.config["U"])
    return counts.sweep_flops(valid, counts.MEAN_SHIFT_STEPS, C)


COUNTERS = {"sweep_rows.flops": (TARGET, _flops)}


def row_sweep(k) -> bool:
    return (kernel_names.sweep_rule(k.name) == "PcRuleRow"
            and "depth2d.sweep_pile_rows" in k.spans)


def read(trace, cell):
    flops = trace.counters.get("sweep_rows.flops")
    s = trace.kernel_seconds(row_sweep)
    if not flops or not math.isfinite(flops) or s <= 0:
        return None
    return counts.roofline_pct(flops / counts.PEAK_FP32, s / trace.scenes)
