"""median_roofline (median): the least time of a scene's selective
medians at the card's HBM bandwidth over their device time, in %; bound
by bytes, each call's computed from its shapes (``counts.median_bytes``),
counted in the untimed replay of one scene."""

import math

from benchmark import counts, kernel_names

TARGET = "remotesensingproject_tpu_torch.models.depth2d:selective_median_cuda"


def _bytes(args, cell):
    V, U, C = args["frame_v_u_c"].shape
    return counts.median_bytes(V, U, C)


COUNTERS = {"median.bytes": (TARGET, _bytes)}


def read(trace, cell):
    nbytes = trace.counters.get("median.bytes")
    s = trace.kernel_seconds(
        lambda k: kernel_names.base_name(k.name) == "selective_median_kernel")
    if not nbytes or not math.isfinite(nbytes) or s <= 0:
        return None
    return counts.roofline_pct(nbytes / counts.PEAK_BYTES, s / trace.scenes)
