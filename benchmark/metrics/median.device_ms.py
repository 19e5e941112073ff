"""median.device_ms (median): device milliseconds a scene of
``selective_median_kernel``."""

from benchmark import kernel_names


def median(k) -> bool:
    return kernel_names.base_name(k.name) == "selective_median_kernel"


def read(trace, cell):
    s = trace.kernel_seconds(median)
    return 1e3 * s / trace.scenes if s > 0 else None
