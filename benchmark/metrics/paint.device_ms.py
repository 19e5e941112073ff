"""paint.device_ms (paint): device milliseconds a scene of
``paint_kernel``."""

from benchmark import kernel_names


def read(trace, cell):
    s = trace.kernel_seconds(
        lambda k: kernel_names.base_name(k.name) == "paint_kernel")
    return 1e3 * s / trace.scenes if s > 0 else None
