"""torch_ops.device_ms (PyTorch's own kernels): device milliseconds a
scene of every kernel that is not one of the port's (``sweep_pc_kernel``,
``selective_median_kernel``, ``paint_kernel``): edge confidence,
normalisation, the pyramid, the merges and line confidence."""

from benchmark import kernel_names


def read(trace, cell):
    if not trace.kernels:
        return None
    s = trace.kernel_seconds(lambda k: not kernel_names.is_port_kernel(k.name))
    return 1e3 * s / trace.scenes
