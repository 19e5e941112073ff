"""sweep_rows.device_ms (row and tile sweeps): device milliseconds a scene
of the ``sweep_pc_kernel`` launches under the row rule ``PcRuleRow`` made
inside the span around ``depth2d.sweep_pile_rows`` (the uniform levels of
a scene whose C is not 1 or 3)."""

from benchmark import kernel_names

SPANS = {"depth2d.sweep_pile_rows":
         "remotesensingproject_tpu_torch.models.depth2d:sweep_pile_rows"}


def row_sweep(k) -> bool:
    return (kernel_names.sweep_rule(k.name) == "PcRuleRow"
            and "depth2d.sweep_pile_rows" in k.spans)


def read(trace, cell):
    s = trace.kernel_seconds(row_sweep)
    return 1e3 * s / trace.scenes if s > 0 else None
