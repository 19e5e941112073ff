"""sweep_pixel.device_ms (pixel sweep): device milliseconds a scene of the
``sweep_pc_kernel`` launches under a pixel rule (not ``PcRuleRow``)
made inside the span around ``depth2d.sweep_pile_pixel``: the tile sweep
launches the same symbol under the same rules."""

from benchmark import kernel_names

SPANS = {"depth2d.sweep_pile_pixel":
         "remotesensingproject_tpu_torch.models.depth2d:sweep_pile_pixel"}


def pixel_sweep(k) -> bool:
    rule = kernel_names.sweep_rule(k.name)
    return (rule is not None and rule != "PcRuleRow"
            and "depth2d.sweep_pile_pixel" in k.spans)


def read(trace, cell):
    s = trace.kernel_seconds(pixel_sweep)
    return 1e3 * s / trace.scenes if s > 0 else None
