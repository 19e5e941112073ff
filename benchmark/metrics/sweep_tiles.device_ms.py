"""sweep_tiles.device_ms (row and tile sweeps): device milliseconds a
scene of the ``sweep_pc_kernel`` launches under a pixel rule (not
``PcRuleRow``) made inside the span around ``depth2d.sweep_pile_tiles``
(the bounds-edited levels of a scene whose C is not 1 or 3): the pixel
sweep launches the same symbol under the same rules."""

from benchmark import kernel_names

SPANS = {"depth2d.sweep_pile_tiles":
         "remotesensingproject_tpu_torch.models.depth2d:sweep_pile_tiles"}


def tile_sweep(k) -> bool:
    rule = kernel_names.sweep_rule(k.name)
    return (rule is not None and rule != "PcRuleRow"
            and "depth2d.sweep_pile_tiles" in k.spans)


def read(trace, cell):
    s = trace.kernel_seconds(tile_sweep)
    return 1e3 * s / trace.scenes if s > 0 else None
