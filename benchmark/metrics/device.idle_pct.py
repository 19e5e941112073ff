"""device.idle_pct (device): the share of the traced scenes' wall in which
no operation ran on the card, 100 x (1 - the union of the device activity
intervals / the wall).  Its spans are the port's layer entry points; the
record's breakdown labels each idle gap by the innermost one open on the
host."""

_M = "remotesensingproject_tpu_torch.models"
SPANS = {
    "Depth2DComputer.run": f"{_M}.depth2d:Depth2DComputer.run",
    "depth2d._pass_fn": f"{_M}.depth2d:_pass_fn",
    "depth2d.sweep_pass": f"{_M}.depth2d:sweep_pass",
    "depth2d.sweep_pile_pixel": f"{_M}.depth2d:sweep_pile_pixel",
    "depth2d.selective_median_cuda": f"{_M}.depth2d:selective_median_cuda",
    "depth2d.propagate_cuda": f"{_M}.depth2d:propagate_cuda",
    "depth2d._line_confidence": f"{_M}.depth2d:_line_confidence",
    "depth2d.edge_confidence_volume": f"{_M}.depth2d:edge_confidence_volume",
    "FineToCoarse.get_results":
        f"{_M}.fine_to_coarse:FineToCoarse.get_results",
}


def read(trace, cell):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
