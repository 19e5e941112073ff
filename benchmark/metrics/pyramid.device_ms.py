"""pyramid.device_ms (pyramid): device milliseconds a scene of the
kernels launched under the benchmark's spans around the pyramid's own
dense operations (``ops/pyramid.py``, called by ``FineToCoarse``): each
level's downsampling, each coarser level's bounds from its parent, and
the fusion of every level at full resolution.

Every scene runs the three, so the metric reads in every cell.  Its spans
wrap the names ``models/fine_to_coarse.py`` calls them by; the layer
entry points that label the breakdown's idle gaps come from
``device.idle_pct``'s spans, which every cell that reports
``mpix_per_s`` traces."""

_FTC = "remotesensingproject_tpu_torch.models.fine_to_coarse"
SPANS = {
    "pyramid.downsample_epis": f"{_FTC}:downsample_epis",
    "pyramid.bounds_from_parent": f"{_FTC}:bounds_from_parent",
    "pyramid.fuse_disp_maps": f"{_FTC}:fuse_disp_maps",
}


def pyramid(k) -> bool:
    return any(s in SPANS for s in k.spans)


def read(trace, cell):
    s = trace.kernel_seconds(pyramid)
    return 1e3 * s / trace.scenes if s > 0 else None
