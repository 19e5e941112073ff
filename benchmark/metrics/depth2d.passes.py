"""depth2d.passes (pass loop): the passes a scene runs, summed over the
pyramid's levels (the port's counter ``Depth2DComputer.passes_run`` of
each level's computer), averaged over the traced scenes."""


def read(trace, cell):
    return sum(trace.passes) / len(trace.passes) if trace.passes else None
