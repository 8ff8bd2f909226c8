"""Percent of the remat recompute's device time that re-queries the mesh:
of the kernels launched inside the program's `pt.sample` spans that the
backward runs (`recompute` true), the device time of those whose launch
also lies inside a `pt.query` span, from the traced pass that records
the host's ops."""

from benchmark.harness import spans as sp


def read(trace):
    view = trace.labelled
    got = sp.labelled_pass(trace)
    if got is None or not view.kernels():
        return None
    rec = sp.intervals(got, 'pt.sample', recompute=True)
    queries = sp.intervals(got, 'pt.query')
    if not rec or not queries:
        return None
    total = queried = 0
    for e in view.kernels():
        t = view.launch_start.get(e[3])
        if t is not None and sp.inside(rec, t):
            total += e[1] - e[0]
            if sp.inside(queries, t):
                queried += e[1] - e[0]
    if not total:
        return None
    return 100.0 * queried / total
