"""Device ms a step of the kernels launched inside the program's
`pt.query` spans (the cluster tier's closest-hit and shadow queries: the
cull, both sweeps and the rounds' glue), in the forward and in the remat
recompute, from the traced pass that records the host's ops.  A kernel
launched outside any torch operator is linked to no launch and is not
counted: before the sweeps ran as operators the reading held the cull
and the glue alone."""

from benchmark.harness import spans as sp


def read(trace):
    view = trace.labelled
    got = sp.labelled_pass(trace)
    if got is None or not view.units.get('steps') or not view.kernels():
        return None
    queries = sp.intervals(got, 'pt.query')
    if not queries:
        return None
    ns = sum(e[1] - e[0] for e in view.kernels()
             if e[3] in view.launch_start
             and sp.inside(queries, view.launch_start[e[3]]))
    return ns / 1e6 / view.units['steps']
