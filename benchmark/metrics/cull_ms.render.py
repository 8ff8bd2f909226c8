"""Device ms per wave of the kernels launched inside the cluster cull
(ops/cluster._cull, labelled by the harness), from the traced pass that
records the host's ops."""


def read(trace):
    view = trace.labelled
    ns = view.label_ns('cull')
    if ns is None or not view.units.get('waves'):
        return None
    return ns / 1e6 / view.units['waves']
