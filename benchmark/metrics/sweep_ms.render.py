"""Device ms per wave of the two cluster sweep kernels
(csrc/cluster_sweep.cu sweep_kernel<false|true, G>), matched by name."""


def read(trace):
    ns = trace.name_ns('sweep_kernel')
    if ns is None or not trace.units.get('waves'):
        return None
    return ns / 1e6 / trace.units['waves']
