"""Device kernels launched per sample pass over every pixel (one spp of
the image), counted in the trace."""


def read(trace):
    n = len(trace.kernels())
    if not n or not trace.units.get('waves'):
        return None
    return n / trace.units['samples']
