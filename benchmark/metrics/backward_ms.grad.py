"""Device ms per step of the kernels launched inside the backward
(torch.autograd.grad, labelled by the harness): the per-sample recompute
and its backward, from the traced pass that records the host's ops."""


def read(trace):
    view = trace.labelled
    ns = view.label_ns('backward')
    if ns is None or not view.units.get('steps'):
        return None
    return ns / 1e6 / view.units['steps']
