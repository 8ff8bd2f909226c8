"""Percent of the traced waves' host-clock window in which no device
operation ran: 100 (1 - union of device intervals / window), from the
pass that traces the device alone."""


def read(trace):
    if not trace.units.get('waves') or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_ns() / trace.window_ns)
