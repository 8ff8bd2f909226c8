"""The traced run: torch.profiler over a bounded run of waves or steps,
read from the raw Kineto events.  The run traces twice: the device alone
(busy and idle time, kernels; recording the host's ops would slow the
host, which sets these cells' pace, and inflate the idle share), then the
host's ops and the labels as well (device time inside a label, what the
host did in the idle gaps).

`annotated` is a frozen copy of chip_smoke.annotated cut to the layers
this benchmark reads: it labels the cluster cull (ops/cluster._cull)
with a record_function range while the trace runs.  `read_events` follows
chip_smoke.profile_split: building torch's FunctionEvent tree for a
wave's hundred thousand kernels takes minutes, so the events are read
raw; a kernel's linked correlation id names the runtime call that
launched it, whose start places the launch inside or outside a range.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools

LABELS = ('cull', 'backward')


@contextlib.contextmanager
def annotated():
    """Label the program's cluster cull with a 'cull' range, by wrapping
    the module function the scene queries call; restored on exit."""
    import torch
    from pathtracer_tpu_torch.ops import cluster as cl
    f = cl._cull

    @functools.wraps(f)
    def g(*a, **k):
        with torch.profiler.record_function('cull'):
            return f(*a, **k)

    cl._cull = g
    try:
        yield
    finally:
        cl._cull = f


@dataclasses.dataclass
class TraceView:
    """What the per-layer readers read: device events (start_ns, end_ns,
    name, launch correlation id), the host ranges of each label, the start
    of each launching call, the traced window on the host clock, and the
    units of work the window held (waves, samples, steps)."""

    device: list
    ranges: dict
    launch_start: dict
    window_ns: int
    units: dict
    host: dict
    host_ops: list          # (start_ns, end_ns, name) of the host's ops
    # the view of the second traced pass, which records the host's ops and
    # the harness's labels (None on that view itself)
    labelled: 'TraceView' = None

    def kernels(self):
        """Device events that are kernels (not copies or fills)."""
        return [e for e in self.device
                if not e[2].startswith(('Memcpy', 'Memset'))]

    def inside(self, label: str, t: int) -> bool:
        rs = self.ranges.get(label, [])
        i = bisect.bisect_right(rs, (t, float('inf'))) - 1
        return i >= 0 and rs[i][0] <= t <= rs[i][1]

    def label_ns(self, label: str):
        """Device time of the kernels launched inside `label`'s ranges, or
        None where the label never ran."""
        if not self.ranges.get(label) or not self.kernels():
            return None
        return sum(e[1] - e[0] for e in self.kernels()
                   if e[3] in self.launch_start
                   and self.inside(label, self.launch_start[e[3]]))

    def name_ns(self, part: str):
        """Device time of the kernels whose name holds `part`, or None."""
        ks = [e[1] - e[0] for e in self.kernels() if part in e[2]]
        return sum(ks) if ks else None

    def busy_ns(self) -> int:
        """Union of the device events' intervals."""
        busy, end = 0, None
        for s, e, _, _ in sorted(self.device):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def gaps(self):
        """Idle intervals between device events, longest first."""
        out, end = [], None
        for s, e, _, _ in sorted(self.device):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return sorted(out, key=lambda g: g[0] - g[1])

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps'
        time by the innermost host op running at each gap's midpoint
        ('python' where no op was), in seconds."""
        by_name = {}
        for s, e, name, _ in self.device:
            by_name[name] = by_name.get(name, 0) + (e - s)
        ops = sorted(self.host_ops)
        starts = [o[0] for o in ops]
        idle = {}
        for a, b in self.gaps()[:5000]:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = 'python'
            for j in range(i, max(i - 64, -1), -1):
                if ops[j][1] >= mid:
                    name = ops[j][2]
                    break
            idle[name] = idle.get(name, 0) + (b - a)

        def top_of(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {'device_ops': top_of(by_name), 'idle_gaps': top_of(idle)}


def read_events(prof, window_ns: int, units: dict, host: dict) -> TraceView:
    """A TraceView of a finished torch.profiler.profile."""
    import torch
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    ranges = {k: [] for k in LABELS}
    launch, device, host_ops = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name, kind = e.name(), e.device_type()
        if kind == cpu and e.linked_correlation_id() == 0:
            if name in ranges:
                ranges[name].append((e.start_ns(), e.end_ns()))
            else:
                launch[e.correlation_id()] = e.start_ns()
                if not name.startswith('cuda'):
                    host_ops.append((e.start_ns(), e.end_ns(), name))
        elif kind == cuda and name not in ranges:
            # a label's range also shows on the device's timeline as a
            # user annotation spanning its kernels: not an operation
            device.append((e.start_ns(), e.end_ns(), name,
                           e.linked_correlation_id()))
    for v in ranges.values():
        v.sort()
    return TraceView(device=device, ranges=ranges, launch_start=launch,
                     window_ns=window_ns, units=units, host=host,
                     host_ops=host_ops)
