"""Timers and traces (counterpart of pathtracer_tpu/utils/profiling.py).

The reference's PerfChrono wall-clock timer and its time-per-ray display
(chrono.h:6-64, Raytracer.cpp:1446+1533+1696) become a block timer that
times the card by CUDA events (the host clock on the CPU), a rays/s
accounting helper, and a torch.profiler context that writes a Chrome
trace.  The JAX module's `device_sync` is a workaround for a remote TPU
runtime and has no counterpart: a CUDA event or torch.cuda.synchronize
is a true barrier.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class PerfChrono:
    """Wall timer of device work: on a CUDA device `diff_ms` is the time
    between two CUDA events (start() records the first), elsewhere the
    host clock."""

    def __init__(self, device=None):
        dev = torch.device('cpu') if device is None else torch.device(device)
        self.cuda = dev.type == 'cuda'
        self.start()

    def start(self):
        if self.cuda:
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record()
        else:
            self._t0 = time.perf_counter()

    def diff_ms(self) -> float:
        """Milliseconds since start(), after the device finishes the work
        queued so far."""
        if self.cuda:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            stop.synchronize()
            return self._ev.elapsed_time(stop)
        return (time.perf_counter() - self._t0) * 1000.0


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = True):
    """torch.profiler over the block (CPU ops, and CUDA kernels when
    `cuda`); writes `<log_dir>/trace.json` (Chrome / Perfetto) on exit
    and yields the profiler, whose key_averages() sum the ops and
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def rays_per_second(width, height, spp, nb_bounces, seconds,
                    shadow_rays_per_bounce=1):
    """Hardware ray-op accounting for the lockstep wavefront: every lane
    does one closest-hit and `shadow_rays_per_bounce` any-hit sweeps per
    bounce (no compaction), so ray ops = W*H*spp*bounces*(1+shadow)."""
    total = width * height * spp * nb_bounces * (1 + shadow_rays_per_bounce)
    return total / max(seconds, 1e-12)
