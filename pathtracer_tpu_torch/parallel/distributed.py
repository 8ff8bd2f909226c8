"""Preemption-safe rendering for one process (counterpart of the
single-process parts of pathtracer_tpu/parallel/distributed.py):
`PreemptionGuard` and the per-process `checkpoint_path`.  The
multi-process bootstrap, meshes and row sharding are not ported yet
(ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import os
import signal


def checkpoint_path(base: str) -> str:
    """Per-process checkpoint filename: `base` itself in a single process,
    `<root>.p<rank><ext>` under an initialized torch.distributed group of
    more than one process, so processes sharing a filesystem do not
    collide."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return base
    root, ext = os.path.splitext(base)
    return f'{root}.p{dist.get_rank()}{ext}'


class PreemptionGuard:
    """Context manager that turns SIGTERM / SIGINT (or `signals`) into a
    request flag: the render loop finishes the wave in flight,
    checkpoints and returns (Renderer.render_resumable).  Earlier
    handlers are chained, so an outer supervisor still sees the signal,
    and restored on exit.  `requested` may also be set directly."""

    def __init__(self, signals=None):
        self.signals = tuple(signals) if signals is not None else (
            signal.SIGTERM, signal.SIGINT)
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False
