"""Multi-process execution: process bootstrap, global meshes, host-local
film rows, the collectives of the parallel layer and preemption-safe
rendering (counterpart of pathtracer_tpu/parallel/distributed.py).

One process drives one rank.  `init_multihost` wires the ranks together
with torch.distributed under a backend the caller names: `nccl` when
every rank has a card of its own, `gloo` for CPU runs and for several
processes that share one card (NCCL refuses two ranks on one device).
A single process needs no bootstrap: every helper then runs on the one
rank, and a collective over no group is the identity.

Gloo carries all_reduce, all_gather and broadcast of CUDA tensors, but
aborts the process on a point-to-point send of one (measured on the H100
machine, torch 2.11), so `ring_shift` stages its tensors through host
memory under gloo (`_host_staged`); no other collective is staged.

COLLECTIVE_LOG, when a list, receives (op, seconds on the host clock,
bytes in) for each collective: under gloo a collective of CUDA tensors
returns after its host copies, so its host time is its cost; under NCCL
it is the time to enqueue.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')
COLLECTIVE_LOG = None


@contextlib.contextmanager
def _logged(op, *tensors):
    """Time one collective into COLLECTIVE_LOG (off: None)."""
    if COLLECTIVE_LOG is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    COLLECTIVE_LOG.append((op, time.perf_counter() - t0, sum(
        x.numel() * x.element_size() for x in tensors)))


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    A single process (no address, at most one process) is a no-op that
    returns (0, 1).  Otherwise `backend` must be named ('nccl' or
    'gloo'; see the module docstring) and the coordinator is
    `host:port` (tcp://) or a full init URL (`file://...`).  A second
    call returns the group already joined."""
    if _initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and num_processes in (None, 1):
        return 0, 1
    if backend not in BACKENDS:
        raise ValueError(f'init_multihost needs an explicit backend, one of '
                         f'{BACKENDS}; got {backend!r}')
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError('init_multihost needs coordinator_address, '
                         'num_processes and process_id')
    url = (coordinator_address if '://' in coordinator_address
           else f'tcp://{coordinator_address}')
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not _initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(dp: Optional[int] = None, sp: int = 1):
    """A ('dp', 'sp') mesh over every rank of the default group (dp
    defaults to world // sp), for parallel/sharding.py's
    make_sharded_render and make_train_step."""
    from . import sharding
    n = world()[1]
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f'dp*sp={dp * sp} != ranks={n}'
    return sharding.make_mesh(dp=dp, sp=sp)


def host_shard_rows(height: int, mesh) -> tuple:
    """The [row0, row1) slab of the image this process keeps: the rows of
    its dp shard.  Returns (row0, row1, rows_per_shard); (0, 0, rows) for
    a process outside the mesh."""
    dp = mesh.shape['dp']
    assert height % dp == 0, f'height {height} not divisible by dp={dp}'
    rows = height // dp
    if mesh.coords is None:
        return 0, 0, rows
    i = mesh.coords['dp']
    return i * rows, (i + 1) * rows, rows


def assemble_rows(local_rows: torch.Tensor, mesh) -> torch.Tensor:
    """The whole image from each dp shard's own rows (host_shard_rows):
    an all_gather over the mesh's dp group, so every rank ends with the
    image and no rank sends more than its rows."""
    return torch.cat(list(group_gather(local_rows, mesh.groups.get('dp'))),
                     dim=0)


def group_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group` in place (identity for group None)."""
    if group is not None:
        with _logged('all_reduce', x):
            dist.all_reduce(x, group=group)
    return x


def group_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(D, *x.shape): `x` of every rank of `group`, in group rank order
    ((1, ...) for group None)."""
    if group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with _logged('all_gather', x):
        dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def group_closest(t: torch.Tensor, idx: torch.Tensor, group):
    """Per lane, (t, idx) of the rank of `group` with the least t; the
    first such rank on a tie, as jnp.argmin (all_gather + argmin)."""
    t_all = group_gather(t, group)
    j = torch.argmin(t_all, dim=0, keepdim=True)
    return t_all.gather(0, j)[0], group_gather(idx, group).gather(0, j)[0]


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the cotangent passes
    through unchanged, because every rank computes the same loss from
    the sum; the parameter gradients are summed over the group after
    backward (sharding.make_train_step).  torch.distributed.nn's
    all_reduce would all-reduce the cotangent as well and multiply every
    gradient by the group size."""

    @staticmethod
    def forward(ctx, x, group):
        return group_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over `group` (see _SumOverGroup)."""
    if group is None:
        return x
    return _SumOverGroup.apply(x, group)


def _host_staged(x: torch.Tensor, group) -> bool:
    """Gloo aborts on a point-to-point send of a CUDA tensor: stage those
    through host memory."""
    return x.is_cuda and dist.get_backend(group) == 'gloo'


def ring_shift(tensors, group):
    """Each rank of `group` sends `tensors` to the next rank in group
    order and receives the previous rank's (ppermute by +1)."""
    if group is None or dist.get_world_size(group) == 1:
        return list(tensors)
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    out, ops, staged = [], [], []
    for x in tensors:
        x = x.contiguous()
        host = _host_staged(x, group)
        src = x.cpu() if host else x
        buf = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)]
        out.append(buf)
        staged.append(host)
    with _logged('ring_shift', *tensors):
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return [b.to(x.device) if h else b
            for b, h, x in zip(out, staged, tensors)]


def checkpoint_path(base: str) -> str:
    """Per-process checkpoint filename: `base` itself in a single process,
    `<root>.p<rank><ext>` under an initialized torch.distributed group of
    more than one process, so processes sharing a filesystem do not
    collide."""
    rank, n = world()
    if n == 1:
        return base
    root, ext = os.path.splitext(base)
    return f'{root}.p{rank}{ext}'


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
