"""Entry points of the port's probes, run as modules:

    python -m pathtracer_tpu_torch.scripts.prof_sweep    [--device cpu]
    python -m pathtracer_tpu_torch.scripts.proto_mxu     [--device cpu]
    python -m pathtracer_tpu_torch.scripts.ablate_sweep  [--device cpu]

Each runs hand-written CUDA kernels on the card and times them with CUDA
events; without a card it raises, unless the caller passes --device cpu,
which runs the plain PyTorch versions and prints host-clock times of the
CPU (never a device time).  The helpers below are shared by the three.
"""

from __future__ import annotations

import subprocess
import time

import torch

from ..ops import sweep_micro as sm


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: 'cuda' (the default) needs a card
    and raises without one; 'cpu' takes the plain versions."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('this probe runs its kernels on a CUDA card and '
                           'none is present; pass --device cpu to run the '
                           'plain PyTorch versions on the CPU')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'--device must be cuda or cpu, got {name}')
    return dev


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or a
    note that the run is on the CPU."""
    if dev.type == 'cpu':
        return ('device: cpu (plain PyTorch versions; times are host-clock '
                'times on the CPU, not device times)')
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True, timeout=60)
    return f'device: {out.stdout.strip().splitlines()[0]}'


def time_us(fn, launches: int, dev: torch.device) -> float:
    """Mean microseconds of one fn() call after two warm-up calls.

    On a card: CUDA events around `launches` calls that run back to back.
    A probe kernel can take less time than the Python wrapper takes to
    launch it, so chained launches would time the host; the card is
    first put to sleep (torch.cuda._sleep) for longer than the host
    needs to queue every launch, the start event is recorded behind the
    sleep, and the run is refused unless the sleep was still going when
    the last launch was queued.  On the CPU: the host clock."""
    fn()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    if dev.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        return (time.perf_counter() - t0) * 1e6 / launches
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = int(2e9 * max(1e-3, 4 * launches * host))   # ~2 GHz SM clock
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        queued = not start.query()
        stop.synchronize()
        if queued:
            return start.elapsed_time(stop) * 1e3 / launches
        cycles *= 4
    raise RuntimeError('the host could not queue the launches ahead of the '
                       'card; the timing would include host gaps')


def matmul_us(x, w, tf32: bool, launches: int) -> float:
    """Microseconds of one torch.matmul(x, w) on the card with TF32 allowed
    or not (the library yardstick; the port never calls it).  The global
    setting is restored afterwards."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return time_us(lambda: torch.matmul(x, w), launches, x.device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def concat_operands(x, w, reps: int, eps: float):
    """(X_cat (M, 8 * reps), W_cat (8 * reps, N)) whose one product is the
    probes' sum_{i < reps} (x + i*eps) @ w: block i of X_cat is x + i*eps,
    rounded as the kernels round it, and every block of W_cat is w."""
    steps = sm.rep_steps(reps, eps, x.device)
    x_cat = (x[:, None, :] + steps[None, :, None]).reshape(x.shape[0], -1)
    return x_cat, w.repeat(reps, 1)


def matmul_same_us(x, w, reps: int, eps: float, tf32: bool,
                   launches: int) -> float:
    """Microseconds of the one torch.matmul that computes what a product
    probe computes, X_cat @ W_cat of `concat_operands` (built once, outside
    the timed region): the library yardstick of a whole launch."""
    return matmul_us(*concat_operands(x, w, reps, eps), tf32, launches)
