"""Tensor cores against CUDA cores for the sweep's small-K ray x plane
product on the card.

    python -m pathtracer_tpu_torch.scripts.proto_mxu [--device cpu]
        [--reps 64]

Counterpart of scripts/tpu_proto_mxu.py (MXU `jnp.dot` against the
unrolled VPU form): out (1024, 768) = sum_{i < reps} (rays + i*1e-7) @
tris, once through TF32 wgmma on the tensor cores and once in fp32 on
the CUDA cores, an FMA chain in k order per rep.  The library's
yardstick, TF32 off and on, is the one torch.matmul that computes a
launch's sum (scripts.matmul_same_us), and beside it torch.matmul of one
product.  Prints microseconds per
product and the rate, then the largest difference between the two routes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import sweep_micro as sm
from . import (device_line, matmul_same_us, matmul_us, resolve_device,
               time_us)

BLOCK = 1024
SUBT = 256
NS = 3 * SUBT       # n / U' / V' planes side by side
REPS = 64
EPS = 1e-7
FLOPS = 2 * BLOCK * NS * 8
LAUNCHES = 50       # timed launches per route


def inputs(dev):
    rng = np.random.default_rng(0)
    rays = rng.standard_normal((BLOCK, 8)).astype(np.float32)
    tris = rng.standard_normal((8, NS)).astype(np.float32)
    return (torch.as_tensor(rays, device=dev),
            torch.as_tensor(tris, device=dev))


def run(dev, reps: int = REPS, log=print) -> dict:
    """Time both routes; returns microseconds per product by route
    ('tf32', 'fp32', and on a card 'torch.matmul fp32' / 'torch.matmul
    tf32'), microseconds per launch of the one-call yardstick ('library
    fp32' / 'library tf32'), and 'max diff' between the routes' outputs."""
    rays, tris = inputs(dev)
    log(device_line(dev))
    desc = f'(1024x8)x(8x{NS})'
    out, res = {}, {}
    for key, name, fn in (('tf32', 'tf32 wgmma (mxu jnp.dot)', sm.dot_tf32),
                          ('fp32', 'fp32 CUDA cores (vpu unrolled)',
                           sm.dot_fp32)):
        call = lambda fn=fn: fn(rays, tris, reps, EPS, NS)   # noqa: E731
        out[key] = time_us(call, LAUNCHES, dev) / reps
        res[key] = call()[0]
        rate = (f' -> {FLOPS / out[key] / 1e6:.2f} TFLOP/s'
                if dev.type == 'cuda' else '')
        log(f'{name}: {out[key]:.4f}us per {desc}{rate}')
    if dev.type == 'cuda':
        for tf32 in (False, True):
            route = 'tf32' if tf32 else 'fp32'
            key = f'torch.matmul {route}'
            out[key] = matmul_us(rays, tris, tf32, LAUNCHES * 10)
            log(f'{key} (allow_tf32={tf32}): {out[key]:.2f}us per {desc} -> '
                f'{FLOPS / out[key] / 1e6:.2f} TFLOP/s')
            same = f'library {route}'
            out[same] = matmul_same_us(rays, tris, reps, EPS, tf32, LAUNCHES)
            log(f'{same}: {out[same]:.2f}us per launch, one torch.matmul '
                f'(1024x{8 * reps})x({8 * reps}x{NS}) -> '
                f'{FLOPS * reps / out[same] / 1e6:.2f} TFLOP/s (library '
                f'yardstick)')
    out['max diff'] = float((res['tf32'] - res['fp32']).abs().max())
    log(f'max diff {out["max diff"]}')
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--reps', type=int, default=REPS)
    a = ap.parse_args(argv)
    return run(resolve_device(a.device), a.reps)


if __name__ == '__main__':
    main()
