"""Component costs of one cluster-sweep subtile on the card.

    python -m pathtracer_tpu_torch.scripts.prof_sweep [--device cpu]
        [--reps 256]

Counterpart of scripts/tpu_prof_sweep.py.  Times, per (1024 x 256)
subtile, each kernel running `reps` iterations of one subtile so that the
launch amortizes (the time of a launch divided by reps):
  * the (1024, 8) x (8, 6*256) product in TF32 on the tensor cores (the
    counterpart of Precision.DEFAULT) and in strict fp32 on the CUDA cores
    (Precision.HIGHEST), and torch.matmul of one such product with TF32
    off and on, as the library's yardstick;
  * the epilogue alone (t / beta / gamma, acceptance, winner extraction);
  * the edge-matrix ray x triangle test.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import sweep_micro as sm
from . import device_line, matmul_us, resolve_device, time_us

BLOCK, SUBT, AR = 1024, 256, 8
NS = 6 * SUBT
REPS = 256
EPS = 1e-9
OUT_COLS = 128      # the TPU kernel keeps prod[:, :128]
LAUNCHES = 20       # timed launches per probe


def inputs(dev) -> dict:
    """The script's inputs, drawn in the order of tpu_prof_sweep.py."""
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    r, a = t((BLOCK, AR)), t((AR, NS))
    p = t((BLOCK, NS))
    tn = torch.zeros((1, BLOCK), device=dev)
    ov, dv, tr = t((3, BLOCK)), t((3, BLOCK)), t((12, SUBT))
    return dict(r=r, a=a, p=p, tn=tn, ov=ov, dv=dv, tr=tr)


def run(dev, reps: int = REPS, log=print) -> dict:
    """Time every probe; returns microseconds per subtile by probe name
    ('tf32', 'fp32', 'epilogue', 'edgemat', and on a card
    'torch.matmul fp32' / 'torch.matmul tf32' per product)."""
    x = inputs(dev)
    log(device_line(dev))
    prod = f'(1024x8)x(8x{NS})'
    pair = f'{SUBT} tris x {BLOCK} rays'
    probes = (
        ('tf32', 'matmul tf32 (Precision.DEFAULT)', prod,
         lambda: sm.dot_tf32(x['r'], x['a'], reps, EPS, OUT_COLS)),
        ('fp32', 'matmul fp32 (Precision.HIGHEST)', prod,
         lambda: sm.dot_fp32(x['r'], x['a'], reps, EPS, OUT_COLS)),
        ('epilogue', 'epilogue', pair,
         lambda: sm.epilogue(x['p'], x['tn'], reps, EPS)),
        ('edgemat', 'edge-matrix CUDA cores', pair,
         lambda: sm.edgemat(x['ov'], x['dv'], x['tr'], reps, EPS)))
    out = {}
    for key, name, desc, fn in probes:
        out[key] = time_us(fn, LAUNCHES, dev) / reps
        log(f'{name}: {out[key]:.2f}us per subtile ({desc})')
    if dev.type == 'cuda':
        for tf32 in (False, True):
            key = f'torch.matmul {"tf32" if tf32 else "fp32"}'
            out[key] = matmul_us(x['r'], x['a'], tf32, LAUNCHES * 10)
            log(f'{key} (allow_tf32={tf32}): {out[key]:.2f}us per product '
                f'({prod}, library yardstick)')
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--reps', type=int, default=REPS)
    a = ap.parse_args(argv)
    return run(resolve_device(a.device), a.reps)


if __name__ == '__main__':
    main()
