"""Component costs of one cluster-sweep subtile on the card.

    python -m pathtracer_tpu_torch.scripts.prof_sweep [--device cpu]
        [--reps 256]

Counterpart of scripts/tpu_prof_sweep.py.  Times, per (1024 x 256)
subtile, each kernel running `reps` iterations of one subtile so that the
launch amortizes (the time of a launch divided by reps):
  * the (1024, 8) x (8, 6*256) product in TF32 on the tensor cores (the
    counterpart of Precision.DEFAULT) and in fp32 on the CUDA cores, an
    FMA chain in k order per rep (Precision.HIGHEST); as the library's
    yardstick, the one torch.matmul
    that computes a launch's sum (scripts.matmul_same_us, microseconds per
    launch), TF32 off and on, and beside it torch.matmul of one product;
  * the epilogue alone (t / beta / gamma, acceptance, winner extraction);
  * the edge-matrix ray x triangle test.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import sweep_micro as sm
from . import (device_line, matmul_same_us, matmul_us, resolve_device,
               time_us)

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


# (triangle, rep, sign of t) of the two pairs that meet t = -0.0 and +0.0
# in a signed-zero ray, by ray % 4: in one rep (the lower triangle first),
# and in two reps (the earlier rep's triangle the higher one).  The
# epilogue's result is the first pair of each ray in (rep, tri) order.
SIGNED_ZERO_PAIRS = (((5, 1, -1), (9, 1, 1)), ((5, 1, 1), (9, 1, -1)),
                     ((200, 1, -1), (3, 2, 1)), ((200, 1, 1), (3, 2, -1)))


def signed_zero_inputs(dev, m: int, reps: int, eps: float = EPS,
                       seed: int = 3):
    """Epilogue inputs (p (m, 6*SUBT), tn (1, m)) with tn < 0, so that t =
    -0.0 and t = +0.0 are accepted, and ray r meets both at the pairs of
    SIGNED_ZERO_PAIRS[r % 4] (reps >= 3).  A pair's `on` is -step(rep), so
    in its rep on + step = +0.0 exactly and t = -(on / dn) takes the sign
    opposite to dn's; beta = gamma = 1/4.  The other values are random:
    their t, where accepted, is not 0."""
    steps = sm.rep_steps(max(reps, 3), eps, 'cpu').numpy()
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((m, 6, SUBT)).astype(np.float32)
    for r in range(m):
        for tri, rep, sign in SIGNED_ZERO_PAIRS[r % 4]:
            p[r, :, tri] = (-steps[rep], 0.25, 0.25, -sign, 0.0, 0.0)
    return (torch.as_tensor(p.reshape(m, NS), device=dev),
            torch.full((1, m), -1.0, device=dev))


def double_rounding_cases():
    """float32 triples (a, b, c), numpy, whose fp32 FMA the float64 sum
    rounded straight to float32 gets wrong: a = f32(1 + i 2^-23) 2^-12, b =
    f32(1 / (1 + i 2^-23)) 2^-12, c = 1 for the i < 200,000 where a * b =
    2^-24 (1 + t), 0 < t < 2^-29 (a = A 2^-35, b = B 2^-36, 0 < A B - 2^47
    < 2^18; 6,224 of them).  The exact sum lies just above the midpoint 1 +
    2^-24 and rounds up; its float64 sum is the midpoint and rounds to
    even, down."""
    i = np.arange(200_000)
    one = np.float32(1) + i.astype(np.float32) * np.float32(2.0 ** -23)
    a = one * np.float32(2.0 ** -12)
    b = (np.float32(1) / one) * np.float32(2.0 ** -12)
    ab = ((a.astype(np.float64) * 2.0 ** 35).astype(np.int64)
          * (b.astype(np.float64) * 2.0 ** 36).astype(np.int64) - 2 ** 47)
    keep = (ab > 0) & (ab < 2 ** 18)
    return a[keep], b[keep], np.ones(int(keep.sum()), np.float32)


def fma_cases(n_random: int = 4096, seed: int = 7):
    """float32 tensors (a, b, c) on the CPU that check an fp32 FMA: the
    double_rounding_cases, then n_random normal triples, as many with c
    cancelling the rounded a * b to a few ulps, as many with subnormal
    results, and last signed zeros and overflow to +-inf."""
    parts = [double_rounding_cases()]
    rng = np.random.default_rng(seed)

    def normal(scale=1.0):
        return (rng.standard_normal(n_random) * scale).astype(np.float32)

    a, b = normal(), normal()
    parts.append((a, b, normal()))
    parts.append((a, b, -(a * b) + (rng.integers(-4, 5, n_random)
                                     * np.spacing(a * b)).astype(np.float32)))
    parts.append((normal(2.0 ** -70), normal(2.0 ** -62),
                  normal(2.0 ** -133)))
    big, top = 2.0 ** 127, float(np.finfo(np.float32).max)
    parts.append(tuple(np.array(v, np.float32) for v in zip(
        (0.0, 3.0, 0.0), (-0.0, 3.0, 0.0), (-0.0, 3.0, -0.0),
        (0.0, -3.0, -0.0), (2.0, 3.0, -6.0), (big, 2.0, 0.0),
        (-big, 2.0, 0.0), (big, 3.0, -top), (top, 1.0, 2.0 ** 103),
        (top, 1.0, 2.0 ** 102))))
    return tuple(torch.as_tensor(np.concatenate(p)) for p in zip(*parts))


def fma_dot_inputs(a, b, c):
    """For a, b, c of 64 float32 values: (x (64, 8), w (8, 64)) whose fp32
    product over one rep at eps = -1 (a shift of -0.0, which leaves every
    r = x bit for bit) has out[j, j] = fma(a[j], b[j], c[j]) + 0.0 (acc
    starts at +0.0): x[j] = (c[j], a[j], 0, ...), w[0] = 1, w[1] = b,
    w[2:] = -0.0, so s = c[j], then the FMA, then six FMAs that add
    -0.0."""
    n = a.shape[0]
    x = torch.zeros((n, AR), device=a.device)
    x[:, 0], x[:, 1] = c, a
    w = torch.full((AR, n), -0.0, device=a.device)
    w[0], w[1] = 1.0, b
    return x, w


def run(dev, reps: int = REPS, log=print) -> dict:
    """Time every probe; returns microseconds per subtile by probe name
    ('tf32', 'fp32', 'epilogue', 'edgemat', and on a card
    'torch.matmul fp32' / 'torch.matmul tf32' per product and 'library
    fp32' / 'library tf32' per launch)."""
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
        log(f'{name}: {out[key]:.4f}us per subtile ({desc})')
    if dev.type == 'cuda':
        for tf32 in (False, True):
            route = 'tf32' if tf32 else 'fp32'
            key = f'torch.matmul {route}'
            out[key] = matmul_us(x['r'], x['a'], tf32, LAUNCHES * 10)
            log(f'{key} (allow_tf32={tf32}): {out[key]:.2f}us per product '
                f'({prod})')
            same = f'library {route}'
            out[same] = matmul_same_us(x['r'], x['a'], reps, EPS, tf32,
                                       LAUNCHES)
            log(f'{same}: {out[same]:.2f}us per launch, one torch.matmul '
                f'(1024x{8 * reps})x({8 * reps}x{NS}) computing the '
                f'{route} probe\'s sum over {reps} reps (library yardstick)')
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--reps', type=int, default=REPS)
    a = ap.parse_args(argv)
    return run(resolve_device(a.device), a.reps)


if __name__ == '__main__':
    main()
