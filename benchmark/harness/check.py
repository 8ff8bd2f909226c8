"""The numbers that decide `correct`, each held to its limit in the cell's
file (benchmark/workloads/<cell>.json).

Frames: per checked pixel the largest relative gap of a channel between
the program's film and the reference's, |P - R| / max(|R|, 1% of the
mean |R|); `flipped_share` is the share of checked pixels whose gap passes
`tolerance`.  Float32 rounding keeps a path's radiance within about 1e-6;
a pixel passes the tolerance where one of its paths takes another branch
(a triangle edge, a shadow boundary, a Fresnel draw) or where the program
computes something else.

Gradient steps: `loss_gap`, the largest relative gap of a checked step's
loss, and `grad_gap`, the largest gap of a gradient entry as a share of
the largest |entry| of the reference's leaf, over the kd table and the
light intensity.
"""

from __future__ import annotations

import numpy as np


def frame_numbers(pairs, spec) -> dict:
    if not pairs:
        raise RuntimeError('the window finished no image to check')
    p = np.concatenate([a for a, _ in pairs])
    r = np.concatenate([b for _, b in pairs])
    scale = max(float(np.abs(r).mean()), 1e-30)
    gap = (np.abs(p - r) / np.maximum(np.abs(r), 1e-2 * scale)).max(axis=1)
    gap = np.where(np.isfinite(gap), gap, np.inf)
    lit = np.abs(r).max(axis=1) > 0
    return {'flipped_share': float((gap > spec['tolerance']).mean()),
            'pixels': int(len(gap)), 'lit_share': float(lit.mean()),
            'gap_p50': float(np.median(gap)),
            'gap_p99': float(np.quantile(gap, 0.99)),
            'gap_max': float(gap.max())}


def grad_numbers(pairs, spec) -> dict:
    if not pairs:
        raise RuntimeError('the window finished no step to check')
    loss_gap = grad_gap = 0.0
    for (lp, gp), (lr, gr) in pairs:
        loss_gap = max(loss_gap, abs(lp - lr) / max(abs(lr), 1e-30))
        for k, ref in gr.items():
            prog = np.asarray(gp[k], np.float64)
            den = max(float(np.abs(ref).max()), 1e-30)
            g = float(np.abs(prog - ref).max()) / den
            grad_gap = max(grad_gap, g if np.isfinite(g) else np.inf)
    return {'loss_gap': float(loss_gap), 'grad_gap': float(grad_gap),
            'steps': len(pairs)}


NUMBERS = {'frames': frame_numbers, 'grad_steps': grad_numbers}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {'value', 'limit'}}) over the limited numbers."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers[name]
        out[name] = {'value': v, 'limit': limit}
        ok = ok and bool(v <= limit)
    return ok, out
