"""The PCG32 draws' kernel wrappers: csrc/pcg_draw.cu on CUDA tensors.

core/rng.py routes its draws here on a CUDA tensor, after checking their
arguments; CPU tensors take its plain versions and never reach this
module.  `pcg_seed` (make_stream) and `pcg_draw` (next_uniform,
next_uniform2) allocate their outputs with ``torch.empty`` and make one
launch each, through the operators ``pathtracer_tpu_torch::pcg_seed_launch``
and ``pcg_draw_launch`` (ops/binding.py).  Every launch of the kernel
file, seed or draw, is counted on the one counter ``pcg_draw.launches``.
"""

from __future__ import annotations

import torch

from . import binding  # noqa: F401 (defines the operators)


def _halves(like, n):
    return tuple(torch.empty(like.shape, dtype=torch.int64,
                             device=like.device) for _ in range(n))


def pcg_seed(key_hi, key_lo):
    """make_stream's state tuple (s_hi, s_lo, inc_hi, inc_lo) of checked
    CUDA keys, in one launch."""
    out = _halves(key_hi, 4)
    if key_hi.numel():
        torch.ops.pathtracer_tpu_torch.pcg_seed_launch(key_hi, key_lo, *out,
                                                        key_hi.numel())
    return out


def pcg_draw(state, gate, k):
    """k (1 or 2) draws of every lane of a checked CUDA state in one
    launch: (u1, u2 or None, new state).  The new state shares the
    increment halves with `state`."""
    s_hi, s_lo, inc_hi, inc_lo = state
    n_hi, n_lo = _halves(s_hi, 2)
    u1 = torch.empty(s_hi.shape, dtype=torch.float32, device=s_hi.device)
    u2 = torch.empty_like(u1) if k == 2 else None
    if s_hi.numel():
        torch.ops.pathtracer_tpu_torch.pcg_draw_launch(
            s_hi, s_lo, inc_hi, inc_lo, gate, n_hi, n_lo, u1, u2,
            s_hi.numel())
    return u1, u2, (n_hi, n_lo, inc_hi, inc_lo)
