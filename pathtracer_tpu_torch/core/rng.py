"""Counter-keyed PCG32 streams, bit-exact with pathtracer_tpu/core/rng.py.

Every path (pixel, sample) owns a PCG XSH-RR 64/32 stream seeded as
``pcg32(initstate=key, initseq=key)``.  The 64-bit state and increment are
carried as (hi, lo) halves, each a uint32 value held in an int64 tensor:
torch's uint32 support is partial, and int64 holds every intermediate of
the 16-bit-limb products below without overflow.  Logical shifts are
arithmetic shifts of non-negative values, and every left shift is masked
back to 32 bits.

State is the tuple ``(s_hi, s_lo, inc_hi, inc_lo)``.  Uniforms follow the
reference convention ``u = out * (1/(2^32-1))`` in float32.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_MULT = 6364136223846793005
_MULT_HI = _MULT >> 32
_MULT_LO = _MULT & M32

INV_UINT32_MAX = float(np.float32(1.0 / 4294967295.0))


def _mulhi32(a, b):
    """High 32 bits of the 32x32->64 unsigned product, via 16-bit limbs."""
    a_lo, a_hi = a & _M16, a >> 16
    b_lo, b_hi = b & _M16, b >> 16
    t = a_lo * b_lo
    mid1 = a_hi * b_lo + (t >> 16)
    mid2 = a_lo * b_hi + (mid1 & _M16)
    return a_hi * b_hi + (mid1 >> 16) + (mid2 >> 16)


def _mullo32(a, b):
    """Low 32 bits of the product, without any int64 overflow."""
    a_lo, a_hi = a & _M16, a >> 16
    b_lo, b_hi = b & _M16, b >> 16
    cross = (a_hi * b_lo + a_lo * b_hi) & _M16
    return (a_lo * b_lo + (cross << 16)) & M32


def _add64(a_hi, a_lo, b_hi, b_lo):
    """(a + b) mod 2^64 on 32-bit halves."""
    lo = a_lo + b_lo
    hi = (a_hi + b_hi + (lo >> 32)) & M32
    return hi, lo & M32


def _mul64(a_hi, a_lo, b_hi, b_lo):
    """(a * b) mod 2^64 on 32-bit halves."""
    lo = _mullo32(a_lo, b_lo)
    hi = (_mulhi32(a_lo, b_lo) + _mullo32(a_lo, b_hi)
          + _mullo32(a_hi, b_lo)) & M32
    return hi, lo


def pcg32_bump(s_hi, s_lo, inc_hi, inc_lo):
    """state * MULT + inc."""
    hi, lo = _mul64(s_hi, s_lo, _MULT_HI, _MULT_LO)
    return _add64(hi, lo, inc_hi, inc_lo)


def _xsh_rr(s_hi, s_lo):
    """rotr32(((state ^ (state >> 18)) >> 27) mod 2^32, state >> 59)."""
    s18_hi = s_hi >> 18
    s18_lo = ((s_hi << 14) & M32) | (s_lo >> 18)
    x_hi = s18_hi ^ s_hi
    x_lo = s18_lo ^ s_lo
    xs = ((x_hi << 5) & M32) | (x_lo >> 27)
    rot = s_hi >> 27
    return (xs >> rot) | ((xs << ((32 - rot) & 31)) & M32)


def make_stream(key_hi, key_lo):
    """Seed per-lane streams pcg32(initstate=key, initseq=key):
    inc = (key << 1) | 1;  state = bump(key + inc).

    key_hi, key_lo: int64 tensors holding uint32 values (broadcastable)."""
    key_hi, key_lo = torch.broadcast_tensors(key_hi, key_lo)
    inc_hi = ((key_hi << 1) & M32) | (key_lo >> 31)
    inc_lo = ((key_lo << 1) & M32) | 1
    s_hi, s_lo = _add64(key_hi, key_lo, inc_hi, inc_lo)
    s_hi, s_lo = pcg32_bump(s_hi, s_lo, inc_hi, inc_lo)
    return s_hi, s_lo, inc_hi, inc_lo


def next_uint32(state):
    """Draw one uint32 (as int64) per lane: output of the current state,
    then advance.  Returns (out, new_state)."""
    s_hi, s_lo, inc_hi, inc_lo = state
    out = _xsh_rr(s_hi, s_lo)
    n_hi, n_lo = pcg32_bump(s_hi, s_lo, inc_hi, inc_lo)
    return out, (n_hi, n_lo, inc_hi, inc_lo)


def next_uniform(state, gate=None):
    """One float32 uniform in [0,1] per lane.  Lanes where `gate` is False
    do not consume the draw: their state is left untouched (data-dependent
    draw counts, as in the JAX package)."""
    out, new_state = next_uint32(state)
    if gate is not None:
        new_state = (torch.where(gate, new_state[0], state[0]),
                     torch.where(gate, new_state[1], state[1]),
                     state[2], state[3])
    return out.to(torch.float32) * INV_UINT32_MAX, new_state


def next_uniform2(state, gate=None):
    """Two sequential uniforms per lane."""
    u1, state = next_uniform(state, gate)
    u2, state = next_uniform(state, gate)
    return u1, u2, state
