"""Pure-Python/NumPy PCG32 twin of core/rng.py — host-side tables & tests.

Implements the exact pcg_random.hpp setseq_xsh_rr_64_32 semantics
(reference: pcg_random.hpp:378-499, :845-871) with Python integers, used to

  * generate the per-pixel Cranley–Patterson shift table the same way the
    reference fills randomPerPixel from engine[0] (Raytracer.cpp:1340-1344),
  * provide the ground truth the JAX uint32-pair implementation is
    bit-checked against in tests.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1
MULT = 6364136223846793005
DEFAULT_INC = 1442695040888963407  # PCG_DEFAULT_INCREMENT_64
INV_UINT32_MAX = np.float32(1.0 / 4294967295.0)


class PCG32:
    """pcg32 engine. Constructor semantics match pcg_random.hpp:

    - PCG32(seed): default stream (inc = PCG_DEFAULT_INCREMENT_64),
      state = bump(seed + inc)                      (pcg_random.hpp:484-487)
    - PCG32(seed, seq): inc = (seq << 1) | 1,
      state = bump(seed + inc)                      (pcg_random.hpp:495-499)
    """

    def __init__(self, seed: int, seq: int | None = None):
        seed = int(seed)
        if seq is None:
            self.inc = DEFAULT_INC
        else:
            self.inc = ((int(seq) << 1) | 1) & MASK64
        self.state = self._bump((seed + self.inc) & MASK64)

    def _bump(self, s: int) -> int:
        return (s * MULT + self.inc) & MASK64

    def next_u32(self) -> int:
        s = self.state
        self.state = self._bump(s)
        xorshifted = (((s >> 18) ^ s) >> 27) & MASK32
        rot = s >> 59
        return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32

    def next_float(self) -> np.float32:
        """u32 * (1/(2^32-1)), the reference's invmax convention."""
        return np.float32(np.float32(self.next_u32()) * INV_UINT32_MAX)


def random_per_pixel(width: int, height: int) -> np.ndarray:
    """The reference's per-pixel CP-rotation table (Raytracer.cpp:1340-1344):
    sequential draws from engine[0] = pcg32(0), two per pixel, row-major."""
    eng = PCG32(0)
    out = np.empty((height * width, 2), np.float32)
    for i in range(height * width):
        out[i, 0] = eng.next_float()
        out[i, 1] = eng.next_float()
    return out


def random_per_pixel_fast(width: int, height: int) -> np.ndarray:
    """Vectorized random_per_pixel (bit-identical, numpy uint64)."""
    n = height * width * 2
    inc = np.uint64(DEFAULT_INC)
    mult = np.uint64(MULT)
    # iterative state fill: state_k = state_0 * mult^k + inc*(mult^{k-1}+...+1)
    # computed by cumulative scan in log-free chunks; n is at most ~4M so a
    # simple python loop over a vectorized block recurrence is fine.
    states = np.empty(n, np.uint64)
    eng = PCG32(0)
    s = np.uint64(eng.state)
    BLOCK = 65536
    # precompute mult^BLOCK and inc geometric sum for block jumps
    with np.errstate(over='ignore'):
        # per-element within a block: sequential; across blocks: jump
        block_states = np.empty(BLOCK, np.uint64)
        idx = 0
        while idx < n:
            m = min(BLOCK, n - idx)
            cur = s
            for k in range(m):
                block_states[k] = cur
                cur = cur * mult + inc
            states[idx:idx + m] = block_states[:m]
            s = cur
            idx += m
    # XSH-RR output, vectorized
    with np.errstate(over='ignore'):
        xorshifted = (((states >> np.uint64(18)) ^ states) >> np.uint64(27)).astype(np.uint32)
        rot = (states >> np.uint64(59)).astype(np.uint32)
        out = (xorshifted >> rot) | (xorshifted << ((np.uint32(32) - rot) & np.uint32(31)))
    vals = out.astype(np.float32) * INV_UINT32_MAX
    return vals.reshape(height * width, 2)
