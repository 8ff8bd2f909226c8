"""PCG32 streams, the per-pixel rotation table and the rank-1 lattice.

A plain statement of the sampling the renderer documents: path (pixel p,
sample k) of a render with seed s owns the PCG XSH-RR 64/32 stream
pcg32(initstate=key, initseq=key) with key = (s << 32) | (p * nspp + k);
a uniform is the 32-bit output times float32(1 / (2^32 - 1)); a draw
that a lane does not make leaves its stream where it was.  The indirect
bounce takes the rank-1 lattice point of sample k, rotated by the
per-lane Cranley-Patterson shift: entry n of the table is draws 2n and
2n + 1 of pcg32(0) on its default stream.

The 64-bit state lives in int64 tensors; products wrap modulo 2^64 and
right shifts are made logical by masking.  `self_check` holds the tensor
streams to Python's integers on the device in use, so a platform whose
int64 arithmetic did not wrap would fail loudly instead of drawing other
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

MULT = 6364136223846793005
DEFAULT_INC = 1442695040888963407
MASK64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
INV_U32 = float(np.float32(1.0 / 4294967295.0))
LATTICE_GEN = (1, 182667)
LATTICE_OFF = (0.456789123, 0.123456789)


def _signed(x: int) -> int:
    """A 64-bit pattern as the int64 value that holds it."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def _lshr(x, k: int):
    """Logical right shift of an int64 tensor."""
    return (x >> k) & ((1 << (64 - k)) - 1)


class Streams:
    """One PCG32 stream per lane: (state, inc) int64 tensors."""

    def __init__(self, seed: int, ids):
        """ids: int64 tensor of p * nspp + k (below 2^32)."""
        key = ids | _signed((int(seed) & M32) << 32)
        self.inc = (key << 1) | 1
        self.state = self._bump(key + self.inc)

    def _bump(self, s):
        return s * MULT + self.inc

    def uniform(self, gate=None, dtype=torch.float32):
        """Next uniform per lane; lanes where `gate` is False keep their
        stream untouched (their value is drawn but unused)."""
        s = self.state
        xs = _lshr(_lshr(s, 18) ^ s, 27) & M32
        rot = _lshr(s, 59)
        out = (xs >> rot) | ((xs << ((32 - rot) & 31)) & M32)
        nxt = self._bump(s)
        self.state = nxt if gate is None else torch.where(gate, nxt, s)
        u = out.to(torch.float32) * INV_U32
        return u.to(dtype)


def _py_outputs(key: int, n: int):
    """The first n outputs of pcg32(key, key) with Python integers."""
    inc = ((key << 1) | 1) & MASK64
    s = ((key + inc) * MULT + inc) & MASK64
    out = []
    for _ in range(n):
        xs = (((s >> 18) ^ s) >> 27) & M32
        rot = s >> 59
        out.append(((xs >> rot) | (xs << ((32 - rot) & 31))) & M32)
        s = (s * MULT + inc) & MASK64
    return out


def self_check(device):
    """Raise unless the tensor streams equal Python's on `device`, for
    seeds with the top bit set and unset."""
    ids = torch.tensor([0, 1, 7, 123456789, M32], dtype=torch.int64,
                       device=device)
    for seed in (0, 1, 0x9E3779B9, M32):
        st = Streams(seed, ids)
        got = []
        for _ in range(3):
            s = st.state
            u = st.uniform()
            got.append((s, u))
        for lane, i in enumerate(ids.tolist()):
            want = _py_outputs(((seed & M32) << 32) | i, 3)
            for j, w in enumerate(want):
                u = float(np.float32(np.float32(w) * np.float32(INV_U32)))
                if float(got[j][1][lane]) != u:
                    raise AssertionError(
                        f'PCG32 on {device}: seed {seed} id {i} draw {j} '
                        f'gives {float(got[j][1][lane])}, Python {u}')


def _advance(state, delta):
    """pcg32's jump ahead on the default stream: the state `delta` steps
    after `state`, for a numpy uint64 array of deltas."""
    with np.errstate(over='ignore'):
        acc_m = np.ones_like(delta)
        acc_p = np.zeros_like(delta)
        cur_m, cur_p = np.uint64(MULT), np.uint64(DEFAULT_INC)
        d = delta.copy()
        for _ in range(64):
            bit = (d & np.uint64(1)) == 1
            acc_m = np.where(bit, acc_m * cur_m, acc_m)
            acc_p = np.where(bit, acc_p * cur_m + cur_p, acc_p)
            cur_p = (cur_m + np.uint64(1)) * cur_p
            cur_m = cur_m * cur_m
            d = d >> np.uint64(1)
        return acc_m * np.uint64(state) + acc_p


def cp_shifts(lanes) -> np.ndarray:
    """(len(lanes), 2) float32 rows of the per-lane rotation table."""
    lanes = np.asarray(lanes, np.uint64)
    s0 = ((0 + DEFAULT_INC) * MULT + DEFAULT_INC) & MASK64
    out = np.empty((len(lanes), 2), np.float32)
    for c in range(2):
        s = _advance(s0, lanes * np.uint64(2) + np.uint64(c))
        with np.errstate(over='ignore'):
            xs = (((s >> np.uint64(18)) ^ s) >> np.uint64(27)).astype(
                np.uint32)
            rot = (s >> np.uint64(59)).astype(np.uint32)
            o = (xs >> rot) | (xs << ((np.uint32(32) - rot) & np.uint32(31)))
        out[:, c] = o.astype(np.float32) * np.float32(INV_U32)
    return out


def lattice(k: int, device, dtype=torch.float32):
    """The (2,) lattice point of sample k: frac(bitreverse32(k) 2^-32 *
    gen + offset), in float32 as the renderer rounds it."""
    rev = int(f'{k & M32:032b}'[::-1], 2)
    phi = torch.tensor(rev, dtype=torch.int64, device=device).to(
        torch.float32) * 2.0 ** -32
    pt = torch.stack([torch.remainder(phi * g + o, 1.0)
                      for g, o in zip(LATTICE_GEN, LATTICE_OFF)])
    return pt.to(dtype)
