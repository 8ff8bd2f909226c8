"""Extensible rank-1 lattice + Cranley–Patterson rotation
(counterpart of pathtracer_tpu/core/qmc.py; bit-equal to it)."""

from __future__ import annotations

import numpy as np
import torch

_GEN_X = 1
_GEN_Y = 182667
_OFF_X = 0.456789123
_OFF_Y = 0.123456789


def reverse_bits_u32(n):
    """Bit-reverse uint32 values held in an int64 tensor."""
    n = ((n << 16) & 0xFFFFFFFF) | (n >> 16)
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def extensible_lattice_2d(sample_id):
    """phi = bitreverse(id) * 2^-32;  (x, y) = frac(phi * gen + offset).
    sample_id: int64 tensor.  Returns (..., 2) float32."""
    phi = reverse_bits_u32(sample_id).to(torch.float32) * 2.0 ** -32
    x = torch.remainder(phi * _GEN_X + _OFF_X, 1.0)
    y = torch.remainder(phi * _GEN_Y + _OFF_Y, 1.0)
    return torch.stack([x, y], dim=-1)


def extensible_lattice_2d_np(sample_id):
    """Host numpy twin of extensible_lattice_2d for scene prep and tests
    (pallas extensible_lattice_2d_np): (..., 2) float32."""
    n = np.asarray(sample_id, np.uint32)
    n = (n << np.uint32(16)) | (n >> np.uint32(16))
    n = (((n & np.uint32(0x00FF00FF)) << np.uint32(8))
         | ((n & np.uint32(0xFF00FF00)) >> np.uint32(8)))
    n = (((n & np.uint32(0x0F0F0F0F)) << np.uint32(4))
         | ((n & np.uint32(0xF0F0F0F0)) >> np.uint32(4)))
    n = (((n & np.uint32(0x33333333)) << np.uint32(2))
         | ((n & np.uint32(0xCCCCCCCC)) >> np.uint32(2)))
    n = (((n & np.uint32(0x55555555)) << np.uint32(1))
         | ((n & np.uint32(0xAAAAAAAA)) >> np.uint32(1)))
    phi = n.astype(np.float32) * np.float32(2.0 ** -32)
    x = np.mod(phi * _GEN_X + np.float32(_OFF_X), 1.0)
    y = np.mod(phi * _GEN_Y + np.float32(_OFF_Y), 1.0)
    return np.stack([x, y], axis=-1).astype(np.float32)


def cranley_patterson(lattice_pt, pixel_shift):
    """frac(lattice + per-pixel shift)."""
    return torch.remainder(lattice_pt + pixel_shift, 1.0)
