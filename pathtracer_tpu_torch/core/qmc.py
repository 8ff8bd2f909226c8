"""Extensible rank-1 lattice + Cranley–Patterson rotation
(counterpart of pathtracer_tpu/core/qmc.py; bit-equal to it)."""

from __future__ import annotations

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


def cranley_patterson(lattice_pt, pixel_shift):
    """frac(lattice + per-pixel shift)."""
    return torch.remainder(lattice_pt + pixel_shift, 1.0)
