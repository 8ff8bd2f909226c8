"""Directional sampling from explicit uniforms
(counterpart of pathtracer_tpu/core/sampling.py)."""

from __future__ import annotations

import torch

from . import vec

TWO_PI = 6.283185307179586


def random_cos(n, r1, r2):
    """Cosine-weighted hemisphere direction around n in the
    (get_tangent(n), cross(t1, n), n) frame."""
    sr2 = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    lx = torch.cos(TWO_PI * r1) * sr2
    ly = torch.sin(TWO_PI * r1) * sr2
    lz = torch.sqrt(torch.clamp_min(r2, 0.0))
    t1, t2 = vec.onb(n)
    return lz[..., None] * n + lx[..., None] * t1 + ly[..., None] * t2


def random_phong(r_dir, phong_exponent, r1, r2):
    """Phong-lobe direction around the mirror direction r_dir."""
    e = phong_exponent
    z = torch.pow(torch.clamp_min(r2, 1e-38), 1.0 / (e + 1.0))
    fac = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    lx = torch.cos(TWO_PI * r1) * fac
    ly = torch.sin(TWO_PI * r1) * fac
    t1, t2 = vec.onb(r_dir)
    return z[..., None] * r_dir + lx[..., None] * t1 + ly[..., None] * t2


def random_uniform_sphere(r1, r2):
    """Uniform direction on the unit sphere (reference: Vector.h:604-615)."""
    s = torch.sqrt(torch.clamp_min(r2 * (1.0 - r2), 0.0))
    return torch.stack([2.0 * torch.cos(TWO_PI * r1) * s,
                        2.0 * torch.sin(TWO_PI * r1) * s,
                        1.0 - 2.0 * r2], dim=-1)


def random_uniform_hemisphere(n, r1, r2):
    """Uniform hemisphere direction around n (reference: Vector.h:617-630)."""
    s = torch.sqrt(torch.clamp_min(1.0 - r2 * r2, 0.0))
    lx = torch.cos(TWO_PI * r1) * s
    ly = torch.sin(TWO_PI * r1) * s
    t1, t2 = vec.onb(n)
    return r2[..., None] * n + lx[..., None] * t1 + ly[..., None] * t2


def box_muller(r1, r2):
    """2D Gaussian with the radius in the third lane (reference:
    Vector.h:646-655)."""
    s1 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(r1, 1e-38)))
    s2 = TWO_PI * r2
    return torch.stack([s1 * torch.cos(s2), s1 * torch.sin(s2), s1], dim=-1)
