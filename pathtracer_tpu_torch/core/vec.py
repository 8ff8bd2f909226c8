"""float3 math on (..., 3) tensors (counterpart of pathtracer_tpu/core/vec.py).

Dot products are written out per component, (x + y) + z, so the summation
order is fixed on every device.
"""

from __future__ import annotations

import torch


def dot(a, b):
    """Batched 3-vector dot product -> (...,)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dot3(a, b):
    """Dot product keeping the trailing dim: (..., 1)."""
    return dot(a, b)[..., None]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def norm2(a):
    return dot(a, a)


def normalize(a, eps=1e-20):
    """Safe normalize with exact sqrt and divide (no rsqrt: its ~1e-4
    direction error flips visibility branches against the references)."""
    return a / torch.sqrt(torch.clamp_min(norm2(a), eps))[..., None]


def reflect(d, n):
    """r = d - 2*dot(d, n)*n, for d pointing toward the surface."""
    return d - 2.0 * dot3(d, n) * n


def get_tangent(n):
    """Branch-free axis-aligned tangent pick: zero the smallest-|component|
    axis and swap the other two with one negation, then normalize."""
    an = n.abs()
    ax, ay, az = an[..., 0], an[..., 1], an[..., 2]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    x_min = (ax <= ay) & (ax <= az)
    y_min = ~x_min & (ay <= ax) & (ay <= az)
    zero = torch.zeros_like(nx)
    tx = torch.where(x_min, zero, torch.where(y_min, -nz, -ny))
    ty = torch.where(x_min, -nz, torch.where(y_min, zero, nx))
    tz = torch.where(x_min, ny, torch.where(y_min, nx, zero))
    return normalize(torch.stack([tx, ty, tz], dim=-1))


def onb(n):
    """Orthonormal basis (t1, t2) around n: t1 = get_tangent(n),
    t2 = cross(t1, n) (the frame random_cos uses)."""
    t1 = get_tangent(n)
    return t1, cross(t1, n)
