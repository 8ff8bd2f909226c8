"""Phong / Lambert BRDFs (counterpart of pathtracer_tpu/models/brdf.py).

Measured BRDFs (MERL, Titopo) live in models/merl.py; the integrator
evaluates them in place of Phong per table (render/integrator._eval_brdf).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import sampling, vec

M_PI = float(np.float32(np.pi))
M_TWO_PI = float(np.float32(2.0 * np.pi))


def phong_eval(kd, ks, ne, wi, wo, n):
    """kd/pi, plus ks * d^ne * (ne+2)/(2 pi) where d = dot(reflect(-wo, n),
    wi) > 0 (per channel)."""
    d = vec.dot(vec.reflect(-wo, n), wi)
    front = d > 0.0
    d_safe = torch.where(front, d, torch.ones_like(d))
    lobe = torch.pow(d_safe[..., None], ne) * (ne + 2.0) / M_TWO_PI
    diffuse = kd / M_PI
    return torch.where(front[..., None], diffuse + lobe * ks, diffuse)


def phong_sample(kd, ks, ne, wo, n, u_choice, r1, r2):
    """Kd-vs-Ks mixture sampling: with p = 1 - mean(ks) sample cosine
    around n, else the Phong lobe around the mirror direction.  Returns
    (direction (N,3), mixture pdf (N,), sampled_diffuse (N,) bool)."""
    avg_ne = ne.mean(dim=-1)
    p = 1.0 - ks.mean(dim=-1)
    r_mirror = vec.reflect(-wo, n)
    diffuse_dir = sampling.random_cos(n, r1, r2)
    phong_dir = sampling.random_phong(r_mirror, avg_ne, r1, r2)
    sampled_diffuse = u_choice < p
    d = torch.where(sampled_diffuse[..., None], diffuse_dir, phong_dir)
    proba_phong = ((avg_ne + 1.0) / M_TWO_PI * torch.pow(
        torch.clamp_min(vec.dot(r_mirror, d), 0.0), avg_ne))
    pdf = p * vec.dot(n, d) / M_PI + (1.0 - p) * proba_phong
    return d, pdf, sampled_diffuse


def lambert_eval(kd):
    """Lambert BRDF value kd/pi (reference: BRDF.h:109-111)."""
    return kd / M_PI


def lambert_sample(n, r1, r2):
    """Cosine sampling with pdf = cos/pi (reference: BRDF.h:103-108):
    (direction, pdf)."""
    d = sampling.random_cos(n, r1, r2)
    return d, vec.dot(n, d) / M_PI
