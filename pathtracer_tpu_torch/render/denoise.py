"""Denoiser hook: auxiliary-guided a-trous wavelet filtering (counterpart
of pathtracer_tpu/render/denoise.py).

The reference post-filters offline renders with Intel Open Image Denoise
fed by color, albedo and normal buffers (Raytracer.cpp:1721-1746; the aux
buffers accumulate unsplatted, :1631-1645).  This slot keeps the same
interface, denoise(color, albedo, normal), with an edge-avoiding a-trous
wavelet filter (Dammertz et al. 2010): 25 clamped shifts per level, each
tap weighted by its colour, albedo and normal distance.
"""

from __future__ import annotations

import numpy as np
import torch

# 5-tap B3-spline kernel
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _shift2d(img, di: int, dj: int):
    """img shifted by (di, dj) with clamped (replicated) borders."""
    h, w = img.shape[0], img.shape[1]
    i = torch.clamp(torch.arange(h, device=img.device) + di, 0, h - 1)
    j = torch.clamp(torch.arange(w, device=img.device) + dj, 0, w - 1)
    return img.index_select(0, i).index_select(1, j)


def atrous_denoise(color, albedo, normal, iterations: int = 4,
                   sigma_color: float = 1.0, sigma_normal: float = 0.25,
                   sigma_albedo: float = 0.1):
    """Edge-avoiding a-trous filtering of an (H, W, 3) HDR colour buffer
    (radiance divided by the sample count), guided by the primary hit's
    (H, W, 3) albedo and normal; the stride doubles each level.  Returns
    the filtered (H, W, 3) colour."""
    color = torch.as_tensor(color, dtype=torch.float32)
    albedo = torch.as_tensor(albedo, dtype=torch.float32,
                             device=color.device)
    normal = torch.as_tensor(normal, dtype=torch.float32,
                             device=color.device)
    # luminance scale adapts the colour sigma to HDR magnitudes
    lum_scale = torch.clamp_min(torch.mean(torch.abs(color)), 1e-6)
    den_c = (sigma_color * lum_scale) ** 2 + 1e-12
    out = color
    for level in range(iterations):
        stride = 1 << level
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(out[..., :1])
        for ki in range(-2, 3):
            for kj in range(-2, 3):
                k = float(_B3[ki + 2] * _B3[kj + 2])
                di, dj = ki * stride, kj * stride
                c = _shift2d(out, di, dj)
                a = _shift2d(albedo, di, dj)
                nn = _shift2d(normal, di, dj)
                dw_c = torch.sum((c - out) ** 2, -1, keepdim=True) / den_c
                dw_a = torch.sum((a - albedo) ** 2, -1, keepdim=True) / (
                    sigma_albedo ** 2 + 1e-12)
                dw_n = torch.sum((nn - normal) ** 2, -1, keepdim=True) / (
                    sigma_normal ** 2 + 1e-12)
                w = k * torch.exp(-(dw_c + dw_a + dw_n))
                acc = acc + w * c
                wacc = wacc + w
        out = acc / torch.clamp_min(wacc, 1e-12)
    return out


# the entry point under the JAX package's name (its renderer calls
# denoise.denoise; the jit there has no counterpart here)
denoise = atrous_denoise
