"""Film: Gaussian splat accumulation, border normalization, tonemap
(counterpart of pathtracer_tpu/render/film.py)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod

RADIANCE_SCALE = float(np.float32(196964.7))


class FilmSpec(NamedTuple):
    width: int
    height: int
    sigma: float
    filter_size: int          # F = ceil(2*sigma)
    ratio: torch.Tensor       # (H,W) 1/sum of the in-bounds filter taps


def make_film(width: int, height: int, sigma: float = 0.5,
              device=None) -> FilmSpec:
    """Per-pixel border ratio, on `device` (None: the card): the Gaussian
    taps separate as f(i)*f(j), so the normalization is an outer product
    of clamped 1D window sums."""
    device = device_mod.resolve(device)
    fsize = int(math.ceil(sigma * 2.0))
    offs = np.arange(-fsize, fsize + 1, dtype=np.float64)
    f1d = np.exp(-offs ** 2 / (2.0 * sigma * sigma)) / (
        math.sqrt(2.0 * math.pi) * sigma)

    def axis_sums(n):
        idx = np.arange(n)
        lo = np.maximum(0, idx - fsize) - idx + fsize
        hi = np.minimum(idx + fsize, n - 1) - idx + fsize
        csum = np.concatenate([[0.0], np.cumsum(f1d)])
        return csum[hi + 1] - csum[lo]

    ratio = (1.0 / np.outer(axis_sums(height), axis_sums(width))
             ).astype(np.float32)
    return FilmSpec(width=width, height=height, sigma=float(sigma),
                    filter_size=fsize,
                    ratio=torch.as_tensor(ratio, device=device))


def alloc(film: FilmSpec):
    """Fresh padded accumulators: (H+2F, W+2F, 3) image + (H+2F, W+2F)
    weight; the F-pixel halo absorbs splats that fall outside the image."""
    f = film.filter_size
    h, w = film.height + 2 * f, film.width + 2 * f
    dev = film.ratio.device
    return (torch.zeros((h, w, 3), device=dev),
            torch.zeros((h, w), device=dev))


def crop(film: FilmSpec, padded):
    f = film.filter_size
    return padded[f:f + film.height, f:f + film.width]


def splat(film: FilmSpec, image, sample_count, colors, dx, dy):
    """Splat one sample per pixel (row-major (H*W, 3) colors, (H*W,)
    jitter) into the padded accumulators, in place, as a (2F+1)^2 stencil:
    w = exp(-((oi-dy)^2 + (oj-dx)^2) / (2 sigma^2)) * ratio / (2 pi sigma^2);
    image rows are flipped (row 0 = top = sensor row H-1)."""
    h, w, fs = film.height, film.width, film.filter_size
    sigma = film.sigma
    denom2 = float(np.float32(1.0 / (2.0 * sigma * sigma)))
    base = float(np.float32(1.0 / (sigma * sigma * 2.0 * np.pi)))
    cg = colors.view(h, w, 3).flip(0)
    dxg = dx.view(h, w).flip(0)
    dyg = dy.view(h, w).flip(0)
    ratio_f = film.ratio.flip(0) * base
    part_img = torch.zeros_like(image)
    part_cnt = torch.zeros_like(sample_count)
    for oi in range(-fs, fs + 1):
        for oj in range(-fs, fs + 1):
            wgt = torch.exp(-((oi - dyg) ** 2 + (oj - dxg) ** 2) * denom2) \
                * ratio_f
            r0, c0 = fs - oi, fs + oj
            part_img[r0:r0 + h, c0:c0 + w] += cg * wgt[..., None]
            part_cnt[r0:r0 + h, c0:c0 + w] += wgt
    image += part_img
    sample_count += part_cnt
    return image, sample_count


def to_display(image, sample_count, gamma=2.2):
    """HDR accumulator -> [0,1] display floats."""
    lin = image / RADIANCE_SCALE / torch.clamp_min(sample_count, 1.0)[..., None]
    return torch.clamp(torch.pow(torch.clamp_min(lin, 0.0), 1.0 / gamma),
                       0.0, 1.0)


def to_u8(display):
    d = display.detach().cpu().numpy()
    return np.clip(d * 255.0, 0.0, 255.0).astype(np.uint8)
