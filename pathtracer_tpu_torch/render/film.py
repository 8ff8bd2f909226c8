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


def make_film_spec_static(width: int, height: int, sigma: float,
                          device=None) -> FilmSpec:
    """make_film under the JAX package's name for a film built once
    outside the traced code (pallas make_film_spec_static)."""
    return make_film(width, height, sigma, device=device)


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


def splat(film: FilmSpec, image, sample_count, colors, dx, dy, row0: int = 0,
          block_rows=None):
    """Splat one sample per pixel of a row-contiguous block (row-major
    (Nb, 3) colors, (Nb,) jitter, Nb = block_rows * W, sensor rows
    [row0, row0 + block_rows); default the whole image) into the padded
    accumulators, in place, as a (2F+1)^2 stencil:
    w = exp(-((oi-dy)^2 + (oj-dx)^2) / (2 sigma^2)) * ratio / (2 pi sigma^2);
    image rows are flipped (row 0 = top = sensor row H-1).  A block's
    stencil reaches F rows past its edges, so a row-sharded render splats
    each block into a full film and sums the films
    (parallel/sharding.py)."""
    h, w, fs = film.height, film.width, film.filter_size
    hs = h if block_rows is None else block_rows
    sigma = film.sigma
    denom2 = float(np.float32(1.0 / (2.0 * sigma * sigma)))
    base = float(np.float32(1.0 / (sigma * sigma * 2.0 * np.pi)))
    cg = colors.view(hs, w, 3).flip(0)
    dxg = dx.view(hs, w).flip(0)
    dyg = dy.view(hs, w).flip(0)
    # sensor rows [row0, row0 + hs) are image rows [h - row0 - hs, h - row0)
    start = h - row0 - hs
    ratio_f = film.ratio.flip(0)[start:start + hs] * base
    part_img = image.new_zeros((hs + 2 * fs, w + 2 * fs, 3))
    part_cnt = sample_count.new_zeros((hs + 2 * fs, w + 2 * fs))
    for oi in range(-fs, fs + 1):
        for oj in range(-fs, fs + 1):
            wgt = torch.exp(-((oi - dyg) ** 2 + (oj - dxg) ** 2) * denom2) \
                * ratio_f
            r0, c0 = fs - oi, fs + oj
            part_img[r0:r0 + hs, c0:c0 + w] += cg * wgt[..., None]
            part_cnt[r0:r0 + hs, c0:c0 + w] += wgt
    image[start:start + hs + 2 * fs] += part_img
    sample_count[start:start + hs + 2 * fs] += part_cnt
    return image, sample_count


def to_display(image, sample_count, gamma=2.2):
    """HDR accumulator -> [0,1] display floats."""
    lin = image / RADIANCE_SCALE / torch.clamp_min(sample_count, 1.0)[..., None]
    return torch.clamp(torch.pow(torch.clamp_min(lin, 0.0), 1.0 / gamma),
                       0.0, 1.0)


def to_u8(display):
    d = display.detach().cpu().numpy()
    return np.clip(d * 255.0, 0.0, 255.0).astype(np.uint8)
