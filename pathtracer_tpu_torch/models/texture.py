"""Texture channels: load, sample, and per-group device storage
(counterpart of pathtracer_tpu/models/texture.py).

One class serves all 8 map channels (albedo, specular, normal, alpha,
roughness, transparency mask, refraction index, subsurface; reference:
BRDF.h:252-426): colour maps are /255 then gamma-2.2-linearized at load
(BRDF.h:393-404), normal maps decode (v-128)/norm (BRDF.h:406-419),
sampling is a point lookup with fractional wrap (BRDF.h:270-275, 293-307),
and a constant colour is an image-less channel with a multiplier.

Every texel fetch is `embedding` on the image flattened to (H*W, 3): the
same gather as img[y, x], whose backward sums each texel's lanes with a
segment reduction (indexing's backward, index_put_ with accumulate, runs
the lanes of each row in one serial loop on the card; scene._material).
Index arithmetic stays in float32 in the JAX package's order, and
`.to(torch.int32)` truncates toward zero as `astype(int32)` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

CHANNELS = ('kd', 'ks', 'normal', 'alpha', 'roughness', 'transp', 'refr',
            'ksub')


def load_color_image(path: str) -> np.ndarray:
    """Color map load: /255 then ^2.2 (reference: BRDF.h:393-404)."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert('RGB'), np.float32)
    return np.power(img / 255.0, 2.2).astype(np.float32)


def load_normal_image(path: str) -> np.ndarray:
    """Normal map decode: (v - 128)/|v - 128| of the raw u8 values, not
    /255 (reference: BRDF.h:406-419)."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert('RGB'), np.float32) - 128.0
    n = np.linalg.norm(img, axis=-1, keepdims=True)
    return (img / np.maximum(n, 1e-12)).astype(np.float32)


def load_raw_image(path: str) -> np.ndarray:
    """Scalar channels (roughness, transp, refr) load as colour maps, as
    the reference's loadColors does."""
    return load_color_image(path)


@dataclasses.dataclass
class GroupTextures:
    """Optional per-group (H, W, 3) float32 images; a constant channel is
    None (its multiplier lives in the mesh's g_* tables or the object
    row)."""

    kd: Optional[torch.Tensor] = None       # linearized
    ks: Optional[torch.Tensor] = None
    normal: Optional[torch.Tensor] = None   # decoded tangent-space
    alpha: Optional[torch.Tensor] = None    # red channel used
    roughness: Optional[torch.Tensor] = None
    transp: Optional[torch.Tensor] = None
    refr: Optional[torch.Tensor] = None
    ksub: Optional[torch.Tensor] = None

    @property
    def any_image(self) -> bool:
        return any(getattr(self, ch) is not None for ch in CHANNELS)

    def replace(self, **fields) -> 'GroupTextures':
        return dataclasses.replace(self, **fields)

    def to(self, dev) -> 'GroupTextures':
        return GroupTextures(**{ch: None if getattr(self, ch) is None
                                else getattr(self, ch).to(dev)
                                for ch in CHANNELS})


_LOADERS = {
    'kd': load_color_image, 'ks': load_color_image, 'ksub': load_color_image,
    'alpha': load_color_image, 'roughness': load_raw_image,
    'transp': load_raw_image, 'refr': load_raw_image,
    'normal': load_normal_image,
}


def make_group_textures(spec, device=None) -> GroupTextures:
    """GroupTextures from a {channel: path-or-array} dict (the reference's
    8 per-object texture slots, Geometry.h:399-445), on `device`.  Paths
    go through the channel's loader; arrays are taken as already decoded,
    a 2-D one repeated into three channels."""
    kw = {}
    for ch, val in (spec or {}).items():
        if ch not in _LOADERS:
            raise ValueError(f'unknown texture channel {ch!r}')
        if val is None:
            continue
        arr = (_LOADERS[ch](val) if isinstance(val, str)
               else np.asarray(val, np.float32))
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        kw[ch] = torch.as_tensor(arr, device=device)
    return GroupTextures(**kw)


def wrap(u):
    """Fractional repeat wrap (reference: BRDF.h:270-275)."""
    return u - torch.floor(u)


def fetch(img, y, x):
    """img[y, x] through embedding on the (H*W, C) flattening."""
    w = img.shape[1]
    flat = img.reshape(img.shape[0] * w, img.shape[2])
    return torch.nn.functional.embedding(y.long() * w + x.long(), flat)


def sample_point(img, u, v):
    """Point sample at wrapped (u, v) (reference getVec, BRDF.h:293-299):
    x = u*(W-1), y = v*(H-1), truncated."""
    h, w = img.shape[0], img.shape[1]
    u = wrap(u)
    v = wrap(v)
    x = torch.clamp((u * (w - 1)).to(torch.int32), 0, w - 1)
    y = torch.clamp((v * (h - 1)).to(torch.int32), 0, h - 1)
    return fetch(img, y, x)


def sample_red(img, u, v):
    """Red-channel scalar sample (reference getValRed, BRDF.h:381-392)."""
    return sample_point(img, u, v)[..., 0]


def _blend(c00, c10, c01, c11, fx, fy):
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_bilinear(img, u, v):
    """Bilinear sample at wrapped (u, v), an option the reference lacks;
    the same x = u*(W-1) mapping, so it equals the point sample at texel
    centres."""
    h, w = img.shape[0], img.shape[1]
    xf = wrap(u) * (w - 1)
    yf = wrap(v) * (h - 1)
    x0 = torch.clamp(torch.floor(xf).to(torch.int32), 0, w - 1)
    y0 = torch.clamp(torch.floor(yf).to(torch.int32), 0, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (xf - x0.to(xf.dtype))[..., None]
    fy = (yf - y0.to(yf.dtype))[..., None]
    return _blend(fetch(img, y0, x0), fetch(img, y0, x1),
                  fetch(img, y1, x0), fetch(img, y1, x1), fx, fy)


@dataclasses.dataclass
class ChannelAtlas:
    """One channel's per-group images stacked vertically into one
    (Ht, Wmax, 3) image with per-group row offset and size tables, so one
    gather serves every group (the reference's per-group Texture vector,
    Geometry.h:666-713, at wavefront width)."""

    img: torch.Tensor       # (Ht, Wmax, 3)
    y0: torch.Tensor        # (G,) int32 first row of group g's image
    h: torch.Tensor         # (G,) int32 (1 for imageless groups)
    w: torch.Tensor         # (G,) int32
    has: torch.Tensor       # (G,) bool

    def replace(self, **fields) -> 'ChannelAtlas':
        return dataclasses.replace(self, **fields)

    def to(self, dev) -> 'ChannelAtlas':
        return ChannelAtlas(*(getattr(self, f.name).to(dev)
                              for f in dataclasses.fields(self)))


def build_atlas(images, device=None) -> Optional[ChannelAtlas]:
    """Pack a per-group list of Optional (H, W, 3) images into a
    ChannelAtlas on `device` (None when no group has an image)."""
    if not any(im is not None for im in images):
        return None
    y0s, hs, ws, rows = [], [], [], []
    arrays = [None if im is None else
              (im.detach().cpu().numpy() if isinstance(im, torch.Tensor)
               else np.asarray(im, np.float32)) for im in images]
    wmax = max(int(im.shape[1]) for im in arrays if im is not None)
    y = 0
    for im in arrays:
        if im is None:
            y0s.append(0)
            hs.append(1)
            ws.append(1)
            continue
        hh, ww = im.shape[0], im.shape[1]
        if ww < wmax:
            im = np.pad(im, ((0, 0), (0, wmax - ww), (0, 0)))
        rows.append(im.astype(np.float32))
        y0s.append(y)
        hs.append(hh)
        ws.append(ww)
        y += hh

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return ChannelAtlas(
        img=torch.as_tensor(np.concatenate(rows, axis=0), device=device),
        y0=i32(y0s), h=i32(hs), w=i32(ws),
        has=torch.as_tensor([im is not None for im in arrays],
                            device=device))


def sample_atlas(at: ChannelAtlas, grp, u, v, bilinear: bool = False):
    """Per-lane atlas sample: (values (N, 3), has (N,) bool).  Point mode
    is sample_point exactly; bilinear keeps the 2x2 footprint inside the
    group's own rows."""
    grp = grp.long()
    hg = at.h[grp]
    wg = at.w[grp]
    y0g = at.y0[grp]
    xf = wrap(u) * (wg - 1).to(torch.float32)
    yf = wrap(v) * (hg - 1).to(torch.float32)
    x0 = torch.minimum(torch.clamp_min(xf.to(torch.int32), 0), wg - 1)
    y0 = torch.minimum(torch.clamp_min(yf.to(torch.int32), 0), hg - 1)
    has = at.has[grp]
    if not bilinear:
        return fetch(at.img, y0g + y0, x0), has
    x1 = torch.minimum(x0 + 1, wg - 1)
    y1 = torch.minimum(y0 + 1, hg - 1)
    fx = (xf - x0.to(xf.dtype))[..., None]
    fy = (yf - y0.to(yf.dtype))[..., None]
    val = _blend(fetch(at.img, y0g + y0, x0), fetch(at.img, y0g + y0, x1),
                 fetch(at.img, y0g + y1, x0), fetch(at.img, y0g + y1, x1),
                 fx, fy)
    return val, has
