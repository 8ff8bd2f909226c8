"""Learned kernel-predicting denoiser, the OIDN-slot model (counterpart of
pathtracer_tpu/render/denoise_net.py).

A small kernel-predicting CNN (KPCN family, Bako et al. 2017, scaled
down): a conv stack reads tone-mapped radiance and the primary-hit
auxiliaries and predicts a per-pixel 5x5 filter kernel, softmax
normalised, so each output is a convex combination of the input's
neighbourhood and cannot invent energy.  The weights were trained by the
JAX package (scripts/train_denoiser.py) and ship beside this module,
converted at load by convert.kpcn_state_dict.  Without the weights file
denoise_learned falls back to the a-trous filter (render/denoise.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import device as device_mod

KSIZE = 5                     # predicted kernel width
_R = KSIZE // 2
WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'denoiser_weights.npz')


class KPCNLite(nn.Module):
    """`depth` 3x3 convolutions of `features` channels with ReLU, then a
    3x3 convolution to KSIZE^2 kernel logits; zero padding 1 (flax's
    'SAME').  Input and output are channels-last (H, W, C)."""

    def __init__(self, features: int = 48, depth: int = 5, in_ch: int = 10):
        super().__init__()
        chans = [in_ch] + [features] * depth
        self.convs = nn.ModuleList(
            [nn.Conv2d(a, b, 3, padding=1) for a, b in zip(chans, chans[1:])]
            + [nn.Conv2d(features, KSIZE * KSIZE, 3, padding=1)])

    def forward(self, x):
        x = x.permute(2, 0, 1)[None]
        for conv in self.convs[:-1]:
            x = F.relu(conv(x))
        return self.convs[-1](x)[0].permute(1, 2, 0)


def features_from_buffers(color, albedo, normal):
    """(H, W, 10) network input: log1p tone-mapped radiance, albedo,
    normal, mean tone-mapped luminance."""
    c = torch.log1p(torch.clamp_min(color, 0.0))
    lum = torch.mean(c, dim=-1, keepdim=True)
    return torch.cat([c, albedo, normal, lum], dim=-1)


def apply_kernels(color, logits):
    """Apply the per-pixel softmax kernels to the radiance neighbourhood
    (clamped borders; taps di-outer, dj-inner)."""
    w = torch.softmax(logits, dim=-1)               # (H, W, K*K)
    h, wd = color.shape[0], color.shape[1]
    out = torch.zeros_like(color)
    idx = 0
    for di in range(-_R, _R + 1):
        i = torch.clamp(torch.arange(h, device=color.device) + di, 0, h - 1)
        ci = color.index_select(0, i)
        for dj in range(-_R, _R + 1):
            j = torch.clamp(torch.arange(wd, device=color.device) + dj, 0,
                            wd - 1)
            out = out + w[..., idx:idx + 1] * ci.index_select(1, j)
            idx += 1
    return out


@torch.no_grad()
def denoise_apply(model: KPCNLite, color, albedo, normal):
    """Denoise an (H, W, 3) HDR buffer with a KPCNLite on the buffers'
    device."""
    return apply_kernels(color, model(features_from_buffers(color, albedo,
                                                            normal)))


def init_params(seed: int = 0) -> dict:
    """A fresh KPCNLite's state dict on the CPU, initialised from `seed`
    without touching the global generator (pallas init_params)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return KPCNLite().state_dict()


def flax_weights(params) -> dict:
    """A KPCNLite's weights (the module or its state dict) in the JAX
    package's flattened flax layout, the inverse of
    convert.kpcn_state_dict: `Conv_<i>/kernel` HWIO, `Conv_<i>/bias`,
    float32 numpy."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    out = {}
    i = 0
    while f'convs.{i}.weight' in state:
        k = state[f'convs.{i}.weight'].detach().cpu().numpy()
        out[f'Conv_{i}/kernel'] = np.ascontiguousarray(
            k.astype(np.float32).transpose(2, 3, 1, 0))
        out[f'Conv_{i}/bias'] = state[f'convs.{i}.bias'].detach().cpu() \
            .numpy().astype(np.float32)
        i += 1
    return out


def save_weights(params, path: str = WEIGHTS_PATH):
    """Write flax_weights(params) as the JAX save_weights does."""
    np.savez_compressed(path, **flax_weights(params))


def load_weights(path: Optional[str] = None) -> Optional[dict]:
    """The shipped weights (WEIGHTS_PATH unless `path`) as the port's
    state dict on the CPU; None when the file is absent."""
    from ..convert import kpcn_state_dict
    path = WEIGHTS_PATH if path is None else path
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return kpcn_state_dict({k: data[k] for k in data.files})


def load_model(path: Optional[str] = None, device=None) -> Optional[KPCNLite]:
    """KPCNLite with the shipped weights on `device` (None: the card), in
    eval mode; None when the weights file is absent."""
    state = load_weights(path)
    if state is None:
        return None
    model = KPCNLite()
    model.load_state_dict(state)
    return model.to(device_mod.resolve(device)).eval()


def denoise_learned(color, albedo, normal):
    """OIDN-slot entry on the tensors' device: the learned model when its
    weights ship, the a-trous filter otherwise (same signature as
    denoise.atrous_denoise)."""
    model = load_model(device=color.device)
    if model is None:
        from . import denoise as dn
        return dn.atrous_denoise(color, albedo, normal)
    return denoise_apply(model, color, albedo, normal)
