"""Measured BRDFs: MERL isotropic (.binary) and Titopo tabulated formats
(counterpart of pathtracer_tpu/models/merl.py).

IsoMERLBRDF / TitopoBRDF (reference: BRDF.h:116-248,
MERLBRDFRead.cpp:28-235) as table gathers: the half/difference-angle
reparameterization is per-lane trigonometry and each lookup gathers
table rows through `embedding`, whose backward is a segment reduction, so
the table can be an autograd leaf.  Sampling for both stays Phong's in
the integrator, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import vec

# MERL table resolution + channel scales (reference: MERLBRDFRead.h:3-8)
RES_TH = 90
RES_TD = 90
RES_PD = 360
RED_SCALE = 1.0 / 1500.0
GREEN_SCALE = 1.15 / 1500.0
BLUE_SCALE = 1.66 / 1500.0

MERL = 0
TITOPO = 1

M_PI = float(np.pi)


@dataclasses.dataclass
class MeasuredBRDF:
    """One loaded measured-BRDF table bound to scene objects."""

    data: torch.Tensor      # MERL: (3, TH*TD*PD/2) f32; Titopo: (Ti*To*Pd, 3)
    kind: int
    dims: tuple = ()
    path: str = ''          # source file (scene save; not used to render)

    def replace(self, **fields) -> 'MeasuredBRDF':
        return dataclasses.replace(self, **fields)

    def to(self, dev) -> 'MeasuredBRDF':
        return dataclasses.replace(self, data=self.data.to(dev))


def load_merl(path: str, device=None) -> MeasuredBRDF:
    """Read a MERL .binary file (reference: read_brdf,
    MERLBRDFRead.cpp:212-235), on `device` (None: the card)."""
    from .. import device as device_mod
    with open(path, 'rb') as f:
        dims = np.fromfile(f, np.int32, 3)
        n = int(dims[0] * dims[1] * dims[2])
        if n != RES_TH * RES_TD * RES_PD // 2:
            raise ValueError(f'MERL dims mismatch: {dims}')
        raw = np.fromfile(f, np.float64, 3 * n)
    table = raw.reshape(3, n).astype(np.float32)
    return MeasuredBRDF(data=torch.as_tensor(
        table, device=device_mod.resolve(device)), kind=MERL, path=path)


def load_titopo(path: str, n_thetai: int, n_thetao: int, n_phid: int,
                device=None) -> MeasuredBRDF:
    """Read a raw-float Titopo file (reference: BRDF.h:118-124)."""
    from .. import device as device_mod
    raw = np.fromfile(path, np.float32, n_thetai * n_thetao * n_phid * 3)
    return MeasuredBRDF(data=torch.as_tensor(
        raw.reshape(-1, 3).copy(), device=device_mod.resolve(device)),
        kind=TITOPO, dims=(n_thetai, n_thetao, n_phid), path=path)


def load_measured(path: str, device=None) -> MeasuredBRDF:
    """Extension dispatch of the reference's BRDF drop handler
    (mainApp.cpp:2418-2434): `.titopoh` -> Titopo 45x45x180, `.titopo` ->
    Titopo 90x90x360, anything else (`.binary`) -> MERL."""
    low = path.lower()
    if low.endswith('.titopoh'):
        return load_titopo(path, 45, 45, 180, device=device)
    if low.endswith('.titopo'):
        return load_titopo(path, 90, 90, 360, device=device)
    return load_merl(path, device=device)


def _local_frame(n, wi, wo):
    """Project wi/wo into the reference's tangent frame (BRDF.h:140-154)."""
    t1, t2 = vec.onb(n)
    wi_l = torch.stack([vec.dot(wi, t1), vec.dot(wi, t2), vec.dot(wi, n)], -1)
    wo_l = torch.stack([vec.dot(wo, t1), vec.dot(wo, t2), vec.dot(wo, n)], -1)
    return wi_l, wo_l


def _rotate_z(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1],
                        v[..., 2]], -1)


def _rotate_y(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([c * v[..., 0] + s * v[..., 2],
                        v[..., 1],
                        -s * v[..., 0] + c * v[..., 2]], -1)


def merl_index(wi, wo, n):
    """(table index (N,) int64, both directions above the horizon (N,)) of
    lookup_brdf_val (reference: MERLBRDFRead.cpp:76-177): half-angle
    sqrt-mapped theta_h, phi_d folded by reciprocity into [0, pi),
    nearest cell."""
    wi_l, wo_l = _local_frame(n, wi, wo)
    above = (wi_l[..., 2] > 0.0) & (wo_l[..., 2] > 0.0)

    half = vec.normalize((wi_l + wo_l) * 0.5)
    theta_half = torch.arccos(torch.clamp(half[..., 2], -1.0, 1.0))
    fi_half = torch.atan2(half[..., 1], half[..., 0])
    tmp = _rotate_z(wi_l, -fi_half)
    diff = _rotate_y(tmp, -theta_half)
    theta_diff = torch.arccos(torch.clamp(diff[..., 2], -1.0, 1.0))
    fi_diff = torch.atan2(diff[..., 1], diff[..., 0])

    th_deg = theta_half / (M_PI / 2.0) * RES_TH
    ith = torch.sqrt(torch.clamp_min(th_deg * RES_TH, 0.0)).to(torch.int32)
    ith = torch.clamp(torch.where(theta_half <= 0.0, torch.zeros_like(ith),
                                  ith), 0, RES_TH - 1)
    itd = torch.clamp((theta_diff / (M_PI * 0.5) * RES_TD).to(torch.int32),
                      0, RES_TD - 1)
    fi_d = torch.where(fi_diff < 0.0, fi_diff + M_PI, fi_diff)
    ipd = torch.clamp((fi_d / M_PI * (RES_PD // 2)).to(torch.int32),
                      0, RES_PD // 2 - 1)
    idx = ipd + itd * (RES_PD // 2) + ith * (RES_PD // 2) * RES_TD
    return idx.long(), above


def merl_eval(table: MeasuredBRDF, wi, wo, n):
    """Vectorized lookup_brdf_val (reference: MERLBRDFRead.cpp:76-207):
    nearest cell, per-channel scales, zero below the horizon
    (BRDF.h:229-232)."""
    idx, above = merl_index(wi, wo, n)
    rows = torch.nn.functional.embedding(idx, table.data.t())   # (N, 3)
    out = torch.stack([rows[:, 0] * RED_SCALE, rows[:, 1] * GREEN_SCALE,
                       rows[:, 2] * BLUE_SCALE], -1)
    return torch.where(above[..., None], torch.clamp_min(out, 0.0),
                       torch.zeros_like(out))


def titopo_coords(dims, wi, wo, n):
    """Continuous grid coordinates (fi, fo, fp) of TitopoBRDF::eval
    (reference: BRDF.h:132-160) and the horizon mask."""
    nti, nto, npd = dims
    wi_l, wo_l = _local_frame(n, wi, wo)
    above = (wi_l[..., 2] > 0.0) & (wo_l[..., 2] > 0.0)
    thetai = torch.arccos(torch.clamp(wi_l[..., 2], -1.0, 1.0))
    thetao = torch.arccos(torch.clamp(wo_l[..., 2], -1.0, 1.0))
    phid = (torch.atan2(wo_l[..., 1], wo_l[..., 0])
            - torch.atan2(wi_l[..., 1], wi_l[..., 0]))
    phid = torch.remainder(phid, 2.0 * M_PI)
    fi = thetai / (M_PI / 2.0) * nti
    fo = thetao / (M_PI / 2.0) * nto
    fp = phid / (2.0 * M_PI) * npd
    return fi, fo, fp, above


def titopo_eval(table: MeasuredBRDF, wi, wo, n):
    """Vectorized TitopoBRDF::eval (reference: BRDF.h:132-185): trilinear
    interpolation over the (theta_i, theta_o, phi_d) grid."""
    nti, nto, npd = table.dims
    fi, fo, fp, above = titopo_coords(table.dims, wi, wo, n)
    i0 = torch.clamp(fi.to(torch.int32), 0, nti - 1)
    o0 = torch.clamp(fo.to(torch.int32), 0, nto - 1)
    p0 = torch.clamp(fp.to(torch.int32), 0, npd - 1)
    i1 = torch.clamp_max(i0 + 1, nti - 1)
    o1 = torch.clamp_max(o0 + 1, nto - 1)
    p1 = torch.clamp_max(p0 + 1, npd - 1)
    wi_f = (fi - i0)[..., None]
    wo_f = (fo - o0)[..., None]
    wp_f = (fp - p0)[..., None]

    def at(i, o, p_):
        return torch.nn.functional.embedding(
            ((i * nto + o) * npd + p_).long(), table.data)

    v = ((at(i0, o0, p0) * (1 - wp_f) + at(i0, o0, p1) * wp_f) * (1 - wo_f)
         + (at(i0, o1, p0) * (1 - wp_f) + at(i0, o1, p1) * wp_f) * wo_f
         ) * (1 - wi_f) + (
        (at(i1, o0, p0) * (1 - wp_f) + at(i1, o0, p1) * wp_f) * (1 - wo_f)
        + (at(i1, o1, p0) * (1 - wp_f) + at(i1, o1, p1) * wp_f) * wo_f
    ) * wi_f
    return torch.where(above[..., None], v, torch.zeros_like(v))


def measured_eval(table: MeasuredBRDF, wi, wo, n):
    if table.kind == MERL:
        return merl_eval(table, wi, wo, n)
    return titopo_eval(table, wi, wo, n)
