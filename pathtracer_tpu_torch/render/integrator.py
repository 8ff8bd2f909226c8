"""Wavefront path integrator (counterpart of pathtracer_tpu/render/integrator.py).

Every path in flight is a lane of (N,) / (N,3) tensors; the bounce loop is
bounce-major and branch divergence (miss / dome / light / mirror / refract /
diffuse) is lane masking.  Each path owns a PCG32 stream; the canonical
draw order, with gated draws leaving a lane's stream untouched:

    camera:      dx, dy, dx_aperture, dy_aperture      (4 draws, renderer)
    per bounce:  subsurface-entry RR u       (diffuse subsurface lanes)
                 NEE r1, r2                  (diffuse lanes)
                 Fresnel RR u                (transparent lanes)
                 Phong lobe-choice u         (diffuse lanes)

The indirect 2D sample is the per-pixel Cranley–Patterson rotation of the
per-sample lattice point, reused at every depth.

Gradients: the JAX integrator's detached-sampling estimator.  The sampled
indirect direction and its pdf are detached where JAX stops their
gradient, so with material and light leaves no ray carries a gradient and
the mesh queries, whose kernels have none, see constant rays
(ops/cluster.py); autograd differentiates the NEE weights, the BRDF
values, the light power and the path throughput.  Every step is out of
place, compaction included, so one code path serves rendering and
autograd.

BRDFs: Phong everywhere, overridden per measured table (`_eval_brdf`) at
the NEE and indirect terms; sampling stays Phong's, as in JAX.

Not ported yet: fog, the subsurface relocation (the entry RR draw is kept,
so draw counts already match), ghosts and background photos (ROADMAP
Queue 1 item 8); `scene.build_scene` refuses scenes that need them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng as prng
from ..core import sampling, vec
from ..models import brdf
from ..models import merl as merl_mod
from ..scene import scene as scn

M_PI = float(np.float32(np.pi))
SS_PROBA = float(np.float32(0.6))


@dataclasses.dataclass
class PathState:
    org: torch.Tensor          # (N,3)
    dirn: torch.Tensor         # (N,3)
    weight: torch.Tensor       # (N,3) path throughput
    color: torch.Tensor        # (N,3) accumulated radiance
    alive: torch.Tensor        # (N,) bool
    show_lights: torch.Tensor  # (N,) bool — NEE double-count guard
    show_env: torch.Tensor     # (N,) bool
    had_ss: torch.Tensor       # (N,) bool
    rng: tuple                 # 4 x (N,) int64 PCG state halves
    normal_aux: torch.Tensor   # (N,3) primary-hit normal (denoiser feed)
    albedo_aux: torch.Tensor   # (N,3)
    lkey: torch.Tensor         # (N,) int64 surface-locality key of the hit

    def take(self, idx) -> 'PathState':
        """Gather (a permutation) or slice every lane field."""
        return PathState(**{
            f.name: (tuple(x[idx] for x in getattr(self, f.name))
                     if f.name == 'rng' else getattr(self, f.name)[idx])
            for f in dataclasses.fields(self)})

    def with_prefix(self, part: 'PathState') -> 'PathState':
        """The lanes of `part` followed by this state's lanes past
        len(part), out of place (autograd keeps the tensors it saved)."""
        m = part.alive.shape[0]

        def cat(new, old):
            return torch.cat([new, old[m:]])

        return PathState(**{
            f.name: (tuple(cat(a, b) for a, b in zip(part.rng, self.rng))
                     if f.name == 'rng'
                     else cat(getattr(part, f.name), getattr(self, f.name)))
            for f in dataclasses.fields(self)})


def _where3(mask, new, old):
    return torch.where(mask[:, None], new, old)


def _eval_brdf(sc, hit, wi, wo, nrm):
    """BRDF dispatch: Phong everywhere, overridden per measured table (the
    reference's per-Object virtual brdf->eval, Raytracer.cpp:543)."""
    f = brdf.phong_eval(hit.kd, hit.ks, hit.ne, wi, wo, nrm)
    for k, table in enumerate(sc.measured_brdfs):
        f = _where3(hit.brdf_type == k + 1,
                    merl_mod.measured_eval(table, wi, wo, nrm), f)
    return f


def _bounce(sc, depth: int, st: PathState, cp_r12) -> PathState:
    """One bounce over every lane of `st`; returns the next state."""
    alive = st.alive & (vec.norm2(st.weight) >= 1e-4)       # weight cull
    hit = scn.intersect(sc, st.org, st.dirn)
    p, nrm, ray_dir = hit.p, hit.n, st.dirn
    normal_aux, albedo_aux = st.normal_aux, st.albedo_aux
    if depth == 0:
        normal_aux = _where3(hit.hit, nrm, normal_aux)
        albedo_aux = _where3(hit.hit, hit.kd, albedo_aux)

    at_dome = alive & hit.hit & (hit.obj_id == 1)
    at_light = alive & hit.hit & (hit.obj_id == 0)
    at_surface = alive & hit.hit & (hit.obj_id >= 2)
    is_mirror = at_surface & hit.miroir
    is_transp = at_surface & hit.transp & ~hit.miroir
    is_diffuse = at_surface & ~hit.miroir & ~hit.transp

    # subsurface-entry RR (draws first); with no ksub material the gate is
    # empty and no lane consumes the draw
    can_ss = is_diffuse & (vec.norm2(hit.ksub) > 1e-8) & ~st.had_ss
    u_ss, rng_st = prng.next_uniform(st.rng, gate=can_ss)
    take_ss = can_ss & (u_ss < SS_PROBA)
    one = torch.ones_like(u_ss)
    subs_w = torch.where(take_ss, one / SS_PROBA,
                         torch.where(can_ss, one / (1.0 - SS_PROBA), one))
    subs_w = subs_w[:, None]

    # NEE to the spherical light
    u1, u2, rng_st = prng.next_uniform2(rng_st, gate=is_diffuse)
    axe_op = vec.normalize(p - sc.center_light)
    dir_al = sampling.random_cos(axe_op, u1, u2)
    point_al = dir_al * sc.radius_light + sc.center_light
    to_light = point_al - p
    d_light2 = vec.norm2(to_light)
    wi = vec.normalize(to_light)
    cos_surf = vec.dot(nrm, wi)
    shadow_org = p + 0.01 * wi
    dist = torch.sqrt(d_light2) - 0.01
    # only diffuse front-facing lanes need the visibility test; a zero
    # limit lets the mesh any-hit cull drop every other lane
    nee_gate = is_diffuse & (cos_surf >= 0.0)
    blocked = scn.intersect_shadow(
        sc, shadow_org, wi, torch.where(nee_gate, dist, torch.zeros_like(dist)))
    shadowed = (cos_surf < 0.0) | blocked
    f_brdf = _eval_brdf(sc, hit, wi, -ray_dir, nrm)
    jac = vec.dot(dir_al, -wi) / torch.clamp_min(d_light2, 1e-12)
    proba = vec.dot(axe_op, dir_al) / (M_PI * sc.radius_light
                                       * sc.radius_light)
    nee = (sc.light_power * torch.clamp_min(cos_surf, 0.0) * jac
           / torch.where(proba > 0.0, proba, one))[:, None] * f_brdf * subs_w
    nee_ok = is_diffuse & ~shadowed & (proba > 0.0)

    zero3 = torch.zeros_like(st.color)
    color = st.color
    color = color + _where3(at_dome & st.show_env,
                            st.weight * (sc.envmap_intensity * hit.ke), zero3)
    color = color + _where3(at_light & st.show_lights,
                            st.weight * sc.light_power, zero3)
    color = color + _where3(at_surface,
                            st.weight * hit.ke * sc.envmap_intensity, zero3)
    color = color + _where3(nee_ok, st.weight * nee, zero3)

    # mirror
    mirror_dir = vec.reflect(ray_dir, nrm)
    mirror_org = p + 0.001 * nrm

    # transparent: Fresnel RR reflect / refract
    u_fresnel, rng_st = prng.next_uniform(rng_st, gate=is_transp)
    cos_in = vec.dot(ray_dir, nrm)
    exiting = cos_in > 0.0
    n1 = torch.where(exiting, hit.refr_index, one)
    n2 = torch.where(exiting, one, hit.refr_index)
    n_t = _where3(exiting, -nrm, nrm)
    eta = n1 / n2
    cos_t = vec.dot(n_t, ray_dir)
    radical = 1.0 - eta * eta * (1.0 - cos_t * cos_t)
    tir = radical <= 0.0
    refr_dir = (eta[:, None] * (ray_dir - cos_t[:, None] * n_t)
                - n_t * torch.sqrt(torch.clamp_min(radical, 0.0))[:, None])
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    fres = torch.where(
        exiting,
        r0 + (1.0 - r0) * torch.pow(torch.clamp_min(
            1.0 - vec.dot(refr_dir, nrm), 0.0), 5.0),
        r0 + (1.0 - r0) * torch.pow(torch.clamp_min(1.0 + cos_in, 0.0), 5.0))
    take_reflect = tir | (u_fresnel < fres)
    transp_dir = _where3(take_reflect, vec.reflect(ray_dir, nrm), refr_dir)
    transp_org = _where3(take_reflect, p + 0.001 * n_t, p - 0.001 * n_t)

    # diffuse indirect: Phong mixture with the CP-lattice 2D sample
    u_choice, rng_st = prng.next_uniform(rng_st, gate=is_diffuse)
    ind_dir, ind_pdf, _ = brdf.phong_sample(
        hit.kd, hit.ks, hit.ne, -ray_dir, nrm, u_choice,
        cp_r12[:, 0], cp_r12[:, 1])
    # detached-sampling estimator: the sampled direction and its pdf are
    # constants (JAX integrator stop_gradient, before `reject`)
    ind_dir, ind_pdf = ind_dir.detach(), ind_pdf.detach()
    reject = ((vec.dot(ind_dir, nrm) < 0.0)
              | (vec.dot(ind_dir, vec.reflect(ray_dir, nrm)) < 0.0)
              | (ind_pdf <= 0.0))
    f_ind = _eval_brdf(sc, hit, ind_dir, -ray_dir, nrm)
    ind_weight = (st.weight * subs_w * f_ind
                  * (vec.dot(nrm, ind_dir)
                     / torch.where(ind_pdf > 0.0, ind_pdf, one))[:, None])
    ind_org = p + 0.01 * ind_dir

    cont_diffuse = is_diffuse & ~reject
    next_alive = is_mirror | is_transp | cont_diffuse
    new_org = _where3(is_mirror, mirror_org,
                      _where3(is_transp, transp_org, ind_org))
    new_dir = _where3(is_mirror, mirror_dir,
                      _where3(is_transp, transp_dir, ind_dir))
    new_weight = _where3(cont_diffuse, ind_weight, st.weight)
    return PathState(
        org=_where3(next_alive, new_org, st.org),
        dirn=_where3(next_alive, new_dir, st.dirn),
        weight=_where3(next_alive, new_weight, st.weight),
        color=color,
        alive=next_alive,
        # diffuse continuations must not re-see the light (NEE dedup)
        show_lights=st.show_lights & ~cont_diffuse,
        show_env=torch.ones_like(st.show_env),
        had_ss=st.had_ss,
        rng=rng_st,
        normal_aux=normal_aux, albedo_aux=albedo_aux,
        lkey=torch.where(hit.hit, hit.lkey, torch.zeros_like(hit.lkey)),
    )


def _sort_wavefront(st: PathState, cp_r12, lane_id):
    """Reorder lanes: alive first, grouped by direction octant, then by the
    surface-locality key of the hit they start on (stable, so pixel-tile
    order survives inside each group)."""
    d = st.dirn
    octant = ((d[:, 0] > 0).long() * 4 + (d[:, 1] > 0).long() * 2
              + (d[:, 2] > 0).long())
    key = torch.where(st.alive, (octant << 13) | st.lkey.clamp(0, 8191),
                      torch.full_like(octant, 8 << 13))
    perm = torch.sort(key, stable=True).indices
    st = st.take(perm)
    st.lkey = torch.zeros_like(st.lkey)     # recomputed by the next hit
    return st, cp_r12[perm], lane_id[perm]


def trace_paths(sc, origins, dirs, rng_state, cp_r12, nb_bounces: int,
                sort_rays: bool = False, compact_rays: bool = False):
    """Trace a wavefront of paths to completion.

    origins, dirs: (N,3) primary rays; rng_state: per-lane PCG streams past
    the camera draws; cp_r12: (N,2) rotated lattice sample.  compact_rays
    (requires sort_rays) runs bounces after the first only on the live
    prefix: after the alive-first sort, dead lanes sit at the tail and a
    bounce leaves them unchanged, so this is exact.  The bounced prefix and
    the untouched tail make a new state, so autograd runs through it.

    Returns (color, normal_aux, albedo_aux, live_counts) where live_counts
    is the list of per-bounce live-lane counts (0-d int64 tensors)."""
    n = origins.shape[0]
    if compact_rays and not sort_rays:
        raise ValueError('compact_rays requires sort_rays (the octant sort '
                         'is the compaction permutation)')
    dev = origins.device

    def zeros3():
        return torch.zeros((n, 3), device=dev)

    def flags(value):
        return torch.full((n,), value, dtype=torch.bool, device=dev)

    st = PathState(org=origins, dirn=dirs,
                   weight=torch.ones((n, 3), device=dev), color=zeros3(),
                   alive=flags(True), show_lights=flags(True),
                   show_env=flags(True), had_ss=flags(False), rng=rng_state,
                   normal_aux=zeros3(), albedo_aux=zeros3(),
                   lkey=torch.zeros(n, dtype=torch.int64, device=dev))
    lane_id = torch.arange(n, device=dev)
    live_counts = []
    for depth in range(nb_bounces):
        n_live = st.alive.sum()
        live_counts.append(n_live)
        if compact_rays and depth > 0:
            m = int(n_live)
            if m:
                st = st.with_prefix(_bounce(sc, depth, st.take(slice(0, m)),
                                            cp_r12[:m]))
        else:
            st = _bounce(sc, depth, st, cp_r12)
        if sort_rays and depth + 1 < nb_bounces:
            st, cp_r12, lane_id = _sort_wavefront(st, cp_r12, lane_id)
    out = (st.color, st.normal_aux, st.albedo_aux)
    if sort_rays and nb_bounces > 1:
        inv = torch.empty_like(lane_id)
        inv[lane_id] = torch.arange(n, device=dev)
        out = tuple(x[inv] for x in out)
    return out + (live_counts,)
