"""Wavefront path integrator (counterpart of pathtracer_tpu/render/integrator.py).

Every path in flight is a lane of (N,) / (N,3) tensors; the bounce loop is
bounce-major and branch divergence (miss / dome / light / mirror / refract /
diffuse / fog / subsurface / ghost) is lane masking.  Each path owns a
PCG32 stream; the canonical draw order, with gated draws leaving a lane's
stream untouched:

    camera:      dx, dy, dx_aperture, dy_aperture      (4 draws, renderer)
    per bounce:  subsurface-entry RR u       (diffuse subsurface lanes)
                 on take_ss: radius, angle, axis u, [offset u, tangent
                 axes], reservoir u          (_subsurface_event)
                 NEE r1, r2                  (diffuse lanes)
                 fog: t, direction choice, u1, u2 (every lane, fog on)
                 Fresnel RR u                (transparent lanes)
                 Phong lobe-choice u         (diffuse Phong lanes that did
                                              not exit a subsurface probe)
                 ghost pass-through RR u     (ghost lanes with both rays)
                 fog RR u                    (lanes with both rays)

The indirect 2D sample is the per-pixel Cranley–Patterson rotation of the
per-sample lattice point, reused at every depth.

Media and compositing: fog integrates the incoming segment (transmittance
on the dome, light and NEE terms, an in-scatter continuation chosen by a
throughput-weighted RR against the surface one); subsurface lanes move to
a disk-probe exit point (scene.reservoir_same_object) and continue with
BRDF Ksub/pi; ghost objects catch shadows and pass rays through; a
background photo replaces primary misses and the dome.

Gradients: the JAX integrator's detached-sampling estimator.  The sampled
indirect direction and its pdf, and the fog RR probability, are detached
where JAX stops their gradient, so with material, light and fog leaves no
ray carries a gradient and the mesh queries, whose kernels have none, see
constant rays (ops/cluster.py); autograd differentiates the NEE weights,
the BRDF values, the light power, the fog weights and transmittance and
the path throughput.  Every step is out of place, compaction included, so
one code path serves rendering and autograd.  The fog keeps every clamp
of the JAX fog, so that no masked lane has an infinite primal (0 * inf
is NaN in the backward of torch.where as of jnp.where).

BRDFs: Phong everywhere, overridden per measured table (`_eval_brdf`) at
the NEE and indirect terms; measured lanes and subsurface exits sample
the cosine lobe, as in JAX.
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
SS_PROBA = float(np.float32(0.6))                      # Raytracer.cpp:318
SS_SIGMA = float(np.float32(1.5))                      # Raytracer.cpp:330
SS_DISK_R = float(np.float32((12.46 ** 0.5) * 1.5))    # Raytracer.cpp:331
BG_SCALE = float(np.float32(196964.699))   # Geometry.h:1355-1362
# a path whose throughput has |w|^2 below this ends (Raytracer.cpp:241);
# a threshold, so the image jumps where a lane crosses it
WEIGHT_CULL = 1e-4
# the disk sample's Gaussian normalization, rounded as numpy rounds JAX's
# expression of it (np.float32 sigma)
GAUSS_NORM = float(1.0 / (np.float32(1.5) * np.float32(1.5) * 2.0 * np.pi))


@dataclasses.dataclass
class PathState:
    org: torch.Tensor          # (N,3)
    dirn: torch.Tensor         # (N,3)
    weight: torch.Tensor       # (N,3) path throughput
    color: torch.Tensor        # (N,3) accumulated radiance
    alive: torch.Tensor        # (N,) bool
    show_lights: torch.Tensor  # (N,) bool — NEE double-count guard
    show_env: torch.Tensor     # (N,) bool
    had_ss: torch.Tensor       # (N,) bool — subsurface re-entry guard
    rng: tuple                 # 4 x (N,) int64 PCG state halves
    normal_aux: torch.Tensor   # (N,3) primary-hit normal (denoiser feed)
    albedo_aux: torch.Tensor   # (N,3)
    lkey: torch.Tensor         # (N,) int64 surface-locality key of the hit
    # per-lane count of reservoir-march overflows; only its sum is read,
    # so the octant sort leaves it unpermuted
    ss_over: torch.Tensor      # (N,) int64

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


def _int_exponential(y0, ysol, beta, s, uy):
    """Optical depth of exponential-height extinction along a segment
    (reference: int_exponential, Raytracer.cpp:20-38), with the small
    |uy * beta| series branch.  The exponents are clamped to +-80, as in
    JAX, so that dome-length segments keep finite primals."""
    small = (uy * beta).abs() < 1e-4
    e1 = torch.clamp(-beta * (y0 - ysol), -80.0, 80.0)
    e2 = torch.clamp(-beta * (y0 + s * uy - ysol), -80.0, 80.0)
    near = torch.exp(e1) * s
    denom = torch.where(small, torch.ones_like(uy), uy * beta)
    far = (torch.exp(e1) - torch.exp(e2)) / denom
    return torch.where(small, near, far)


def _fog_optical_depth(sc, org_y, dir_y, s):
    """alpha * the integral of extinction over [0, s] (Raytracer.cpp:58-63)."""
    if sc.fog_type == 0:
        return sc.fog_absorption * s * 0.05
    return sc.fog_absorption * _int_exponential(
        org_y, sc.ground_level, sc.fog_absorption_decay, s, dir_y)


def _fog_event(sc, org, dirn, seg_t, sample_light_pos, rng_st):
    """Fog in-scattering event for one wavefront of segments (reference:
    fogContribution, Raytracer.cpp:44-192; pallas integrator._fog_event).

    Returns (T, fog_dir, fog_org, fog_weight, fog_valid, rng): the
    segment's transmittance, and the in-scatter continuation ray with its
    weight factor, valid where fog_valid.  Draws (every lane): t-sample,
    direction choice, u1, u2.  The t-sample is equiangular toward the
    light when the light projects ahead (a > 0), else a truncated
    exponential by CDF inversion.  One closest-hit query probes the
    scatter ray for visibility and the light-cone pdf."""
    seg_t = torch.clamp_max(seg_t, 1e6)     # miss lanes: finite primals
    ray_y = dirn[:, 1]
    org_y = org[:, 1]
    int_ext = torch.clamp(_fog_optical_depth(sc, org_y, ray_y, seg_t),
                          -80.0, 80.0)
    transmittance = torch.exp(-int_ext)

    gate = torch.ones_like(seg_t, dtype=torch.bool)
    u_t, rng_st = prng.next_uniform(rng_st, gate=gate)
    u_choice, rng_st = prng.next_uniform(rng_st, gate=gate)
    u1, u2, rng_st = prng.next_uniform2(rng_st, gate=gate)

    clamped_t = torch.clamp_max(seg_t, 1000.0)

    # equiangular t-sampling toward the light (Raytracer.cpp:70-82)
    a = vec.dot(sample_light_pos - org, dirn)
    proj_p = org + a[:, None] * dirn
    dd = torch.sqrt(torch.clamp_min(vec.norm2(sample_light_pos - proj_p),
                                    1e-12))
    theta_a = -torch.atan2(a, dd)
    theta_b = torch.atan2(seg_t - a, dd)
    t_eq = dd * torch.tan((1.0 - u_t) * theta_a + u_t * theta_b)
    p_eq = dd / ((theta_b - theta_a) * (dd * dd + t_eq * t_eq))
    t_eq = t_eq + a

    # truncated-exponential fallback (Raytracer.cpp:89-97), CDF-inverted
    alpha_s = 5.0 / clamped_t
    cdf_max = 1.0 - torch.exp(-alpha_s * clamped_t)
    t_ex = -torch.log(torch.clamp_min(1.0 - u_t * cdf_max, 1e-30)) / alpha_s
    norm_ex = (1.0 / alpha_s) * cdf_max
    p_ex = torch.exp(-alpha_s * t_ex) / norm_ex

    use_eq = a > 0.0
    random_t = torch.where(use_eq, t_eq, t_ex)
    proba_t = torch.where(use_eq, p_eq, p_ex)
    random_t = torch.minimum(torch.clamp_min(random_t, 0.0), seg_t)
    proba_t = torch.clamp(proba_t, 1e-30, 1e30)

    int_ext_part = torch.clamp(
        _fog_optical_depth(sc, org_y, ray_y, random_t), -80.0, 80.0)
    random_p = org + random_t[:, None] * dirn
    above_ground = random_p[:, 1] >= sc.ground_level

    # direction: MIS of the uniform sphere and the cone to the light
    axe_op = vec.normalize(random_p - sc.center_light)
    d_uniform = sampling.random_uniform_sphere(u1, u2)
    d_cos = sampling.random_cos(axe_op, u1, u2)
    point_al = d_cos * sc.radius_light + sc.center_light
    to_light = point_al - random_p
    d_light = vec.normalize(to_light)
    is_uniform = u_choice < 0.5
    random_dir = _where3(is_uniform, d_uniform, d_light)

    # phase function (Raytracer.cpp:129-141)
    mu = vec.dot(random_dir, dirn)
    if sc.fog_phase_type == 0:
        phase = torch.full_like(mu, 1.0 / (4.0 * np.pi))
    elif sc.fog_phase_type == 1:
        k = sc.phase_aniso
        phase = (1.0 - k * k) / (4.0 * np.pi * (1.0 + k * (-mu)))
    else:
        phase = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)

    # visibility and light pdf along the scatter ray (Raytracer.cpp:143-172)
    hit = scn.intersect(sc, random_p, random_dir)
    d_light2 = vec.norm2(to_light)
    vis_block = hit.hit & (hit.t * hit.t < d_light2 * 0.99)
    visible = is_uniform | ~vis_block
    hit_light = hit.hit & (hit.obj_id == 0)
    hit_p = _where3(hit_light, hit.p, random_p + random_dir)
    hit_n = _where3(hit_light, hit.n, -random_dir)
    # area -> solid angle; jac >= 1e-9 keeps a grazing light hit's pdf
    # positive (a negative mixture pdf made fireflies)
    jac = vec.dot(hit_n, -random_dir) / torch.clamp_min(
        vec.norm2(hit_p - random_p), 1e-12)
    jac = torch.clamp_min(jac, 1e-9)
    pdf_light_sa = (vec.dot(vec.normalize(hit_p - sc.center_light), axe_op)
                    / (np.pi * sc.radius_light ** 2) / jac)
    pdf_light = torch.where(hit_light, torch.clamp_min(pdf_light_sa, 0.0),
                            torch.zeros_like(pdf_light_sa))
    proba_dir = 0.5 * (1.0 / (4.0 * np.pi)) + 0.5 * pdf_light

    if sc.fog_type == 0:
        ext = torch.ones_like(random_t) * (sc.fog_density * 0.05)
    else:
        ext = sc.fog_density * torch.exp(torch.clamp(
            -sc.fog_density_decay * (random_p[:, 1] - sc.ground_level),
            -80.0, 80.0))
    fog_w = (phase * ext * torch.exp(-int_ext_part)
             / torch.clamp_min(proba_t * proba_dir, 1e-30))
    fog_valid = (above_ground & visible & (fog_w > 0.0)
                 & torch.isfinite(fog_w))
    return transmittance, random_dir, random_p, fog_w, fog_valid, rng_st


def _subsurface_event(sc, hit, p, nrm, take_ss, rng_st):
    """Disk-probe BSSRDF relocation (reference: Raytracer.cpp:317-406;
    pallas integrator._subsurface_event): a Gaussian disk sample above the
    surface, a probe axis chosen from {-N: 0.5, Tg: 0.25, Tg2: 0.25}, a
    uniformly random intersection with the same object along it, weight
    pdfdisk / max(pdfgauss, 0.05) * chris * (2 | 4) * Ksub / pi.

    Returns (ss_ok, new_p, new_n, new_dir, ss_factor (N,3), probe_ksub,
    rng, probe_overflow (N,) bool).  Draws, all gated on take_ss: radius,
    angle, axis, [offset, on the tangent axes], reservoir."""
    sigma, disk_r = SS_SIGMA, SS_DISK_R
    u_r, rng_st = prng.next_uniform(rng_st, gate=take_ss)
    u_ang, rng_st = prng.next_uniform(rng_st, gate=take_ss)

    integ = 1.0 - np.exp(-disk_r ** 2 / (2.0 * sigma ** 2))
    rand_r = sigma * torch.sqrt(-2.0 * torch.log(
        torch.clamp_min(1.0 - u_r * integ, 1e-30)))
    angle = u_ang * (2.0 * np.pi)
    gx = rand_r * torch.sin(angle)
    gy = rand_r * torch.cos(angle)
    gz = rand_r
    gaussval = (GAUSS_NORM
                * torch.exp(-(gz * gz) / (2.0 * sigma * sigma)))
    pdfgauss = gaussval / integ

    tg = vec.get_tangent(nrm)
    tg2 = vec.cross(nrm, tg)
    pt_above = p + gx[:, None] * tg + gy[:, None] * tg2 + nrm * disk_r

    u_ax, rng_st = prng.next_uniform(rng_st, gate=take_ss)
    h = torch.sqrt(torch.clamp_min(disk_r * disk_r - gz * gz, 0.0))
    subs_org = pt_above + (disk_r - h)[:, None] * (-nrm)
    axis_is_n = u_ax < 0.5
    half = torch.full_like(u_ax, 0.5)
    w_axis = torch.where(axis_is_n, half, torch.full_like(u_ax, 0.25))
    tmax_p = torch.where(axis_is_n, 2.0 * h, 2.0 * gz)
    axis = _where3(axis_is_n, -nrm, _where3(u_ax < 0.75, tg, tg2))
    u_off, rng_st = prng.next_uniform(rng_st, gate=take_ss & ~axis_is_n)
    subs_org = _where3(~axis_is_n & (u_off < 0.5),
                       subs_org - h[:, None] * nrm, subs_org)

    u_res, rng_st = prng.next_uniform(rng_st, gate=take_ss)
    probe = scn.reservoir_same_object(sc, subs_org, axis, tmax_p,
                                      hit.obj_id, u_res)
    ss_ok = take_ss & probe.found

    chris = torch.exp(-vec.norm2(p - probe.p) / (2.0 * sigma * sigma))
    sumpdfs = ((0.5 * vec.dot(probe.n, nrm)) ** 2
               + (0.25 * vec.dot(probe.n, tg)) ** 2
               + (0.25 * vec.dot(probe.n, tg2)) ** 2)
    pdfdisk = w_axis * vec.dot(axis, probe.n).abs() / torch.clamp_min(
        sumpdfs, 1e-20)
    mult = torch.where(axis_is_n, torch.full_like(u_ax, 2.0),
                       torch.full_like(u_ax, 4.0))
    factor = ((pdfdisk / torch.clamp_min(pdfgauss, 0.05) * chris
               * mult)[:, None] * (hit.ksub / M_PI))
    new_dir = vec.normalize(probe.p - p)
    new_p = probe.p + 0.005 * probe.n
    return (ss_ok, new_p, probe.n, new_dir, factor, probe.ksub, rng_st,
            take_ss & probe.overflow)


def _bounce(sc, depth: int, st: PathState, cp_r12, bg_pixel=None
            ) -> PathState:
    """One bounce over every lane of `st`; returns the next state.
    bg_pixel: (N,3) background photo per lane, or None."""
    is_primary = depth == 0
    alive = st.alive & (vec.norm2(st.weight) >= WEIGHT_CULL)
    hit = scn.intersect(sc, st.org, st.dirn)
    p, nrm, ray_dir = hit.p, hit.n, st.dirn
    normal_aux, albedo_aux = st.normal_aux, st.albedo_aux
    if is_primary:
        normal_aux = _where3(hit.hit, nrm, normal_aux)
        albedo_aux = _where3(hit.hit, hit.kd, albedo_aux)

    miss = alive & ~hit.hit
    at_dome = alive & hit.hit & (hit.obj_id == 1)
    at_light = alive & hit.hit & (hit.obj_id == 0)
    at_surface = alive & hit.hit & (hit.obj_id >= 2)
    # background-photo compositing on a primary miss or dome hit
    bg_hit = None
    if bg_pixel is not None and is_primary:
        bg_hit = miss | at_dome
        at_dome = at_dome & ~bg_hit
    is_mirror = at_surface & hit.miroir
    is_transp = at_surface & hit.transp & ~hit.miroir
    is_diffuse = at_surface & ~hit.miroir & ~hit.transp

    # subsurface-entry RR (draws first); rows without a reservoir path
    # opt out (ss_obj_ok), so the estimator stays unbiased
    can_ss = is_diffuse & (vec.norm2(hit.ksub) > 1e-8) & ~st.had_ss
    if sc.ss_obj_ok is not None:
        can_ss = can_ss & sc.ss_obj_ok[hit.obj_id]
    u_ss, rng_st = prng.next_uniform(st.rng, gate=can_ss)
    take_ss = can_ss & (u_ss < SS_PROBA)
    one = torch.ones_like(u_ss)
    subs_w = torch.where(take_ss, one / SS_PROBA,
                         torch.where(can_ss, one / (1.0 - SS_PROBA), one))
    subs_w = subs_w[:, None]
    ss_over = None
    if sc.ss_enabled:
        (ss_ok, ss_p, ss_n, ss_dir, ss_factor, ss_ksub, rng_st,
         ss_over) = _subsurface_event(sc, hit, p, nrm, take_ss, rng_st)
        p = _where3(ss_ok, ss_p, p)
        nrm = _where3(ss_ok, ss_n, nrm)
        ray_dir = _where3(ss_ok, ss_dir, ray_dir)
        subs_w = _where3(ss_ok, subs_w * ss_factor, subs_w)
    else:
        ss_ok = torch.zeros_like(take_ss)
        ss_ksub = hit.ksub

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
        sc, shadow_org, wi,
        torch.where(nee_gate, dist, torch.zeros_like(dist)))
    shadowed = (cos_surf < 0.0) | blocked
    f_brdf = _eval_brdf(sc, hit, wi, -ray_dir, nrm)
    # after a subsurface exit the BRDF is Ksub / pi (Raytracer.cpp:540-544)
    f_brdf = _where3(ss_ok, ss_ksub / M_PI, f_brdf)
    jac = vec.dot(dir_al, -wi) / torch.clamp_min(d_light2, 1e-12)
    proba = vec.dot(axe_op, dir_al) / (M_PI * sc.radius_light
                                       * sc.radius_light)
    nee = (sc.light_power * torch.clamp_min(cos_surf, 0.0) * jac
           / torch.where(proba > 0.0, proba, one))[:, None] * f_brdf * subs_w
    nee_ok = is_diffuse & ~shadowed & (proba > 0.0) & ~hit.ghost

    # fog event on the incoming segment (the ray before any subsurface
    # relocation); diffuse lanes aim the equiangular sample at the NEE
    # light point, the others at the light centre
    if sc.fog_enabled:
        sample_lp = _where3(is_diffuse, point_al,
                            sc.center_light.expand_as(point_al))
        fog_gate = alive & hit.hit
        trans_t, fog_dir, fog_org, fog_w, fog_valid, rng_st = _fog_event(
            sc, st.org, st.dirn, hit.t, sample_lp, rng_st)
        trans_t = torch.where(fog_gate, trans_t, one)[:, None]
        fog_valid = fog_valid & fog_gate

    zero3 = torch.zeros_like(st.color)
    color = st.color
    if bg_hit is not None:
        color = color + _where3(bg_hit, st.weight * bg_pixel, zero3)
    # the fog's transmittance weighs the dome, light and NEE terms, not
    # the emission (Raytracer.cpp:411)
    w_att = trans_t * st.weight if sc.fog_enabled else st.weight
    color = color + _where3(at_dome & st.show_env,
                            w_att * (sc.envmap_intensity * hit.ke), zero3)
    color = color + _where3(at_light & st.show_lights,
                            w_att * sc.light_power, zero3)
    color = color + _where3(at_surface,
                            st.weight * hit.ke * sc.envmap_intensity, zero3)
    color = color + _where3(nee_ok, w_att * nee, zero3)

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

    # diffuse indirect: Phong mixture with the CP-lattice 2D sample;
    # subsurface exits and measured BRDFs sample the cosine lobe and draw
    # no lobe-choice uniform (Raytracer.cpp:584-607, BRDF.h:126-131)
    is_measured = hit.brdf_type > 0
    u_choice, rng_st = prng.next_uniform(
        rng_st, gate=is_diffuse & ~ss_ok & ~is_measured)
    ind_dir, ind_pdf, sampled_diff = brdf.phong_sample(
        hit.kd, hit.ks, hit.ne, -ray_dir, nrm, u_choice,
        cp_r12[:, 0], cp_r12[:, 1])
    use_cos = ss_ok | is_measured
    dir_cos = sampling.random_cos(nrm, cp_r12[:, 0], cp_r12[:, 1])
    ind_dir = _where3(use_cos, dir_cos, ind_dir)
    ind_pdf = torch.where(use_cos, vec.dot(nrm, dir_cos) / M_PI, ind_pdf)
    # detached-sampling estimator: the sampled direction and its pdf are
    # constants (JAX integrator stop_gradient, before `reject`)
    ind_dir, ind_pdf = ind_dir.detach(), ind_pdf.detach()
    reject = ((vec.dot(ind_dir, nrm) < 0.0)
              | (vec.dot(ind_dir, vec.reflect(ray_dir, nrm)) < 0.0)
              | (ind_pdf <= 0.0))
    f_ind = _eval_brdf(sc, hit, ind_dir, -ray_dir, nrm)
    f_ind = _where3(ss_ok, ss_ksub / M_PI, f_ind)
    ind_weight = (st.weight * subs_w * f_ind
                  * (vec.dot(nrm, ind_dir)
                     / torch.where(ind_pdf > 0.0, ind_pdf, one))[:, None])
    ind_org = p + 0.01 * ind_dir

    # ghost objects, compositing catchers (Raytracer.cpp:522-537,
    # :614-631): every continuation resets show_env to true but the two
    # ghost cases below
    new_show_env = torch.ones_like(st.show_env)
    if sc.ghost_enabled:
        is_ghost_surf = is_diffuse & hit.ghost
        if bg_pixel is not None:
            # the ghost's indirect ray carries the photo's colour
            ind_weight = _where3(is_ghost_surf,
                                 ind_weight * bg_pixel / BG_SCALE, ind_weight)
        # the pass-through continuation where the light is visible; the
        # reference pushes it and the indirect ray, one lane RRs 50/50
        ghost_pass = is_ghost_surf & ~shadowed
        both_g = ghost_pass & ~reject
        u_g, rng_st = prng.next_uniform(rng_st, gate=both_g)
        take_pass = ghost_pass & (reject | (both_g & (u_g < 0.5)))
        g_mult = torch.where(both_g, torch.full_like(one, 2.0), one)
        pass_off = _where3(vec.dot(nrm, ray_dir) > 0.0, nrm, -nrm)
        pass_org = p + ray_dir * 0.001 + pass_off * 0.001
        ind_org = _where3(take_pass, pass_org, ind_org)
        ind_dir = _where3(take_pass, ray_dir, ind_dir)
        ind_weight = _where3(take_pass, st.weight * g_mult[:, None],
                             ind_weight * torch.where(is_ghost_surf, g_mult,
                                                      one)[:, None])
        reject = reject & ~take_pass
        # a ghost's indirect ray sees the env map only from shadowed
        # diffuse samples; its pass-through keeps the parent's flag
        new_show_env = torch.where(is_ghost_surf & ~take_pass,
                                   st.show_env & shadowed & sampled_diff,
                                   new_show_env)
        new_show_env = torch.where(take_pass, st.show_env, new_show_env)

    # merge the continuations
    cont_diffuse = is_diffuse & ~reject
    surf_alive = is_mirror | is_transp | cont_diffuse
    new_org = _where3(is_mirror, mirror_org,
                      _where3(is_transp, transp_org, ind_org))
    new_dir = _where3(is_mirror, mirror_dir,
                      _where3(is_transp, transp_dir, ind_dir))
    new_weight = _where3(cont_diffuse, ind_weight, st.weight)
    # diffuse continuations must not re-see the light (NEE dedup); a
    # ghost pass-through keeps the flag
    new_show_lights = st.show_lights & ~cont_diffuse
    if sc.ghost_enabled:
        new_show_lights = torch.where(take_pass, st.show_lights,
                                      new_show_lights)
    new_had_ss = st.had_ss | (ss_ok & cont_diffuse)
    next_alive = surf_alive
    if sc.fog_enabled:
        # one lane carries one ray: RR between the surface continuation and
        # the in-scatter one, with probability by throughput, detached as a
        # sampling decision
        both = surf_alive & fog_valid
        w_surface = new_weight * trans_t
        w_fog = st.weight * fog_w[:, None]
        lum_f = w_fog.abs().sum(dim=-1)
        lum_s = w_surface.abs().sum(dim=-1)
        p_fog = torch.clamp(lum_f / torch.clamp_min(lum_f + lum_s, 1e-30),
                            0.05, 0.95).detach()
        u_rr, rng_st = prng.next_uniform(rng_st, gate=both)
        take_fog = fog_valid & (~surf_alive | (both & (u_rr < p_fog)))
        mult = torch.where(both, torch.where(take_fog, 1.0 / p_fog,
                                             1.0 / (1.0 - p_fog)), one)
        new_weight = _where3(take_fog, w_fog, w_surface) * mult[:, None]
        new_org = _where3(take_fog, fog_org, new_org)
        new_dir = _where3(take_fog, fog_dir, new_dir)
        # the fog branch keeps the parent's show_lights and had_ss and
        # resets show_env to true
        new_show_lights = torch.where(take_fog, st.show_lights,
                                      new_show_lights)
        new_show_env = new_show_env | take_fog
        new_had_ss = torch.where(take_fog, st.had_ss, new_had_ss)
        next_alive = surf_alive | fog_valid
    return PathState(
        org=_where3(next_alive, new_org, st.org),
        dirn=_where3(next_alive, new_dir, st.dirn),
        weight=_where3(next_alive, new_weight, st.weight),
        color=color,
        alive=next_alive,
        show_lights=new_show_lights,
        show_env=new_show_env,
        had_ss=new_had_ss,
        rng=rng_st,
        normal_aux=normal_aux, albedo_aux=albedo_aux,
        lkey=torch.where(hit.hit, hit.lkey, torch.zeros_like(hit.lkey)),
        ss_over=(st.ss_over if ss_over is None
                 else st.ss_over + ss_over.long()),
    )


def _sort_wavefront(st: PathState, cp_r12, bg_pixel, lane_id):
    """Reorder lanes: alive first, grouped by direction octant, then by the
    surface-locality key of the hit they start on (stable, so pixel-tile
    order survives inside each group).  The overflow counter stays
    unpermuted (only its sum is read)."""
    d = st.dirn
    octant = ((d[:, 0] > 0).long() * 4 + (d[:, 1] > 0).long() * 2
              + (d[:, 2] > 0).long())
    key = torch.where(st.alive, (octant << 13) | st.lkey.clamp(0, 8191),
                      torch.full_like(octant, 8 << 13))
    perm = torch.sort(key, stable=True).indices
    ss_over = st.ss_over
    st = st.take(perm)
    st.ss_over = ss_over
    st.lkey = torch.zeros_like(st.lkey)     # recomputed by the next hit
    return (st, cp_r12[perm], None if bg_pixel is None else bg_pixel[perm],
            lane_id[perm])


def trace_paths(sc, origins, dirs, rng_state, cp_r12, nb_bounces: int,
                bg_pixel=None, sort_rays: bool = False,
                compact_rays: bool = False):
    """Trace a wavefront of paths to completion.

    origins, dirs: (N,3) primary rays; rng_state: per-lane PCG streams past
    the camera draws; cp_r12: (N,2) rotated lattice sample; bg_pixel:
    (N,3) background photo per lane (renderer._background_pixels) or
    None.  compact_rays (requires sort_rays) runs bounces after the first
    only on the live prefix: after the alive-first sort, dead lanes sit at
    the tail and a bounce leaves them unchanged, so this is exact.  The
    bounced prefix and the untouched tail make a new state, so autograd
    runs through it.

    Returns (color, normal_aux, albedo_aux, live_counts, ss_overflow):
    live_counts is the list of per-bounce live-lane counts and
    ss_overflow the number of subsurface probes lost to the march's slot
    budget (0-d int64 tensors)."""
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
                   lkey=torch.zeros(n, dtype=torch.int64, device=dev),
                   ss_over=torch.zeros(n, dtype=torch.int64, device=dev))
    lane_id = torch.arange(n, device=dev)
    live_counts = []
    for depth in range(nb_bounces):
        n_live = st.alive.sum()
        live_counts.append(n_live)
        if compact_rays and depth > 0:
            m = int(n_live)
            if m:
                st = st.with_prefix(_bounce(
                    sc, depth, st.take(slice(0, m)), cp_r12[:m],
                    None if bg_pixel is None else bg_pixel[:m]))
        else:
            st = _bounce(sc, depth, st, cp_r12, bg_pixel)
        if sort_rays and depth + 1 < nb_bounces:
            st, cp_r12, bg_pixel, lane_id = _sort_wavefront(
                st, cp_r12, bg_pixel, lane_id)
    out = (st.color, st.normal_aux, st.albedo_aux)
    if sort_rays and nb_bounces > 1:
        inv = torch.empty_like(lane_id)
        inv[lane_id] = torch.arange(n, device=dev)
        out = tuple(x[inv] for x in out)
    return out + (live_counts, st.ss_over.sum())
