"""MAC-grid fluid simulator (counterpart of pathtracer_tpu/sim/fluid.py;
reference Fluid, fluid.h:91-997).

Staggered MAC velocities, solid cells rasterized from the scene (mesh
solids by the reference's double-ray inside test through the port's
`scene.intersect`), semi-Lagrangian advection, gravity, a matrix-free
Jacobi-preconditioned CG pressure solve with solid and air boundaries,
jump-flooding velocity extrapolation, RK4 particle advection and
per-frame particle snapshots.  Each step is vectorized torch code on the
state's device; the CG loop runs on the host with JAX's stopping test,
one synchronisation per iteration.

Cell types follow the reference: 0 = air, 1 = fluid, 2 = solid.

Every division by a constant divides by a 0-d tensor on the state's
device, never by a Python number (a CUDA kernel multiplies by the
reciprocal of a host scalar), so the card and the CPU compute the same
bits everywhere but in the reductions (the CG's dot products).

`_jfa_nearest` differs from JAX at one cell: JAX squares its int32 far
sentinel, which wraps to distance 0 at cell (0, 0, 0), so an invalid
corner keeps the sentinel and its gather clamps; the port computes the
distances in int64, and the corner gets its nearest valid site.  Every
such corner face lies on the domain boundary, which pressure_update
zeroes, so a substep's result does not carry the difference.

CG_LOG: a list here receives, per pressure solve, {'iters', 'residual'}
(the final ||r||) (off: None).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod

AIR, FLUID, SOLID = 0, 1, 2
GRAVITY = 9.81

CG_LOG = None


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    lo: tuple                 # extent min
    hi: tuple
    nx: int = 32
    ny: int = 32
    nz: int = 32
    dt: float = 0.02
    nsubsteps: int = 1
    rho: float = 1.0
    cg_iters: int = 400
    cg_tol: float = 1e-5

    @property
    def dx(self):
        return tuple((h - l) / n for l, h, n in
                     zip(self.lo, self.hi, (self.nx, self.ny, self.nz)))


class FluidState(NamedTuple):
    velx: torch.Tensor       # (nz, ny, nx+1)
    vely: torch.Tensor       # (nz, ny+1, nx)
    velz: torch.Tensor       # (nz+1, ny, nx)
    celltypes: torch.Tensor  # (nz, ny, nx) int8
    particles: torch.Tensor  # (P, 3) world positions


def _vec3(x, dev):
    return torch.tensor([float(v) for v in x], dtype=torch.float32,
                        device=dev)


def _pad(x, value):
    """x padded by one cell on every side with `value`."""
    out = torch.full(tuple(s + 2 for s in x.shape), value, dtype=x.dtype,
                     device=x.device)
    out[1:-1, 1:-1, 1:-1] = x
    return out


def init_state(cfg: FluidConfig, particles, solid_mask=None,
               device=None) -> FluidState:
    """particles: (P,3); solid_mask: (nz,ny,nx) bool or None; on `device`
    (None: the card)."""
    dev = device_mod.resolve(device)
    ct = torch.zeros((cfg.nz, cfg.ny, cfg.nx), dtype=torch.int8, device=dev)
    if solid_mask is not None:
        ct = torch.where(torch.as_tensor(np.asarray(solid_mask), device=dev),
                         torch.tensor(SOLID, dtype=torch.int8, device=dev), ct)
    return FluidState(
        velx=torch.zeros((cfg.nz, cfg.ny, cfg.nx + 1), device=dev),
        vely=torch.zeros((cfg.nz, cfg.ny + 1, cfg.nx), device=dev),
        velz=torch.zeros((cfg.nz + 1, cfg.ny, cfg.nx), device=dev),
        celltypes=ct,
        particles=torch.as_tensor(np.asarray(particles, np.float32),
                                  device=dev))


def seed_box(cfg: FluidConfig, box_lo, box_hi, n_particles, seed=0):
    """Particles seeded uniformly in a box (init_particles,
    fluid.h:247-364)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(box_lo)
    hi = np.asarray(box_hi)
    return (rng.uniform(0, 1, (n_particles, 3)) * (hi - lo) + lo
            ).astype(np.float32)


def rasterize_solids(cfg: FluidConfig, objects, device=None) -> np.ndarray:
    """Solid-cell mask from the scene's objects past the light and the
    dome: spheres |p - c| < r, planes below the surface, meshes by the
    double-ray inside test (fluid.h:120-139, `cells_inside_object`, cast
    on `device`)."""
    from ..scene import scene as scn
    p = _cell_centers(cfg)
    solid = np.zeros(p.shape[:3], bool)
    for i, o in enumerate(objects):
        if i < 2:
            continue
        tr = np.asarray(o.translation, np.float32)
        if o.obj_type == scn.SPHERE and not o.flip_normals:
            c = np.asarray(o.center) + tr
            solid |= np.sum((p - c) ** 2, -1) < float(o.radius) ** 2
        elif o.obj_type == scn.PLANE:
            a = np.asarray(o.center) + tr
            n = np.asarray(o.normal)
            solid |= np.sum((p - a) * n, -1) < 0
        elif o.obj_type == scn.MESH and o.mesh_data is not None:
            inside, _ = cells_inside_object(cfg, objects, i, device=device)
            solid |= inside
    return solid


def _sample_face_vel(cfg, st, p):
    """Trilinear staggered-grid velocity at world points p (N,3)."""
    dev = p.device
    g = (p - _vec3(cfg.lo, dev)) / _vec3(cfg.dx, dev)

    def tri(vol, gx, gy, gz):
        nzv, nyv, nxv = vol.shape
        x = torch.clamp(gx, 0.0, nxv - 1.001)
        y = torch.clamp(gy, 0.0, nyv - 1.001)
        z = torch.clamp(gz, 0.0, nzv - 1.001)
        x0 = x.to(torch.int32)
        y0 = y.to(torch.int32)
        z0 = z.to(torch.int32)
        fx, fy, fz = x - x0, y - y0, z - z0
        x0, y0, z0 = x0.long(), y0.long(), z0.long()

        def at(dzc, dyc, dxc):
            return vol[z0 + dzc, y0 + dyc, x0 + dxc]
        return ((at(0, 0, 0) * (1 - fx) + at(0, 0, 1) * fx) * (1 - fy)
                + (at(0, 1, 0) * (1 - fx) + at(0, 1, 1) * fx) * fy) * (1 - fz) \
            + ((at(1, 0, 0) * (1 - fx) + at(1, 0, 1) * fx) * (1 - fy)
               + (at(1, 1, 0) * (1 - fx) + at(1, 1, 1) * fx) * fy) * fz

    vx = tri(st.velx, g[:, 0], g[:, 1] - 0.5, g[:, 2] - 0.5)
    vy = tri(st.vely, g[:, 0] - 0.5, g[:, 1], g[:, 2] - 0.5)
    vz = tri(st.velz, g[:, 0] - 0.5, g[:, 1] - 0.5, g[:, 2])
    return torch.stack([vx, vy, vz], dim=-1)


def _face_centers(cfg, axis, dev):
    lo = _vec3(cfg.lo, dev)
    dx = _vec3(cfg.dx, dev)
    shape = {0: (cfg.nz, cfg.ny, cfg.nx + 1),
             1: (cfg.nz, cfg.ny + 1, cfg.nx),
             2: (cfg.nz + 1, cfg.ny, cfg.nx)}[axis]
    zz, yy, xx = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=dev) for n in shape),
        indexing='ij')
    off = [0.5, 0.5, 0.5]
    off[axis] = 0.0
    return torch.stack([lo[0] + (xx + off[0]) * dx[0],
                        lo[1] + (yy + off[1]) * dx[1],
                        lo[2] + (zz + off[2]) * dx[2]], dim=-1)


def advect(cfg: FluidConfig, st: FluidState) -> FluidState:
    """Semi-Lagrangian face-velocity advection (fluid.h:394-461)."""
    def one(axis, vol):
        fc = _face_centers(cfg, axis, vol.device).reshape(-1, 3)
        v = _sample_face_vel(cfg, st, fc)
        back = fc - cfg.dt * v
        return _sample_face_vel(cfg, st, back)[:, axis].reshape(vol.shape)

    return st._replace(velx=one(0, st.velx), vely=one(1, st.vely),
                       velz=one(2, st.velz))


def add_forces(cfg: FluidConfig, st: FluidState) -> FluidState:
    """Gravity on the y faces (fluid.h:763-772)."""
    return st._replace(vely=st.vely - GRAVITY * cfg.dt)


def _neighbor_counts(ct):
    """Per-cell diagonal of the Poisson operator: non-solid neighbours
    (the domain boundary counts as solid)."""
    p = _pad(ct == SOLID, True)
    f32 = torch.float32
    return ((~p[:-2, 1:-1, 1:-1]).to(f32)
            + (~p[2:, 1:-1, 1:-1]).to(f32)
            + (~p[1:-1, :-2, 1:-1]).to(f32)
            + (~p[1:-1, 2:, 1:-1]).to(f32)
            + (~p[1:-1, 1:-1, :-2]).to(f32)
            + (~p[1:-1, 1:-1, 2:]).to(f32))


def _apply_A(ct, x, diag=None):
    """Matrix-free Poisson operator with solid and air boundaries (applyA,
    fluid.h:510-597): Neumann at solids, Dirichlet 0 at air.  `diag` is
    _neighbor_counts(ct) when the caller has it."""
    fluid = ct == FLUID
    if diag is None:
        diag = _neighbor_counts(ct)
    zero = torch.zeros((), device=x.device)
    xp = _pad(torch.where(fluid, x, zero), 0.0)
    fp = _pad(fluid, False)
    nb = (torch.where(fp[:-2, 1:-1, 1:-1], xp[:-2, 1:-1, 1:-1], zero)
          + torch.where(fp[2:, 1:-1, 1:-1], xp[2:, 1:-1, 1:-1], zero)
          + torch.where(fp[1:-1, :-2, 1:-1], xp[1:-1, :-2, 1:-1], zero)
          + torch.where(fp[1:-1, 2:, 1:-1], xp[1:-1, 2:, 1:-1], zero)
          + torch.where(fp[1:-1, 1:-1, :-2], xp[1:-1, 1:-1, :-2], zero)
          + torch.where(fp[1:-1, 1:-1, 2:], xp[1:-1, 1:-1, 2:], zero))
    return torch.where(fluid, diag * x - nb, zero)


def _divergence(cfg, st):
    dx = _vec3(cfg.dx, st.velx.device)
    return ((st.velx[:, :, 1:] - st.velx[:, :, :-1]) / dx[0]
            + (st.vely[:, 1:, :] - st.vely[:, :-1, :]) / dx[1]
            + (st.velz[1:, :, :] - st.velz[:-1, :, :]) / dx[2])


def pressure_solve(cfg: FluidConfig, st: FluidState):
    """Jacobi-preconditioned CG (conjGrad, fluid.h:693-761), iterating
    while fewer than cfg.cg_iters iterations ran and sum(r*r) > cg_tol^2
    (the float32 test JAX's while_loop makes).  Returns (pressure,
    final ||r||_2), so a caller sees when the iteration cap bit."""
    ct = st.celltypes
    fluid = ct == FLUID
    zero = torch.zeros((), device=ct.device)
    rhs = torch.where(fluid, -_divergence(cfg, st)
                      * (cfg.rho * cfg.dx[0] * cfg.dx[0] / cfg.dt), zero)
    counts = _neighbor_counts(ct)
    minv = torch.where(fluid, 1.0 / torch.clamp_min(counts, 1.0), zero)
    x = torch.zeros_like(rhs)
    r = rhs
    z = minv * r
    p = z
    rz = (r * z).sum()
    tol2 = float(np.float32(cfg.cg_tol ** 2))
    it = 0
    while it < cfg.cg_iters and float((r * r).sum()) > tol2:
        ap = _apply_A(ct, p, counts)
        denom = (p * ap).sum()
        alpha = rz / torch.where(denom.abs() > 1e-30, denom, 1.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz.abs() > 1e-30, rz, 1.0)
        p = z + beta * p
        rz = rz_new
        it += 1
    res = torch.sqrt((r * r).sum())
    if CG_LOG is not None:
        CG_LOG.append(dict(iters=it, residual=float(res)))
    return x, res


def pressure_update(cfg: FluidConfig, st: FluidState, p) -> FluidState:
    """Subtract the pressure gradient from the faces (fluid.h:463-508);
    faces touching solids or the domain boundary are zeroed."""
    ct = st.celltypes
    zero = torch.zeros((), device=ct.device)
    scale = cfg.dt / (cfg.rho * cfg.dx[0])
    pf = _pad(torch.where(ct == FLUID, p, zero), 0.0)
    sp = _pad(ct == SOLID, True)

    gx = pf[1:-1, 1:-1, 1:] - pf[1:-1, 1:-1, :-1]
    velx = st.velx - scale * gx
    velx = torch.where(sp[1:-1, 1:-1, 1:] | sp[1:-1, 1:-1, :-1], zero, velx)

    gy = pf[1:-1, 1:, 1:-1] - pf[1:-1, :-1, 1:-1]
    vely = st.vely - scale * gy
    vely = torch.where(sp[1:-1, 1:, 1:-1] | sp[1:-1, :-1, 1:-1], zero, vely)

    gz = pf[1:, 1:-1, 1:-1] - pf[:-1, 1:-1, 1:-1]
    velz = st.velz - scale * gz
    velz = torch.where(sp[1:, 1:-1, 1:-1] | sp[:-1, 1:-1, 1:-1], zero, velz)
    return st._replace(velx=velx, vely=vely, velz=velz)


def _face_valid(st: FluidState):
    """Per axis, the faces next to a fluid cell."""
    fp = _pad(st.celltypes == FLUID, False)
    return (fp[1:-1, 1:-1, :-1] | fp[1:-1, 1:-1, 1:],
            fp[1:-1, :-1, 1:-1] | fp[1:-1, 1:, 1:-1],
            fp[:-1, 1:-1, 1:-1] | fp[1:, 1:-1, 1:-1])


def extrapolate(cfg: FluidConfig, st: FluidState, sweeps: int = 8):
    """Spread velocities from the fluid's faces outward by `sweeps`
    averaging sweeps (the bounded variant of the reference's
    extrapolation, fluid.h:142-245)."""
    def run(vol, valid):
        v, val = vol, valid
        zero = torch.zeros((), device=v.device)
        for _ in range(sweeps):
            vp = _pad(v, 0.0)
            valp = _pad(val, False)
            s = torch.zeros_like(v)
            c = torch.zeros_like(v)
            for dz, dy, dxx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                                (0, 0, 1), (0, 0, -1)):
                sl = np.s_[1 + dz:vp.shape[0] - 1 + dz or None,
                           1 + dy:vp.shape[1] - 1 + dy or None,
                           1 + dxx:vp.shape[2] - 1 + dxx or None]
                s = s + torch.where(valp[sl], vp[sl], zero)
                c = c + valp[sl].to(torch.float32)
            newv = torch.where(val, v, torch.where(
                c > 0, s / torch.clamp_min(c, 1.0), v))
            val = val | (c > 0)
            v = newv
        return v

    vx, vy, vz = _face_valid(st)
    return st._replace(velx=run(st.velx, vx), vely=run(st.vely, vy),
                       velz=run(st.velz, vz))


def move_particles(cfg: FluidConfig, st: FluidState) -> torch.Tensor:
    """RK4 particle advection clamped to the extent (fluid.h:846-872)."""
    p = st.particles
    k1 = _sample_face_vel(cfg, st, p)
    k2 = _sample_face_vel(cfg, st, p + 0.5 * cfg.dt * k1)
    k3 = _sample_face_vel(cfg, st, p + 0.5 * cfg.dt * k2)
    k4 = _sample_face_vel(cfg, st, p + cfg.dt * k3)
    newp = p + (cfg.dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    lo = _vec3(cfg.lo, p.device) + 1e-4
    hi = _vec3(cfg.hi, p.device) - 1e-4
    return torch.clamp(newp, lo, hi)


def reclassify(cfg: FluidConfig, st: FluidState) -> FluidState:
    """Marker-cell update (fluid.h:889-913): clear the fluid cells, mark
    the cells holding particles (rounding half to even, as jnp.round)."""
    dev = st.celltypes.device
    air = torch.tensor(AIR, dtype=torch.int8, device=dev)
    ct = torch.where(st.celltypes == FLUID, air, st.celltypes)
    g = torch.round((st.particles - _vec3(cfg.lo, dev))
                    / _vec3(cfg.dx, dev) - 0.5).to(torch.int32)
    gx = torch.clamp(g[:, 0], 0, cfg.nx - 1).long()
    gy = torch.clamp(g[:, 1], 0, cfg.ny - 1).long()
    gz = torch.clamp(g[:, 2], 0, cfg.nz - 1).long()
    mark = torch.zeros(ct.shape, dtype=torch.bool, device=dev)
    mark.index_put_((gz, gy, gx), torch.ones((), dtype=torch.bool,
                                             device=dev))
    ct = torch.where(mark & (ct == AIR),
                     torch.tensor(FLUID, dtype=torch.int8, device=dev), ct)
    return st._replace(celltypes=ct)


def substep(cfg: FluidConfig, st: FluidState) -> FluidState:
    """One timestep (Fluid::timestep, fluid.h:874-938), with the
    jump-flooding extrapolation."""
    st = advect(cfg, st)
    st = extrapolate_jfa(cfg, st)
    st = add_forces(cfg, st)
    p, _res = pressure_solve(cfg, st)
    st = pressure_update(cfg, st, p)
    st = st._replace(particles=move_particles(cfg, st))
    return reclassify(cfg, st)


def run(cfg: FluidConfig, st: FluidState, nb_frames: int):
    """Simulate nb_frames of cfg.nsubsteps substeps; returns (state,
    per-frame particle snapshots as numpy arrays, the first the input)
    (the reference's particles[frame], fluid.h:940-957)."""
    frames = [st.particles.cpu().numpy()]
    for _ in range(nb_frames):
        for _ in range(cfg.nsubsteps):
            st = substep(cfg, st)
        frames.append(st.particles.cpu().numpy())
    return st, frames


# ---- shape-based authoring (init_particles(initwithshape)) ----

_SHAPE_DIR = np.asarray([0.5, 0.0, 0.5], np.float32) / np.sqrt(0.5)


def _cell_centers(cfg: FluidConfig) -> np.ndarray:
    xs = np.linspace(0, 1, cfg.nx, endpoint=False) + 0.5 / cfg.nx
    ys = np.linspace(0, 1, cfg.ny, endpoint=False) + 0.5 / cfg.ny
    zs = np.linspace(0, 1, cfg.nz, endpoint=False) + 0.5 / cfg.nz
    lo = np.asarray(cfg.lo)
    hi = np.asarray(cfg.hi)
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing='ij')
    return np.stack([lo[0] + xx * (hi[0] - lo[0]),
                     lo[1] + yy * (hi[1] - lo[1]),
                     lo[2] + zz * (hi[2] - lo[2])], axis=-1)


def cells_inside_object(cfg: FluidConfig, objects, index: int, seed=0,
                        device=None):
    """Inside mask and per-cell Kd for one object by the reference's
    double-ray cast (fluid.h:247-307): from each cell centre cast the
    fixed direction (0.5,0,0.5)/|.| both ways; the cell is inside iff both
    rays hit the object, the + hit exiting (n.dir > 0) and the - hit
    entering seen from inside (n.dir < 0).  Cell colour: Kd of the nearer
    hit, refined by 5 random double casts keeping the nearest hit's Kd.
    The casts go through `scene.intersect` on a scene of the light, the
    dome and the object alone (built on `device`, None: the card), with
    every mesh's backface cull off: the rays start inside the shape."""
    from ..scene import scene as scn
    iso = scn.build_scene([objects[0], objects[1], objects[index]], 1.0,
                          device=device)
    iso = iso.replace(meshes=tuple(dataclasses.replace(m, backface_cull=False)
                                   for m in iso.meshes))
    row = 2
    centers = _cell_centers(cfg).reshape(-1, 3)
    n = centers.shape[0]
    o = torch.as_tensor(centers.astype(np.float32), device=iso.device)
    rng = np.random.default_rng(seed)

    def cast(d):
        dirs = torch.as_tensor(np.asarray(d, np.float32),
                               device=iso.device).expand(n, 3).contiguous()
        h = scn.intersect(iso, o, dirs)
        on = h.hit & (h.obj_id == row)
        return (on.cpu().numpy(), h.t.cpu().numpy(), h.n.cpu().numpy(),
                h.kd.cpu().numpy())

    d0 = _SHAPE_DIR
    on1, t1, n1, kd1 = cast(d0)
    on2, t2, n2, kd2 = cast(-d0)
    inside = (on1 & on2 & (np.sum(n1 * d0, -1) > 0)
              & (np.sum(n2 * d0, -1) < 0))
    mint = np.where(t1 <= t2, t1, t2)
    col = np.where((t1 <= t2)[:, None], kd1, kd2)
    for _ in range(5):
        rd = rng.uniform(-0.5, 0.5, 3)
        rd /= np.linalg.norm(rd)
        ona, ta, _, kda = cast(rd.astype(np.float32))
        onb, tb, _, kdb = cast(-rd.astype(np.float32))
        for onx, tx, kx in ((ona, ta, kda), (onb, tb, kdb)):
            better = onx & (tx < mint)
            mint = np.where(better, tx, mint)
            col = np.where(better[:, None], kx, col)
    shape = (cfg.nz, cfg.ny, cfg.nx)
    return inside.reshape(shape), col.reshape(shape + (3,))


def seed_from_object(cfg: FluidConfig, objects, index: int,
                     n_particles: int, seed=0, device=None):
    """Particles seeded in an object's shape with per-particle colours
    (init_particles(initwithshape=true), fluid.h:247-364): about
    n_particles, accepted per inside cell at random as the reference
    does.  Returns (particles (P,3), colours (P,3)), float32 numpy."""
    inside, cellcol = cells_inside_object(cfg, objects, index, seed=seed,
                                          device=device)
    rng = np.random.default_rng(seed + 1)
    idx = np.argwhere(inside)                       # (M, 3) z,y,x
    m = len(idx)
    if m == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    per = n_particles / m
    iper = int(np.ceil(per))
    cand = np.repeat(idx, iper, axis=0)
    accept = rng.uniform(0, 1, len(cand)) <= per / iper
    cells = cand[accept]
    jitter = rng.uniform(0, 1, (len(cells), 3))
    lo = np.asarray(cfg.lo)
    dx = np.asarray(cfg.dx)
    pos = (lo + (cells[:, ::-1] + jitter) * dx).astype(np.float32)
    cols = cellcol[cells[:, 0], cells[:, 1], cells[:, 2]].astype(np.float32)
    return pos, cols


# ---- jump-flooding velocity extrapolation (fluid.h:142-245) ----

_FAR = -(1 << 20)


def _shifted(arr, dz, dy, dxx):
    """arr rolled by (dz, dy, dxx) with the wrapped-in border set to the
    far sentinel (JAX's roll and border overwrite)."""
    out = torch.full_like(arr, _FAR)
    dst, src = [], []
    for k in (dz, dy, dxx):
        if k > 0:
            dst.append(slice(k, None))
            src.append(slice(None, -k))
        elif k < 0:
            dst.append(slice(None, k))
            src.append(slice(-k, None))
        else:
            dst.append(slice(None))
            src.append(slice(None))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _jfa_nearest(valid):
    """Flat index of the nearest valid cell per cell by jump flooding (the
    reference's jfa(): halving steps, 27-neighbourhood, squared grid
    distance), distances in int64 (see the module docstring).  valid:
    (A,B,C) bool.  Returns (A,B,C) int64, negative only if no cell is
    valid."""
    a, b, c = valid.shape
    dev = valid.device
    zz, yy, xx = torch.meshgrid(*(torch.arange(n, device=dev)
                                  for n in (a, b, c)), indexing='ij')
    far = torch.tensor(_FAR, device=dev)
    sz = torch.where(valid, zz, far)
    sy = torch.where(valid, yy, far)
    sx = torch.where(valid, xx, far)

    def dist(cz, cy, cx):
        ez, ey, ex = cz - zz, cy - yy, cx - xx
        return ez * ez + ey * ey + ex * ex

    def step(sz, sy, sx, k):
        best_d = dist(sz, sy, sx)
        for dz in (-k, 0, k):
            for dy in (-k, 0, k):
                for dxx in (-k, 0, k):
                    if dz == dy == dxx == 0:
                        continue
                    cz = _shifted(sz, dz, dy, dxx)
                    cy = _shifted(sy, dz, dy, dxx)
                    cx = _shifted(sx, dz, dy, dxx)
                    d = dist(cz, cy, cx)
                    win = d < best_d
                    best_d = torch.where(win, d, best_d)
                    sz = torch.where(win, cz, sz)
                    sy = torch.where(win, cy, sy)
                    sx = torch.where(win, cx, sx)
        return sz, sy, sx

    k = max(a, b, c) // 2
    while k >= 1:
        sz, sy, sx = step(sz, sy, sx, k)
        k //= 2
    sz, sy, sx = step(sz, sy, sx, 1)
    return sz * (b * c) + sy * c + sx


def extrapolate_jfa(cfg: FluidConfig, st: FluidState) -> FluidState:
    """Nearest-neighbour velocity extrapolation by jump flooding
    (NNextrapolate, fluid.h:237-245): every face takes the velocity of the
    nearest face next to the fluid, at any distance."""
    def run(vol, valid):
        site = _jfa_nearest(valid).clamp(0, vol.numel() - 1)
        filled = vol.reshape(-1)[site.reshape(-1)].reshape(vol.shape)
        return torch.where(valid, vol, filled)

    vx, vy, vz = _face_valid(st)
    return st._replace(velx=run(st.velx, vx), vely=run(st.vely, vy),
                       velz=run(st.velz, vz))
