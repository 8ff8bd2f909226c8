"""Point sets: XYZ import, kNN normals and radii, disk splats and particle
spheres (counterpart of pathtracer_tpu/scene/pointset.py).

Host code (XYZ parsing, 10-NN PCA normals with scipy's cKDTree, Morton
order, particle clustering) is a copy of the JAX package's numpy code.

Sweeps are torch code.  The brute sweeps (`disk_sweep`, `sphere_sweep`,
`sphere_union_exit`) test every ray against chunks of CHUNK points in
JAX's chunk order with its strict `<` update, so each lane's (t, index)
is what JAX's loop gives; rays are tiled too (RAY_TILE lanes at a time),
since a 1080p ray set against one chunk would be tens of GB of
temporaries.

The clustered tier (fluid particles, `fluid_pointset`): Morton-sorted
particles in CLUSTER_P-particle clusters with radius-inflated boxes; the
mesh tier's dense cull (ops.cluster._dense_cull) emits each 512-ray
packet's MAXC_P nearest clusters, sorted by entry key; the slot sweeps
(`_entry_slots`, `_union_slots`) walk those slots for all packets at
once, each packet stopping where JAX's per-packet while_loop stops (the
early break on the sorted keys); an overflowed packet's unproven lanes
are rerouted, so no hit is dropped.  The sphere roots use exact sqrt and
divide, (-b -+ sqrt(delta)) / a.

Where JAX tests every lane of a packet against a slot's 256 particles,
the port tests only the lanes whose ray enters the box of the cluster's
particles (radius > 0) before the lane's best t (the union walk: across
its exit, or holding its origin), the box padded by BOX_PAD x (1 + its largest
coordinate + its half diagonal + the lane origin's distance to its
centre, capped at PAD_REACH).  The sphere quadratic's discriminant
rounds at the squared distance to the origin, so it reports hits up to
about 1.1e-3 of that distance beside a sphere (5.6e-4 measured); the pad
covers them for origins within about 1,800 units of a cluster, where
each lane's result is JAX's bit for bit.  From farther (a shadow ray from
the dome, 1e6 away), JAX's rounding hits more than about 2 units off the
cluster are not reproduced: JAX itself finds them only when a packet
overflows into its brute reroute, and sweeping every particle for those
lanes costs ten times the wave (ROADMAP Queue 3).  The reroute
(`_reroute_entry`, `_reroute_union`) gives each rerouted lane what the
brute sweep over every particle gives it, (t, index) and the union
walk's 12 passes alike, by the same padded test, sweeping the candidate
clusters in index order with the brute sweep's tie rules, chunk by chunk
for the union walk.  At 1080p a full brute sweep of the rerouted lanes
would test about 10^12 pairs a wave.

SWEEP_LOG: a list here receives, per clustered sweep, {'kind': 'entry' or
'union', 'packets', 'overflowed' (packets whose cull counted more than
MAXC_P clusters), 'residual' (lanes rerouted), 'slots' (packet slot
steps swept), 'pairs' (lane x cluster pairs swept in them)} (off:
None).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import device as device_mod
from ..ops import cluster

BIG_T = float(np.float32(1e30))

# column codes (reference: PointSet.h:53 comment)
COL_IGNORE, COL_X, COL_Y, COL_Z = -1, 0, 1, 2
COL_NX, COL_NY, COL_NZ = 3, 4, 5
COL_R, COL_G, COL_B = 6, 7, 8

CLUSTER_P = 256        # particles per cluster
MAXC_P = 64            # culled cluster slots per packet
CLUSTERED_MIN = 8192   # below this the brute sweep serves the fluid
CHUNK = 4096           # points per brute-sweep chunk (JAX's chunk)
RAY_TILE = 65536       # rays per brute-sweep tile
UNION_EPS = 1e-4
BOX_PAD = 2e-3         # padding of the lane x cluster box tests (_slab)
PAD_REACH = 1000.0     # origin distance beyond which the pad stops growing
LANE_BATCH = 16384     # rerouted lanes per candidate test
PAIR_BATCH = 65536     # lane x cluster pairs per swept batch
REROUTE_FIRST = 8      # nearest candidates a rerouted lane sweeps first
UNION_PASSES = 64      # the clustered union walk's fixed-point cap

SWEEP_LOG = None


def load_xyz(path: str, cols, centered: bool = True):
    """Parse an XYZ file with a column mapping (PointSet.h:52-99).
    Returns (points (P,3), normals (P,3) or zeros, colors (P,3)); colours
    default to (1,1,1)/255 as in the reference."""
    data = np.loadtxt(path, ndmin=2).astype(np.float32)
    ncols = data.shape[1]
    assert len(cols) <= ncols, f"mapping has {len(cols)} cols, file {ncols}"
    p = np.zeros((len(data), 3), np.float32)
    n = np.zeros((len(data), 3), np.float32)
    c = np.full((len(data), 3), 1.0, np.float32)
    for i, code in enumerate(cols):
        if code == COL_IGNORE:
            continue
        if code <= COL_Z:
            p[:, code] = data[:, i]
        elif code <= COL_NZ:
            n[:, code - 3] = data[:, i]
        else:
            c[:, code - 6] = data[:, i]
    c = c / 255.0
    if centered and len(p):
        lo, hi = p.min(0), p.max(0)
        s = float(max(hi - lo))
        p = (p - (lo + hi) * 0.5) / s
    return p, n, c


def estimate_normals(points: np.ndarray, k: int = 10):
    """10-NN PCA normals and 0.42 * d6 radii (PointSet.h:125-179)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    dist, idx = tree.query(points, k=k)
    neigh = points[idx]
    center = neigh.mean(axis=1, keepdims=True)
    d = neigh - center
    cov = np.einsum('pki,pkj->pij', d, d)
    _w, v = np.linalg.eigh(cov)                # ascending eigenvalues
    normals = v[:, :, 0].astype(np.float32)    # smallest: the surface normal
    radii = (0.21 * 2.0 * np.maximum(1e-8, dist[:, 5])).astype(np.float32)
    return normals, radii


@dataclasses.dataclass
class PointSetArrays:
    """Device-side point set bound to an object-table row (the JAX
    package's field names; the c_* cluster boxes are None on the brute
    tier)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    radius: torch.Tensor
    colors: torch.Tensor         # (P,3)
    c_lox: Any = None
    c_loy: Any = None
    c_loz: Any = None
    c_hix: Any = None
    c_hiy: Any = None
    c_hiz: Any = None
    obj_row: int = 0
    n_clusters: int = 0
    display_edges: bool = False
    as_spheres: bool = False     # fluid particles; False: oriented disks
    transparent: bool = False    # union-exit walk for interior rays

    @property
    def num_points(self):
        return self.px.shape[0]

    def replace(self, **fields) -> 'PointSetArrays':
        return dataclasses.replace(self, **fields)

    def to(self, dev) -> 'PointSetArrays':
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def bounds(self) -> torch.Tensor:
        """(C, 6) cluster boxes [lo | hi], ops.cluster's layout."""
        return torch.stack([self.c_lox, self.c_loy, self.c_loz, self.c_hix,
                            self.c_hiy, self.c_hiz], dim=1)


def _columns(a, dev):
    a = np.asarray(a, np.float32)
    return [torch.as_tensor(np.ascontiguousarray(a[:, k]), device=dev)
            for k in range(3)]


def upload_pointset(points, normals, colors, radii, obj_row,
                    display_edges=False, device=None) -> PointSetArrays:
    """Disks on `device` (None: the card); normals are normalized."""
    dev = device_mod.resolve(device)
    n = normals / np.maximum(
        np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    px, py, pz = _columns(points, dev)
    nx, ny, nz = _columns(n, dev)
    return PointSetArrays(
        px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
        radius=torch.as_tensor(np.asarray(radii, np.float32), device=dev),
        colors=torch.as_tensor(np.asarray(colors, np.float32), device=dev),
        obj_row=int(obj_row), display_edges=bool(display_edges))


def make_pointset(path_or_points, cols=None, obj_row=0, normals=None,
                  colors=None, centered=True, display_edges=False,
                  device=None) -> PointSetArrays:
    """Load, estimate and upload in one step (PointSet::init)."""
    if isinstance(path_or_points, str):
        pts, nrm, col = load_xyz(path_or_points, cols or [0, 1, 2], centered)
    else:
        pts = np.asarray(path_or_points, np.float32)
        nrm = np.zeros_like(pts) if normals is None else np.asarray(normals)
        col = (np.full((len(pts), 3), 1 / 255, np.float32) if colors is None
               else np.asarray(colors, np.float32))
    if not nrm.any():
        nrm, radii = estimate_normals(pts)
    else:
        _, radii = estimate_normals(pts)   # radii still from kNN spacing
    return upload_pointset(pts, nrm, col, radii, obj_row, display_edges,
                           device=device)


# ---------------------------------------------------------------------------
# Particle clusters (host)
# ---------------------------------------------------------------------------

def _spread_bits(x):
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def morton_order(points: np.ndarray) -> np.ndarray:
    """Spatial sort order by 30-bit Morton code."""
    p = np.asarray(points, np.float64)
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint32)
    code = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))
    return np.argsort(code, kind='stable')


def _cluster_particles(p, radii, normals, colors):
    """Sort by Morton code, pad to a CLUSTER_P multiple (dummies far away),
    return (p, radii, normals, colors, lo (C,3), hi (C,3))."""
    order = morton_order(p)
    p, radii = p[order], radii[order]
    normals, colors = normals[order], colors[order]
    n = len(p)
    pad = (-n) % CLUSTER_P
    if pad:
        p = np.concatenate([p, np.full((pad, 3), 1e9, np.float32)])
        radii = np.concatenate([radii, np.zeros(pad, np.float32)])
        normals = np.concatenate([normals,
                                  np.tile([[0, 1, 0]], (pad, 1))
                                  .astype(np.float32)])
        colors = np.concatenate([colors, np.zeros((pad, 3), np.float32)])
    c = len(p) // CLUSTER_P
    pc = p.reshape(c, CLUSTER_P, 3)
    rc = radii.reshape(c, CLUSTER_P, 1)
    lo = (pc - rc).min(1)
    hi = (pc + rc).max(1)
    return p, radii, normals, colors, lo.astype(np.float32), \
        hi.astype(np.float32)


def fluid_pointset(particles, obj_row=0, radius=0.5, color=(0.4, 0.6, 0.9),
                   clustered=None, device=None) -> PointSetArrays:
    """Fluid-frame particles as a sphere set on `device` (None: the card).
    From CLUSTERED_MIN particles on (or with clustered=True) the particle
    clusters are built; `color` is one colour or one per particle."""
    dev = device_mod.resolve(device)
    p = np.asarray(particles, np.float32)
    n = len(p)
    col = np.broadcast_to(np.asarray(color, np.float32), (n, 3)).copy()
    radii = np.full((n,), radius, np.float32)
    normals = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    if clustered is None:
        clustered = n >= CLUSTERED_MIN
    extra = {}
    if clustered and n:
        p, radii, normals, col, lo, hi = _cluster_particles(
            p, radii, normals, col)
        (c_lox, c_loy, c_loz), (c_hix, c_hiy, c_hiz) = (_columns(lo, dev),
                                                        _columns(hi, dev))
        extra = dict(c_lox=c_lox, c_loy=c_loy, c_loz=c_loz, c_hix=c_hix,
                     c_hiy=c_hiy, c_hiz=c_hiz, n_clusters=len(lo))
    px, py, pz = _columns(p, dev)
    nx, ny, nz = _columns(normals, dev)
    return PointSetArrays(
        px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
        radius=torch.as_tensor(radii, device=dev),
        colors=torch.as_tensor(col, device=dev), obj_row=int(obj_row),
        as_spheres=True, **extra)


# ---------------------------------------------------------------------------
# Brute sweeps
# ---------------------------------------------------------------------------

def _rays(org, dirn):
    return ((org[:, 0:1], org[:, 1:2], org[:, 2:3]),
            (dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]))


def _sphere_roots(o, d, a, sx, sy, sz, sr):
    """delta and the two roots (-b -+ sqrt(delta)) / a of the ray-sphere
    quadratic, in JAX's operation order."""
    ocx = o[0] - sx
    ocy = o[1] - sy
    ocz = o[2] - sz
    b = d[0] * ocx + d[1] * ocy + d[2] * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - sr * sr
    delta = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    return delta, (-b - sq) / a, (-b + sq) / a


def _entry_t(delta, t1, t2):
    """Sphere entry distance (far root from inside), BIG_T on a miss."""
    t = torch.where(t1 > 0, t1, t2)
    ok = (delta >= 0) & (t2 >= 0) & (t > 0)
    return torch.where(ok, t, torch.full_like(t, BIG_T))


def _tiles(n):
    return [slice(i, min(i + RAY_TILE, n)) for i in range(0, n, RAY_TILE)]


def _closest(t, start, best_t, best_i):
    """Fold one chunk's (tile, chunk) t into the running best: first
    minimum of the chunk, kept where strictly below the best."""
    j = t.argmin(dim=-1)
    tj = t.gather(1, j[:, None])[:, 0]
    win = tj < best_t
    return (torch.where(win, tj, best_t),
            torch.where(win, j.to(torch.int32) + start, best_i), win, j)


def sphere_sweep(ps: PointSetArrays, org, dirn, t_max, chunk: int = CHUNK):
    """Closest sphere hit over every point (opaque fluid).  Returns
    (t, index)."""
    n = org.shape[0]
    best_t = t_max.clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    total = ps.num_points
    for rs in _tiles(n):
        o, d = _rays(org[rs], dirn[rs])
        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        bt, bi = best_t[rs], best_i[rs]
        for start in range(0, total, chunk):
            sl = slice(start, min(start + chunk, total))
            delta, t1, t2 = _sphere_roots(o, d, a, ps.px[sl], ps.py[sl],
                                          ps.pz[sl], ps.radius[sl])
            bt, bi, _, _ = _closest(_entry_t(delta, t1, t2), start, bt, bi)
        best_t[rs], best_i[rs] = bt, bi
    return best_t, best_i


def sphere_union_exit(ps: PointSetArrays, org, dirn, chunk: int = CHUNK,
                      iters: int = 12):
    """Exit point of the union of spheres holding the ray origin (the
    transparent fluid's interval walk, fluid.cpp:65-171, as JAX's monotone
    fixed point of `iters` passes).  Returns (t_exit, idx, inside)."""
    n = org.shape[0]
    dev = org.device
    t_exit = torch.zeros((n,), device=dev)
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inside = torch.zeros((n,), dtype=torch.bool, device=dev)
    total = ps.num_points
    for rs in _tiles(n):
        o, d = _rays(org[rs], dirn[rs])
        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        ex, ix, ins = t_exit[rs], idx[rs], inside[rs]
        for it in range(iters):
            for start in range(0, total, chunk):
                sl = slice(start, min(start + chunk, total))
                delta, t1, t2 = _sphere_roots(o, d, a, ps.px[sl], ps.py[sl],
                                              ps.pz[sl], ps.radius[sl])
                ok = (delta >= 0) & (t2 > 0)
                if it == 0:
                    ins = ins | (ok & (t1 < 0)).any(dim=-1)
                ex, ix = _extend(ok, t1, t2, ex, ix, start)
        t_exit[rs], idx[rs], inside[rs] = ex, ix, ins
    return t_exit, idx, inside


def _extend(ok, t1, t2, ex, ix, base):
    """Spheres whose interval straddles the current exit extend it to the
    farthest such exit (first maximum), kept where strictly beyond."""
    e = ex[:, None]
    straddle = ok & (t1 <= e + UNION_EPS) & (t2 > e)
    t2m = torch.where(straddle, t2, torch.full_like(t2, -1.0))
    j = t2m.argmax(dim=-1)
    tj = t2m.gather(1, j[:, None])[:, 0]
    win = tj > ex
    return (torch.where(win, tj, ex),
            torch.where(win, j.to(torch.int32) + base, ix))


def disk_sweep(ps: PointSetArrays, org, dirn, t_max, chunk: int = CHUNK):
    """Closest disk hit (Disk::intersection, Geometry.h:1106-1122): the
    plane hit within the radius.  Returns (t, point index)."""
    n = org.shape[0]
    best_t = t_max.clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    total = ps.num_points
    for rs in _tiles(n):
        (ox, oy, oz), (dx, dy, dz) = _rays(org[rs], dirn[rs])
        bt, bi = best_t[rs], best_i[rs]
        for start in range(0, total, chunk):
            sl = slice(start, min(start + chunk, total))
            cx, cy, cz = ps.px[sl], ps.py[sl], ps.pz[sl]
            nx, ny, nz = ps.nx[sl], ps.ny[sl], ps.nz[sl]
            dn = dx * nx + dy * ny + dz * nz
            t = ((cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz) / dn
            hx = ox + t * dx - cx
            hy = oy + t * dy - cy
            hz = oz + t * dz - cz
            r2 = hx * hx + hy * hy + hz * hz
            r = ps.radius[sl]
            ok = (t > 0.0) & (r2 <= r * r) & ~torch.isnan(t)
            t = torch.where(ok, t, torch.full_like(t, BIG_T))
            bt, bi, _, _ = _closest(t, start, bt, bi)
        best_t[rs], best_i[rs] = bt, bi
    return best_t, best_i


# ---------------------------------------------------------------------------
# Clustered tier
# ---------------------------------------------------------------------------

def _cull_spheres(ps: PointSetArrays, org, dirn, tmax):
    """The mesh tier's dense cull over the particle-cluster boxes with
    MAXC_P slots, over CHUNK_PACKETS-packet chunks as ops.cluster._cull_all
    runs it.  Pads the rays to whole packets.  Returns (ids, count, keys,
    padded org, dirn, tmax)."""
    n = org.shape[0]
    n_pad = -(-n // cluster.BLOCK) * cluster.BLOCK
    org, dirn, tmax, _ = cluster._pad_rays(org.contiguous(), dirn.contiguous(),
                                           tmax.contiguous(),
                                           torch.zeros_like(tmax), n_pad)
    bounds = ps.bounds()
    outs = [cluster._dense_cull(bounds, org[sl], dirn[sl], tmax[sl],
                                maxc=MAXC_P)
            for sl in cluster._chunks(n_pad)]
    ids, count, keys = (torch.cat(x) for x in zip(*outs))
    return ids, count, keys, org, dirn, tmax


def _boxes(ps: PointSetArrays):
    """The clusters' boxes around their particles of radius > 0 (a padded
    cluster's box in `bounds` reaches its dummies at 1e9; a cluster of
    dummies only keeps that box): lo, hi, centre (C,3), and the
    distance-free part of their pad, 1 + the largest |coordinate| + the
    half diagonal (C,)."""
    box = ps.bounds()
    p = torch.stack([ps.px, ps.py, ps.pz], dim=1).view(-1, CLUSTER_P, 3)
    r = ps.radius.view(-1, CLUSTER_P, 1)
    real = r > 0
    inf = torch.tensor(float('inf'), device=p.device)
    lo = torch.where(real, p - r, inf).amin(dim=1)
    hi = torch.where(real, p + r, -inf).amax(dim=1)
    some = real.any(dim=1)
    lo = torch.where(some, lo, box[:, :3])
    hi = torch.where(some, hi, box[:, 3:])
    base = 1.0 + torch.maximum(lo.abs(), hi.abs()).amax(dim=1) \
        + 0.5 * (hi - lo).norm(dim=1)
    return lo, hi, (lo + hi) * 0.5, base


def _slab(o, inv, lo, hi, c, base):
    """Slab entry and exit t of rays (o, 1/d) through boxes [lo, hi], each
    padded by BOX_PAD x (base + min(|o - c|, PAD_REACH)): the computed
    sphere quadratic can report a hit up to about 1.1e-3 |o - centre| off
    a sphere (5.6e-4 measured), since its discriminant rounds at
    |o - centre|^2.
    Broadcasts over the leading dims, coordinates last."""
    reach = torch.clamp_max((o - c).norm(dim=-1), PAD_REACH)
    pad = BOX_PAD * (base + reach)[..., None]
    t1, t2 = (lo - pad - o) * inv, (hi + pad - o) * inv
    return torch.minimum(t1, t2).amax(dim=-1), torch.maximum(t1, t2).amin(
        dim=-1)


def _cluster_rows(ps: PointSetArrays, cid):
    """Clusters `cid` as (n, CLUSTER_P) rows of x, y, z, r."""
    c = cid.long()
    return [v.view(-1, CLUSTER_P)[c] for v in (ps.px, ps.py, ps.pz,
                                                ps.radius)]


def _pair_roots(ps, o, d, a, cid):
    """Sphere roots of lanes (o, d, a: (n,3), (n,3), (n,)) against their
    clusters `cid` (n,): (n, CLUSTER_P) delta, t1, t2."""
    sx, sy, sz, sr = _cluster_rows(ps, cid)
    return _sphere_roots((o[:, 0:1], o[:, 1:2], o[:, 2:3]),
                         (d[:, 0:1], d[:, 1:2], d[:, 2:3]), a[:, None],
                         sx, sy, sz, sr)


def _lane_rays(org, dirn):
    a = dirn[:, 0] * dirn[:, 0] + dirn[:, 1] * dirn[:, 1] \
        + dirn[:, 2] * dirn[:, 2]
    return a, 1.0 / dirn


def _entry_slots(ps: PointSetArrays, ids, keys, org, dirn, tmax):
    """Closest sphere entry over each packet's culled slots
    (_clustered_entry_exec): slot s of a packet is swept while s < MAXC_P
    and its key is below the packet's largest best t, all packets at once.
    A slot's cluster is tested against the lanes whose ray enters its
    padded box before their best t (no other lane can hit one of its
    spheres closer).  Returns (t, index, packet slot steps, lane-cluster
    pairs swept)."""
    nb = org.shape[0] // cluster.BLOCK
    a, inv = _lane_rays(org, dirn)
    lo, hi, ctr, base = _boxes(ps)
    bt = tmax.clone()
    bi = torch.full_like(bt, -1, dtype=torch.int32)
    live = torch.arange(nb, device=org.device)
    steps = pairs = 0
    for s in range(MAXC_P):
        live = live[keys[live, s] < bt.view(nb, -1)[live].amax(dim=1)]
        cid = ids[live, s]
        live, cid = live[cid >= 0], cid[cid >= 0]
        if live.numel() == 0:
            break
        steps += live.numel()
        c = cid.long()
        tmin, tmx = _slab(org.view(nb, -1, 3)[live],
                          inv.view(nb, -1, 3)[live], lo[c][:, None, :],
                          hi[c][:, None, :], ctr[c][:, None, :],
                          base[c][:, None])
        enter = (tmx >= torch.clamp_min(tmin, 0.0)) \
            & (tmin < bt.view(nb, -1)[live])
        pk, ln = enter.nonzero(as_tuple=True)
        lanes, cids = live[pk] * cluster.BLOCK + ln, cid[pk]
        pairs += lanes.numel()
        for p0 in range(0, lanes.numel(), PAIR_BATCH):
            la, c = lanes[p0:p0 + PAIR_BATCH], cids[p0:p0 + PAIR_BATCH]
            t = _entry_t(*_pair_roots(ps, org[la], dirn[la], a[la], c))
            j = t.argmin(dim=1)
            tj = t.gather(1, j[:, None])[:, 0]
            b_t = bt[la]
            win = tj < b_t
            bi[la] = torch.where(win, c * CLUSTER_P + j.to(torch.int32),
                                 bi[la])
            bt[la] = torch.where(win, tj, b_t)
    return bt, bi, steps, pairs


def _union_slots(ps: PointSetArrays, ids, keys, org, dirn):
    """Union-of-spheres exit over each packet's culled slots
    (_clustered_union_exec): passes over the slots (each slot swept while
    its key is within UNION_EPS of the packet's largest exit) until a pass
    extends no lane's exit, at most UNION_PASSES, all packets at once.  A
    slot's cluster is tested against the lanes whose ray enters its padded
    box before their exit + UNION_EPS and leaves it past their exit, or
    whose origin it holds (no other lane holds one of its spheres or can
    be extended by one); from the second pass on, at a slot the previous
    pass swept, only against the lanes whose exit moved at or after that
    slot's test (the others would repeat it).  Returns (exit, index, inside, packet
    slot steps, lane-cluster pairs swept)."""
    nb, blk = org.shape[0] // cluster.BLOCK, cluster.BLOCK
    a, inv = _lane_rays(org, dirn)
    lo, hi, ctr, base = _boxes(ps)
    dev = org.device
    ex = torch.zeros((org.shape[0],), device=dev)
    ix = torch.full_like(ex, -1, dtype=torch.int32)
    ins = torch.zeros_like(ex, dtype=torch.bool)
    moved = torch.full_like(ix, -1)           # step of each lane's last move
    swept = torch.full((nb,), -1, device=dev)  # last slot of the last pass
    outer = torch.arange(nb, device=dev)
    steps = pairs = 0
    for p in range(UNION_PASSES):
        if outer.numel() == 0:
            break
        before = ex.view(nb, -1)[outer]
        last = swept.clone()
        live = outer
        for s in range(MAXC_P):
            live = live[keys[live, s]
                        <= ex.view(nb, -1)[live].amax(dim=1) + UNION_EPS]
            cid = ids[live, s]
            live, cid = live[cid >= 0], cid[cid >= 0]
            if live.numel() == 0:
                break
            steps += live.numel()
            swept[live] = s
            need = (s > last[live])[:, None] \
                | (moved.view(nb, -1)[live] >= (p - 1) * MAXC_P + s)
            pk, ln = need.nonzero(as_tuple=True)
            lanes = live[pk] * blk + ln
            c = cid[pk].long()
            tmin, tmx = _slab(org[lanes], inv[lanes], lo[c], hi[c], ctr[c],
                              base[c])
            e_l = ex[lanes]
            enter = (tmx >= torch.clamp_min(tmin, 0.0)) \
                & (tmin <= e_l + UNION_EPS) & ((tmx > e_l) | (tmin <= 0))
            lanes, cids = lanes[enter], cid[pk][enter]
            pairs += lanes.numel()
            for p0 in range(0, lanes.numel(), PAIR_BATCH):
                la, c = lanes[p0:p0 + PAIR_BATCH], cids[p0:p0 + PAIR_BATCH]
                delta, t1, t2 = _pair_roots(ps, org[la], dirn[la], a[la], c)
                ok = (delta >= 0) & (t2 > 0)
                ins[la] = ins[la] | (ok & (t1 < 0)).any(dim=1)
                e_l, i_l = ex[la], ix[la]
                e = e_l[:, None]
                straddle = ok & (t1 <= e + UNION_EPS) & (t2 > e)
                t2m = torch.where(straddle, t2, torch.full_like(t2, -1.0))
                j = t2m.argmax(dim=1)
                tj = t2m.gather(1, j[:, None])[:, 0]
                win = tj > e_l
                ix[la] = torch.where(win, c * CLUSTER_P + j.to(torch.int32),
                                     i_l)
                ex[la] = torch.where(win, tj, e_l)
                moved[la] = torch.where(win, p * MAXC_P + s, moved[la])
        outer = outer[(ex.view(nb, -1)[outer] > before).any(dim=1)]
    return ex, ix, ins, steps, pairs


def _log(kind, count, res, steps, pairs):
    if SWEEP_LOG is not None:
        SWEEP_LOG.append(dict(kind=kind, packets=int(count.shape[0]),
                              overflowed=int((count[:, 0] > MAXC_P).sum()),
                              residual=int(res.sum()), slots=int(steps),
                              pairs=int(pairs)))


def clustered_sphere_sweep(ps: PointSetArrays, org, dirn, t_max):
    """Closest sphere hit through the particle clusters (opaque fluid,
    fluid.cpp:264-336): cull, slot sweep, and the reroute of the lanes of
    overflowed packets whose best t lies beyond the last kept key (a
    dropped cluster's entry key is at least that key)."""
    n = org.shape[0]
    ids, count, keys, porg, pdirn, ptmax = _cull_spheres(ps, org, dirn,
                                                         t_max)
    bt, bi, steps, pairs = _entry_slots(ps, ids, keys, porg, pdirn, ptmax)
    nb = count.shape[0]
    res = ((count[:, 0] > MAXC_P)[:, None]
           & (bt.view(nb, -1) > keys[:, -1:])).view(-1)[:n]
    bt, bi = bt[:n], bi[:n]
    _log('entry', count, res, steps, pairs)
    lanes = res.nonzero()[:, 0]
    if lanes.numel():
        bt[lanes], bi[lanes] = _reroute_entry(ps, org[lanes], dirn[lanes],
                                              bt[lanes], bi[lanes])
    return bt, bi


def clustered_union_exit(ps: PointSetArrays, org, dirn):
    """Union-of-spheres exit through the particle clusters (transparent
    fluid, fluid.cpp:65-171), the reroute on the lanes of overflowed
    packets whose exit reaches the last kept key."""
    n = org.shape[0]
    big = torch.full((n,), BIG_T, device=org.device)
    ids, count, keys, porg, pdirn, _ = _cull_spheres(ps, org, dirn, big)
    ex, ix, ins, steps, pairs = _union_slots(ps, ids, keys, porg, pdirn)
    nb = count.shape[0]
    res = ((count[:, 0] > MAXC_P)[:, None]
           & (ex.view(nb, -1) + UNION_EPS >= keys[:, -1:])).view(-1)[:n]
    ex, ix, ins = ex[:n], ix[:n], ins[:n]
    _log('union', count, res, steps, pairs)
    lanes = res.nonzero()[:, 0]
    if lanes.numel():
        ex[lanes], ix[lanes], ins[lanes] = _reroute_union(
            ps, org[lanes], dirn[lanes])
    return ex, ix, ins


def _candidates(ps: PointSetArrays, org, dirn, tmax):
    """(lane, cluster) pairs, by lane then cluster index: every cluster
    whose padded box (_slab) the lane's ray enters before its tmax, with
    the pair's slab entry and exit (P, 2)."""
    lo, hi, ctr, base = _boxes(ps)
    lanes, clusters, slabs = [], [], []
    for l0 in range(0, org.shape[0], LANE_BATCH):
        sl = slice(l0, l0 + LANE_BATCH)
        tmin, tmx = _slab(org[sl, None, :], 1.0 / dirn[sl, None, :], lo, hi,
                          ctr, base)
        live = (tmx >= torch.clamp_min(tmin, 0.0)) & (tmin < tmax[sl, None])
        li, ci = live.nonzero(as_tuple=True)
        lanes.append(li + l0)
        clusters.append(ci.to(torch.int32))
        slabs.append(torch.stack([tmin[li, ci], tmx[li, ci]], dim=1))
    return torch.cat(lanes), torch.cat(clusters), torch.cat(slabs)


def _lane_best(n, li, val, idx, init, largest):
    """Per lane, the extreme of the pairs' values (max if `largest`, else
    min) over `init`, and the lowest index among the pairs reaching it;
    -1 where no pair reaches it."""
    best = init.clone().scatter_reduce_(0, li, val,
                                        'amax' if largest else 'amin')
    big = torch.iinfo(torch.int32).max
    at = torch.where(val == best[li], idx, torch.full_like(idx, big))
    first = torch.full((n,), big, dtype=torch.int32, device=val.device)
    first.scatter_reduce_(0, li, at, 'amin')
    return best, torch.where(first == big, -1, first)


def _reroute_entry(ps: PointSetArrays, org, dirn, bt, bi):
    """sphere_sweep(ps, org, dirn, bt) over the candidate clusters only:
    the smallest t below bt and the lowest index reaching it.  Each lane's
    REROUTE_FIRST nearest candidates (by padded entry) go first; a
    candidate entered beyond the best t they give holds no t at or below
    it and is skipped."""
    n = org.shape[0]
    li, ci, slab = _candidates(ps, org, dirn, bt)
    if li.numel() == 0:
        return bt, bi
    a, _ = _lane_rays(org, dirn)
    order = torch.argsort(slab[:, 0], stable=True)
    order = order[torch.argsort(li[order], stable=True)]
    li, ci, entry = li[order], ci[order], slab[order, 0]
    start = torch.searchsorted(li, li, right=False)
    first = torch.arange(li.numel(), device=li.device) - start \
        < REROUTE_FIRST

    def sweep(lanes, clusters):
        t_p, i_p = [], []
        for p0 in range(0, lanes.numel(), PAIR_BATCH):
            la, c = lanes[p0:p0 + PAIR_BATCH], clusters[p0:p0 + PAIR_BATCH]
            t = _entry_t(*_pair_roots(ps, org[la], dirn[la], a[la], c))
            j = t.argmin(dim=1)
            t_p.append(t.gather(1, j[:, None])[:, 0])
            i_p.append(c * CLUSTER_P + j.to(torch.int32))
        return torch.cat(t_p), torch.cat(i_p)

    t1, i1 = sweep(li[first], ci[first])
    best1 = bt.clone().scatter_reduce_(0, li[first], t1, 'amin')
    rest = ~first & (entry <= best1[li])
    lanes, vals, idxs = li[first], t1, i1
    if bool(rest.any()):
        t2, i2 = sweep(li[rest], ci[rest])
        lanes, vals, idxs = (torch.cat([lanes, li[rest]]),
                             torch.cat([vals, t2]), torch.cat([idxs, i2]))
    best, low = _lane_best(n, lanes, vals, idxs, bt, largest=False)
    win = best < bt
    return torch.where(win, best, bt), torch.where(win, low, bi)


def _reroute_union(ps: PointSetArrays, org, dirn, iters: int = 12):
    """sphere_union_exit(ps, org, dirn) over the candidate clusters only:
    its `iters` passes, each over the point chunks in order, a chunk's
    candidate clusters tested against the exit the chunk starts from.  A
    pass that extends no exit of a lane repeats itself in every later
    pass, so the lane leaves the walk."""
    n = org.shape[0]
    dev = org.device
    li, ci, slab = _candidates(ps, org, dirn,
                               torch.full((n,), BIG_T, device=dev))
    a, _ = _lane_rays(org, dirn)
    ex = torch.zeros((n,), device=dev)
    ix = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ins = torch.zeros((n,), dtype=torch.bool, device=dev)
    chunk = ci // (CHUNK // CLUSTER_P)
    order = torch.argsort(chunk, stable=True)
    li, ci, chunk, slab = li[order], ci[order], chunk[order], slab[order]
    for it in range(iters):
        if li.numel() == 0:
            break
        before = ex.clone()
        bounds = torch.searchsorted(chunk, torch.arange(
            int(chunk.max()) + 2, dtype=chunk.dtype, device=dev))
        for b0, b1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            if b1 == b0:
                continue
            # only clusters across the lane's exit can extend it (and, in
            # the first pass, those holding its origin can mark it inside)
            e_p = ex[li[b0:b1]]
            near = (slab[b0:b1, 0] <= e_p + UNION_EPS) \
                & ((slab[b0:b1, 1] > e_p) | ((slab[b0:b1, 0] <= 0) & (it == 0)))
            sel_l, sel_c = li[b0:b1][near], ci[b0:b1][near]
            if sel_l.numel() == 0:
                continue
            vals, idxs = [], []
            for p0 in range(0, sel_l.numel(), PAIR_BATCH):
                la, c = sel_l[p0:p0 + PAIR_BATCH], sel_c[p0:p0 + PAIR_BATCH]
                delta, t1, t2 = _pair_roots(ps, org[la], dirn[la], a[la], c)
                ok = (delta >= 0) & (t2 > 0)
                if it == 0:
                    ins[la[(ok & (t1 < 0)).any(dim=1)]] = True
                e = ex[la][:, None]
                straddle = ok & (t1 <= e + UNION_EPS) & (t2 > e)
                t2m = torch.where(straddle, t2, torch.full_like(t2, -1.0))
                j = t2m.argmax(dim=1)
                vals.append(t2m.gather(1, j[:, None])[:, 0])
                idxs.append(c * CLUSTER_P + j.to(torch.int32))
            best, first = _lane_best(n, sel_l, torch.cat(vals),
                                     torch.cat(idxs),
                                     torch.full((n,), -1.0, device=dev),
                                     largest=True)
            win = best > ex
            ix = torch.where(win, first, ix)
            ex = torch.where(win, best, ex)
        keep = (ex > before)[li]
        li, ci, chunk, slab = li[keep], ci[keep], chunk[keep], slab[keep]
    return ex, ix, ins
