"""Two-level cluster traversal: the big-mesh closest-hit and any-hit tier.

Counterpart of pathtracer_tpu/ops/pallas_cluster.py.  The contracts are
the same; the layouts are the port's own.

  Phase 0, host (`build_clustered`): triangles in global BVH order are cut
  into CLUSTERS at maximal BVH subtrees of <= tris_c triangles (greedy
  SAH-style merge of consecutive ranges), each padded to tris_c and split
  into SUBT-triangle subtiles.  Per triangle the sweep stores its plane
  data recentred on the cluster centroid c: normal n and the inverse-Gram
  edge rows U', V', each with an offset -(a - c)·plane, so that

      t     = -[(o - c)·n + off_n] / (d·n)
      beta  =  [(o - c)·U' + off_U] + t (d·U')
      gamma =  [(o - c)·V' + off_V] + t (d·V')

  Pad and degenerate triangles carry zero planes, so t = 0/0 = NaN, which
  the positive acceptance `t > tmin` rejects.

  Phase 1 (`cluster_cull`): per BLOCK-ray packet, the clusters some lane
  enters, sorted near-first by packet-min slab entry, at most MAXC of
  them, with `count > MAXC` flagging an incomplete emission whose keys
  stay lower bounds.  Up to DENSE_CULL_MAX clusters: below
  HIER_MIN_CLUSTERS the exact dense rectangle in torch (`_dense_cull`),
  above it the two-stage hierarchical cull, a hand-written CUDA kernel
  launched once per round over every packet (`hier_cull`;
  csrc/cluster_hier_cull.cu, in place of the XLA code of
  pallas_cluster._hier_cull), with `_hier_cull` the same function in torch
  for CPU tensors; both optionally with per-cluster unit-normal bounds
  that cull clusters entirely back-facing (exact on closed opaque meshes,
  rays from outside).  Above DENSE_CULL_MAX a hand-written CUDA kernel
  walks the top BVH over the cluster AABBs (`cull_tree`;
  csrc/cluster_cull.cu, which replaces pallas_cluster._cull_kernel), with
  `cull_tree_plain` the same function as an exact rectangle for CPU
  tensors.

  Phase 2, a hand-written CUDA kernel per query (`cluster_sweep`,
  `cluster_sweep_any`; csrc/cluster_sweep.cu): one launch per round over
  every packet; one block per lane group of SWEEP_GROUP rays walks its
  packet's emitted slots in key order, deciding its skips and early break
  from its own lanes, the groups of the packets with the most slots
  first.  The plain PyTorch versions (`cluster_sweep_plain`,
  `cluster_sweep_any_plain`) make the same decisions for the same groups
  and serve CPU tensors.  Both fill the same per-group counters (STATS:
  slots visited, clusters entered, subtile slab tests, subtiles swept;
  the kernel adds its cycles) when given a `stats` tensor.

  Exhaustive windowed rounds (`two_level_hit` / `two_level_any`, up to
  DENSE_CULL_MAX clusters): a packet that overflowed re-culls with its
  merged per-lane best t and an exclusion mask of the clusters already
  swept, MAXC at a time, until no lane is residual — at most
  ceil(C / MAXC) rounds, and no hit is dropped.  Each round culls all its
  packets (on the card above HIER_MIN_CLUSTERS in one hier_cull launch,
  torch code in CHUNK_PACKETS chunks) and sweeps them in one launch.

  Tree tier (`two_level_hit` above DENSE_CULL_MAX, or exhaustive=False):
  one cull + sweep round, then `refine_rounds` re-culls of the packets
  holding residual lanes with their tightened per-lane t; the lanes still
  residual are returned for an exact fallback (traverse.bvh_hit_sparse in
  scene.py).  Occlusion has no tree tier: two_level_any refuses it, as
  the reference cannot serve it (ROADMAP Queue 3).

BLOCK = 512 and MAXC = 128 are kept from the JAX package, so the cull's
ids/counts/keys compare with JAX's array for array.

Gradients: none through a hit query.  The Pallas kernels carry no VJP, so
in JAX hit ids and distances are constants of the estimator; the CUDA
kernels return tensors without a gradient, and their plain versions are
torch code that autograd would differentiate.  So `cull_tree`,
`hier_cull`, `cluster_sweep` and `cluster_sweep_any` (and
packet_bvh.packet_hit) raise on either device when a ray input requires
grad (device.refuse_grad).  With material and light leaves no ray does:
the integrator detaches its sampled direction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device
from ..utils import hostcache, profiling
from . import binding
from . import bvh as bvh_mod
from .packet_bvh import pair_records, tree_depth
from .traverse import TriSoup, make_soup

BIG_T = float(np.float32(1e30))
BLOCK = 512             # rays per packet (the cull's unit; the sweeps split it
                        # into lane groups of SWEEP_GROUP rays)
TRIS_C = 512            # default triangles per cluster below 1.5M tris
SUBT = 256              # triangles per subtile (one shared-memory stage)
PLANE_ROWS = 12         # [n | U' | V'] x [x, y, z, offset] per triangle
MAXC = 128              # emitted cluster slots per packet and round
DENSE_CULL_MAX = 16384  # clusters; above it the top-BVH tree cull kernel
STACK_DEPTH = 64        # the tree cull kernel's traversal stack
HIER_MIN_CLUSTERS = 256  # the exact dense rectangle below, two-stage above
CAND_FACTOR = 4         # hier stage B exact-tests CAND_FACTOR * MAXC
CHUNK_PACKETS = 256     # packets per cull chunk: bounds the cull's
                        # (packets, BLOCK, K) rectangles at any ray count
CULL_BATCH = 32         # packets per exact-rectangle batch inside a chunk
GROUPS = (32, 64, 128, 256, 512)   # lane group sizes the sweeps take
SWEEP_GROUP = 64        # rays per sweep decision unit (lane group), the
                        # fastest of GROUPS for both sweeps on an H100
                        # (chip_smoke.py kernel phase; PERF.md)
STATS = 5               # sweep counters per unit: slots visited, clusters
                        # entered, subtile slab tests, subtiles swept,
                        # cycles (kernel only)
CULL_WORK = 7           # tree cull counters per packet: inner nodes
                        # expanded, leaves reached, clusters emitted (the
                        # count); kernel only: clock64 cycles in all, to
                        # stage the rays, and of the walk; 32-ray chunks
                        # tested (32 rays x 2 slab tests each)
HIER_WORK = 6           # hierarchical cull kernel counters per packet:
                        # octant groups holding a live lane, stage-A-live
                        # clusters, live candidates (stage B's exact
                        # tests: these x 512 rays); clock64 cycles in all,
                        # to the end of stage A's sort, and of stage B

# the JAX package's packed layout (pallas_cluster.py:141-156), read by
# `from_tpu_arrays`
_TPU_TAIL = 384
_TPU_SUB_META = 256


@dataclasses.dataclass
class ClusteredMesh:
    """Device arrays of the cluster tier (C clusters, n_sub subtiles)."""

    ctab: torch.Tensor        # (C, 12) f32: AABB lo xyz | hi xyz |
                              # centroid xyz | 0 0 0
    starts: torch.Tensor      # (C,) int32: BVH position of the first tri
    sub_bounds: torch.Tensor  # (C, n_sub, 6) f32 subtile AABBs over valid
                              # tris (empty subtiles collapse to cluster lo)
    planes: torch.Tensor      # (C, n_sub, PLANE_ROWS, SUBT) f32
    nrm: torch.Tensor         # (C, 6) f32 oriented unit-normal bounds
    # top BVH over the cluster AABBs (the tree cull), packed like
    # packet_bvh.PackedBVH: leaf a = start in top_order, b = count
    top_box: torch.Tensor     # (M, 6) f32 node AABB lo xyz | hi xyz
    top_a: torch.Tensor       # (M,) int32 left child / leaf start
    top_b: torch.Tensor       # (M,) int32 right child / leaf count
    top_leaf: torch.Tensor    # (M,) int32 (1 = leaf)
    top_order: torch.Tensor   # (C,) int32 leaf position -> cluster id
    top_max_leaf: int
    top_pairs: torch.Tensor   # (R, 16) child-pair records of the top tree's
                              # inner nodes (packet_bvh.pair_records)
    top_depth: int            # deepest top-tree node (root 0)
    host_tris: Optional[np.ndarray] = None   # (T,3,3) BVH order (oracles)

    @property
    def n_clusters(self) -> int:
        return self.ctab.shape[0]

    @property
    def n_sub(self) -> int:
        return self.planes.shape[1]

    @property
    def bounds(self) -> torch.Tensor:
        return self.ctab[:, 0:6]

    def to(self, dev) -> 'ClusteredMesh':
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# Phase 0: host build
# ---------------------------------------------------------------------------

def _node_ranges(fb):
    """Per-node contiguous triangle ranges [start, end) in BVH order
    (children follow their parent, so <= depth vectorized passes)."""
    a = fb.node_a.astype(np.int64)
    b = fb.node_b.astype(np.int64)
    leaf = fb.node_leaf
    start = np.where(leaf, a, -1)
    end = np.where(leaf, b, -1)
    ac = np.where(leaf, 0, a)
    bc = np.where(leaf, 0, b)
    unresolved = ~leaf
    while unresolved.any():
        can = unresolved & (start[ac] >= 0) & (end[bc] >= 0)
        if not can.any():
            raise RuntimeError('BVH child-after-parent invariant broken')
        start[can] = start[ac[can]]
        end[can] = end[bc[can]]
        unresolved &= ~can
    return start, end


def _box_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def _subtree_ranges(fb, tris_c: int, merge_factor=1.25):
    """Cluster ranges cut at maximal BVH subtrees of <= tris_c triangles,
    then consecutive ranges merged greedily while the merged count fits
    and area(union)*(n1+n2) <= merge_factor*(area1*n1 + area2*n2)."""
    ns, ne = _node_ranges(fb)
    b, a, leaf = fb.node_b, fb.node_a, fb.node_leaf
    ranges = []
    stack = [0]
    while stack:
        n = stack.pop()
        if leaf[n] or ne[n] - ns[n] <= tris_c:
            ranges.append((int(ns[n]), int(ne[n]), int(n)))
        else:
            stack.append(int(b[n]))
            stack.append(int(a[n]))
    ranges.sort()
    out = []
    cs = ce = clo = chi = None
    for s, e, n in ranges:
        rlo, rhi = fb.node_lo[n], fb.node_hi[n]
        if cs is None:
            cs, ce, clo, chi = s, e, rlo, rhi
            continue
        if (ce - cs) + (e - s) <= tris_c:
            ulo = np.minimum(clo, rlo)
            uhi = np.maximum(chi, rhi)
            if (_box_area(ulo, uhi) * (e - cs)
                    <= merge_factor * (_box_area(clo, chi) * (ce - cs)
                                       + _box_area(rlo, rhi) * (e - s))):
                ce, clo, chi = e, ulo, uhi
                continue
        out.append((cs, ce - cs))
        cs, ce, clo, chi = s, e, rlo, rhi
    out.append((cs, ce - cs))
    return out


def build_clustered(tri_verts: np.ndarray, fb=None,
                    tris_c: Optional[int] = None, merge_factor=1.25,
                    nrm_sign: float = 1.0, dev=None) -> ClusteredMesh:
    """Partition the BVH order into clusters, build the top BVH over their
    bounds and precompute the sweep's plane data
    (pallas_cluster.build_clustered, subtree layout), on `dev` (None: the
    card).

    tris_c defaults to 2048 above 1.5M triangles and TRIS_C below, doubled
    until the cluster count fits the dense culls (<= DENSE_CULL_MAX); an
    explicit tris_c may give more clusters, which the tree tier serves.
    The host arrays are cached for the same triangles, BVH and parameters
    (utils.hostcache); the tensors are made anew."""
    dev = device.resolve(dev)
    if fb is None:
        fb = bvh_mod.build_bvh(tri_verts)
    key = hostcache.digest(np.asarray(tri_verts), fb.order, fb.node_a,
                           fb.node_b, fb.node_leaf, tris_c, merge_factor,
                           float(nrm_sign))
    ctab, starts, sub_bounds, planes, nrm, top, ordered = hostcache.cached(
        'clusters', key, lambda: _cluster_host(tri_verts, fb, tris_c,
                                               merge_factor, nrm_sign))

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32, order='C'), device=dev)

    top_b = np.where(top.node_leaf, top.node_b - top.node_a, top.node_b)
    return ClusteredMesh(
        ctab=f32(ctab),
        starts=torch.as_tensor(np.array(starts, np.int32), device=dev),
        sub_bounds=f32(sub_bounds),
        planes=f32(planes),
        nrm=f32(nrm),
        **_top_fields(np.concatenate([top.node_lo, top.node_hi], axis=1),
                      top.node_a, top_b, top.node_leaf, top.order, dev),
        host_tris=ordered)


def _cluster_host(tri_verts, fb, tris_c, merge_factor, nrm_sign):
    """build_clustered's host arrays: (ctab, starts, sub_bounds, planes,
    nrm, the top BVH, the triangles in BVH order)."""
    t = tri_verts.shape[0]
    if tris_c is None:
        tris_c = 2048 if t > 1_500_000 else TRIS_C
        ranges = _subtree_ranges(fb, tris_c, merge_factor)
        while len(ranges) > DENSE_CULL_MAX:
            tris_c *= 2
            ranges = _subtree_ranges(fb, tris_c, merge_factor)
    else:
        ranges = _subtree_ranges(fb, tris_c, merge_factor)
    if tris_c % SUBT:
        raise ValueError(f'tris_c {tris_c} is not a multiple of {SUBT}')
    ordered = tri_verts[fb.order].astype(np.float32)
    c = len(ranges)
    starts = np.asarray([s for s, _ in ranges], np.int64)
    counts = np.asarray([n for _, n in ranges], np.int64)
    assert counts.sum() == t and (counts >= 1).all() \
        and (counts <= tris_c).all()
    gidx = starts[:, None] + np.arange(tris_c)[None, :]     # (c, tris_c)
    valid = gidx < (starts + counts)[:, None]
    grouped = np.where(valid[..., None, None],
                       ordered[np.minimum(gidx, t - 1)], 0.0)
    # cluster bounds over VALID triangles only (pad tris sit at origin)
    pts = grouped.reshape(c, tris_c * 3, 3)
    vmask = np.repeat(valid, 3, axis=1)[:, :, None]
    clo = np.where(vmask, pts, np.inf).min(axis=1).astype(np.float32)
    chi = np.where(vmask, pts, -np.inf).max(axis=1).astype(np.float32)
    centers = ((clo + chi) * 0.5).astype(np.float32)

    # top BVH, one cluster per leaf
    top = bvh_mod.build_bvh_from_bounds(clo, chi, centers, max_leaf_size=1)
    if top.depth >= STACK_DEPTH:
        raise ValueError(
            f'cluster top-BVH depth {top.depth} >= the tree cull stack depth '
            f'{STACK_DEPTH}: the traversal stack would overflow')

    # plane data per triangle, float64 precompute like make_soup
    av = grouped[:, :, 0, :].astype(np.float64)          # (c, T, 3)
    uv = grouped[:, :, 1, :].astype(np.float64) - av
    vv = grouped[:, :, 2, :].astype(np.float64) - av
    nv = np.cross(uv, vv)
    m11 = np.sum(uv * uv, -1)
    m12 = np.sum(uv * vv, -1)
    m22 = np.sum(vv * vv, -1)
    det = m11 * m22 - m12 * m12
    with np.errstate(divide='ignore', invalid='ignore'):
        invdet = np.where(det != 0.0, 1.0 / det, 0.0)
    up = invdet[..., None] * (m22[..., None] * uv - m12[..., None] * vv)
    vp = invdet[..., None] * (m11[..., None] * vv - m12[..., None] * uv)
    keep = (valid & (det != 0.0) & np.isfinite(nv).all(-1))[..., None]
    nv = np.where(keep, nv, 0.0)
    up = np.where(keep, up, 0.0)
    vp = np.where(keep, vp, 0.0)
    # oriented unit-normal bounds; empty clusters collapse to 0, which the
    # cull treats as always back-facing (no hittable triangle)
    nlen = np.linalg.norm(nv, axis=-1, keepdims=True)
    nkeep = keep & (nlen > 0.0)
    with np.errstate(divide='ignore', invalid='ignore'):
        nunit = np.where(nkeep, nrm_sign * nv / np.where(nlen > 0, nlen, 1.0),
                         np.nan)
    nrm_lo = np.where(np.isnan(nunit), np.inf, nunit).min(axis=1)
    nrm_hi = np.where(np.isnan(nunit), -np.inf, nunit).max(axis=1)
    empty_c = ~np.isfinite(nrm_lo).all(-1, keepdims=True)
    nrm_lo = np.where(empty_c, 0.0, nrm_lo).astype(np.float32)
    nrm_hi = np.where(empty_c, 0.0, nrm_hi).astype(np.float32)

    n_sub = tris_c // SUBT
    a_c = av - centers[:, None, :]
    rows = []
    for pl_ in (nv, up, vp):
        xyz = pl_.reshape(c, n_sub, SUBT, 3).transpose(0, 1, 3, 2)
        off = -np.sum(a_c * pl_, -1).reshape(c, n_sub, 1, SUBT)
        rows += [xyz, off]
    planes = np.concatenate(rows, axis=2).astype(np.float32)

    pts_s = grouped.reshape(c, n_sub, SUBT * 3, 3)
    vmask_s = np.repeat(valid.reshape(c, n_sub, SUBT), 3, axis=2)[..., None]
    slo = np.where(vmask_s, pts_s, np.inf).min(axis=2)
    shi = np.where(vmask_s, pts_s, -np.inf).max(axis=2)
    sempty = ~valid.reshape(c, n_sub, SUBT).any(axis=2)
    slo = np.where(sempty[..., None], clo[:, None, :], slo)
    shi = np.where(sempty[..., None], clo[:, None, :], shi)

    ctab = np.concatenate([clo, chi, centers, np.zeros((c, 3), np.float32)],
                          axis=1)

    return (ctab, starts.astype(np.int32),
            np.concatenate([slo, shi], axis=2).astype(np.float32),
            planes, np.concatenate([nrm_lo, nrm_hi], axis=1), top, ordered)


def _top_fields(box, a, b, leaf, order, dev) -> dict:
    """The ClusteredMesh top-tree fields from host arrays."""
    def i32(x):
        return torch.as_tensor(np.array(x, np.int32), device=dev)

    leaf = np.asarray(leaf).astype(np.int32)
    b = np.asarray(b)
    return dict(top_box=torch.as_tensor(np.array(box, np.float32, order='C'),
                                        device=dev),
                top_a=i32(a), top_b=i32(b), top_leaf=i32(leaf),
                top_order=i32(order),
                top_max_leaf=int(b[leaf != 0].max()),
                top_pairs=torch.as_tensor(pair_records(box, a, b, leaf),
                                          device=dev),
                top_depth=tree_depth(a, b, leaf))


def from_tpu_arrays(arrays, dev=None) -> ClusteredMesh:
    """The port's ClusteredMesh from the JAX package's `cluster_arrays`
    tuple as numpy (10 top-tree arrays, 6 cluster-bound arrays, the packed
    (C, 4, W) sweep records, and the (C, 6) normal bounds), on `dev`
    (None: the card).  The packed record's plane blocks, tail scalars and
    subtile AABB blocks are re-laid out as planes / ctab / starts /
    sub_bounds; the top tree's per-axis arrays become top_box."""
    dev = device.resolve(dev)
    a = [np.asarray(x) for x in arrays]
    if len(a) != 18:
        raise ValueError('expected the 18-array cluster tuple with nrm')
    packed = a[16]
    c, _, w = packed.shape
    n_sub = (w - _TPU_TAIL) // (3 * SUBT + _TPU_SUB_META)
    tail0 = n_sub * 3 * SUBT
    sub0 = tail0 + _TPU_TAIL
    planes = np.empty((c, n_sub, PLANE_ROWS, SUBT), np.float32)
    sub = np.empty((c, n_sub, 6), np.float32)
    for s in range(n_sub):
        for f in range(3):
            col = s * 3 * SUBT + f * SUBT
            planes[:, s, 4 * f:4 * f + 4] = packed[:, :, col:col + SUBT]
        base = sub0 + s * _TPU_SUB_META
        sub[:, s, 0:3] = packed[:, 0:3, base]
        sub[:, s, 3:6] = packed[:, 0:3, base + 128]
    ctab = np.concatenate([packed[:, 0:3, tail0], packed[:, 0:3, tail0 + 128],
                           packed[:, 0:3, tail0 + 256],
                           np.zeros((c, 3), np.float32)], axis=1)
    starts = (packed[:, 3, tail0].astype(np.int64) * 4096
              + packed[:, 3, tail0 + 128].astype(np.int64))

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32, order='C'), device=dev)

    return ClusteredMesh(
        ctab=f32(ctab), starts=torch.as_tensor(starts.astype(np.int32),
                                               device=dev),
        sub_bounds=f32(sub), planes=f32(planes), nrm=f32(a[17]),
        **_top_fields(np.stack(a[0:6], axis=1), a[6], a[7], a[8], a[9], dev))


def flat_soup(cm: ClusteredMesh, dev=None) -> TriSoup:
    """The mesh as a flat BVH-ordered TriSoup (oracles), on `dev` (None:
    the card): the sweep's tri output indexes it directly."""
    return make_soup(cm.host_tris, device=dev)


# ---------------------------------------------------------------------------
# Phase 1: culls (torch)
# ---------------------------------------------------------------------------

def _slab_keys(o, d, tm, box, nbox=None, exclude=None):
    """Exact per-ray slab rectangle, reduced per packet.

    o, d: (P, BLOCK, 3); tm: (P, BLOCK); box: (P or 1, K, 6) AABBs;
    nbox: (P or 1, K, 6) unit-normal bounds (per-ray backface cull) or
    None; exclude: (P, K) bool or None.  Returns (packet-min entry key
    (P, K), any-lane-live (P, K))."""
    tmin = tmx = None
    for k in range(3):
        inv = 1.0 / d[:, :, k:k + 1]
        ok_ = o[:, :, k:k + 1]
        t1 = (box[:, None, :, k] - ok_) * inv
        t2 = (box[:, None, :, k + 3] - ok_) * inv
        lo_, hi_ = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo_ if tmin is None else torch.maximum(tmin, lo_)
        tmx = hi_ if tmx is None else torch.minimum(tmx, hi_)
    entry = torch.clamp_min(tmin, 0.0)
    live = (tmx >= entry) & (tmin < tm[:, :, None])
    if nbox is not None:
        lb = None
        for k in range(3):
            dk = d[:, :, k:k + 1]
            m = torch.minimum(nbox[:, None, :, k] * dk,
                              nbox[:, None, :, k + 3] * dk)
            lb = m if lb is None else lb + m
        live &= lb < 0.0
    if exclude is not None:
        live &= ~exclude[:, None, :]
    key = torch.where(live, entry, torch.full_like(entry, BIG_T)).amin(dim=1)
    return key, live.any(dim=1)


def _batched_slab_keys(o, d, tm, box, nbox=None, exclude=None):
    """_slab_keys over CULL_BATCH-packet batches (bounded rectangles)."""
    keys, lives = [], []
    per_packet = box.shape[0] > 1
    for p0 in range(0, o.shape[0], CULL_BATCH):
        sl = slice(p0, p0 + CULL_BATCH)
        k_, l_ = _slab_keys(
            o[sl], d[sl], tm[sl], box[sl] if per_packet else box,
            None if nbox is None else (nbox[sl] if per_packet else nbox),
            None if exclude is None else exclude[sl])
        keys.append(k_)
        lives.append(l_)
    return torch.cat(keys), torch.cat(lives)


def _pad_slots(ids, keys, maxc):
    """Pad emitted slot tables to maxc columns (-1 ids, BIG_T keys)."""
    short = maxc - ids.shape[1]
    if short <= 0:
        return ids, keys
    nb = ids.shape[0]
    return (torch.cat([ids, ids.new_full((nb, short), -1)], 1),
            torch.cat([keys, keys.new_full((nb, short), BIG_T)], 1))


def _emit_from_keys(keys_c, live_c, maxc):
    """Near-first emission of the maxc smallest keys (stable: ties keep
    cluster index order, like lax.sort)."""
    count = live_c.sum(dim=1, dtype=torch.int32)[:, None]
    k = min(maxc, keys_c.shape[1])
    keys_s, idx = torch.sort(keys_c, dim=1, stable=True)
    keys_sel = keys_s[:, :k].contiguous()
    ids = torch.where(keys_sel < BIG_T, idx[:, :k].to(torch.int32),
                      torch.full_like(idx[:, :k], -1, dtype=torch.int32))
    ids, keys_sel = _pad_slots(ids, keys_sel, maxc)
    return ids, count, keys_sel


def _dense_cull(bounds, org, dirn, tmax, maxc: int = MAXC, exclude=None,
                nrm=None):
    """Every packet x every cluster exact slab rectangle
    (pallas_cluster._dense_cull).  `exclude` ((nb, C) bool) drops clusters
    a previous windowed round swept, so `count` then counts live clusters
    not yet swept.  Returns (ids (nb, maxc) int32 near-first, -1 padded;
    count (nb, 1) int32; keys (nb, maxc) f32)."""
    nb = org.shape[0] // BLOCK
    keys_c, live_c = _batched_slab_keys(
        org.view(nb, BLOCK, 3), dirn.view(nb, BLOCK, 3),
        tmax.view(nb, BLOCK), bounds[None],
        None if nrm is None else nrm[None], exclude)
    keys_c = torch.where(live_c, keys_c, torch.full_like(keys_c, BIG_T))
    return _emit_from_keys(keys_c, live_c, maxc)


def _interval_axis(lo_c, hi_c, ol, oh, dl, dh):
    """Per-packet-group interval slab on one axis: (nb, 1) origin and
    direction intervals against (C,) cluster slabs -> (nb, C) entry lower
    bound and exit upper bound.  A zero-direction axis still culls by
    origin overlap."""
    onesign = (dl > 0.0) | (dh < 0.0)
    allzero = (dl == 0.0) & (dh == 0.0)
    no_overlap = allzero & ((hi_c[None, :] < ol) | (lo_c[None, :] > oh))
    one = torch.ones_like(dl)
    il1 = 1.0 / torch.where(onesign, dl, one)
    il2 = 1.0 / torch.where(onesign, dh, one)
    a1 = lo_c[None, :] - oh
    a2 = lo_c[None, :] - ol
    b1 = hi_c[None, :] - oh
    b2 = hi_c[None, :] - ol
    prods = (a1 * il1, a1 * il2, a2 * il1, a2 * il2,
             b1 * il1, b1 * il2, b2 * il1, b2 * il2)
    t_lo = torch.minimum(
        torch.minimum(torch.minimum(prods[0], prods[1]),
                      torch.minimum(prods[2], prods[3])),
        torch.minimum(torch.minimum(prods[4], prods[5]),
                      torch.minimum(prods[6], prods[7])))
    t_hi = torch.maximum(
        torch.maximum(torch.maximum(prods[0], prods[1]),
                      torch.maximum(prods[2], prods[3])),
        torch.maximum(torch.maximum(prods[4], prods[5]),
                      torch.maximum(prods[6], prods[7])))
    big = torch.full_like(t_lo, BIG_T)
    t_lo = torch.where(onesign, t_lo, -big)
    t_hi = torch.where(onesign, t_hi, big)
    t_lo = torch.where(no_overlap, big, t_lo)
    t_hi = torch.where(no_overlap, -big, t_hi)
    return t_lo, t_hi


def _hier_cull(bounds, org, dirn, tmax, maxc: int = MAXC, exclude=None,
               nrm=None):
    """Two-stage cull (pallas_cluster._hier_cull): a per-octant packet
    interval rectangle selects the CAND_FACTOR*maxc nearest candidates,
    then the exact per-ray rectangle runs over those only.

    count = exact-live candidates + interval-live beyond the window (an
    upper bound), clamped above maxc whenever anything was dropped; the
    last key is clamped to the dropped clusters' lower bound.  The 4th
    output lists the ids the windowed loop may mark swept: exactly-dead
    candidates and the emitted slots."""
    lox, loy, loz, hix, hiy, hiz = bounds.unbind(1)
    nb = org.shape[0] // BLOCK
    c = lox.shape[0]
    k = min(CAND_FACTOR * maxc, c)
    dev = org.device

    # ---- stage A: packet-interval rectangle per direction octant ----
    o = org.view(nb, BLOCK, 3)
    d = dirn.view(nb, BLOCK, 3)
    tm = tmax.view(nb, BLOCK)
    alive_l = tm > 0.0
    oct_l = ((d[:, :, 0] > 0).to(torch.int32) * 4
             + (d[:, :, 1] > 0).to(torch.int32) * 2
             + (d[:, :, 2] > 0).to(torch.int32))
    tmx = tm.amax(dim=1, keepdim=True)
    entry_lo = torch.full((nb, c), BIG_T, device=dev)
    exit_hi = torch.full((nb, c), -BIG_T, device=dev)
    any_grp = torch.zeros((nb, 1), dtype=torch.bool, device=dev)
    big3 = torch.full_like(o, BIG_T)
    for og in range(8):
        grp = (alive_l & (oct_l == og))[:, :, None]
        olo = torch.where(grp, o, big3).amin(dim=1)
        ohi = torch.where(grp, o, -big3).amax(dim=1)
        dlo = torch.where(grp, d, big3).amin(dim=1)
        dhi = torch.where(grp, d, -big3).amax(dim=1)
        nonempty = grp[:, :, 0].any(dim=1, keepdim=True)
        any_grp |= nonempty
        e_lo = e_hi = None
        for kk, (lo_c, hi_c) in enumerate(((lox, hix), (loy, hiy),
                                           (loz, hiz))):
            a_lo, a_hi = _interval_axis(lo_c, hi_c, olo[:, kk:kk + 1],
                                        ohi[:, kk:kk + 1], dlo[:, kk:kk + 1],
                                        dhi[:, kk:kk + 1])
            e_lo = a_lo if e_lo is None else torch.maximum(e_lo, a_lo)
            e_hi = a_hi if e_hi is None else torch.minimum(e_hi, a_hi)
        big = torch.full_like(e_lo, BIG_T)
        if nrm is not None:
            # group-level backface cull: min of n·d over the cluster's
            # normal box and the group's direction box
            lb = None
            for kk in range(3):
                nl = nrm[:, kk][None, :]
                nh = nrm[:, kk + 3][None, :]
                dl_ = dlo[:, kk:kk + 1]
                dh_ = dhi[:, kk:kk + 1]
                m = torch.minimum(torch.minimum(nl * dl_, nl * dh_),
                                  torch.minimum(nh * dl_, nh * dh_))
                lb = m if lb is None else lb + m
            front = lb < 0.0
            e_lo = torch.where(front, e_lo, big)
            e_hi = torch.where(front, e_hi, -big)
        e_lo = torch.where(nonempty, e_lo, big)
        e_hi = torch.where(nonempty, e_hi, -big)
        entry_lo = torch.minimum(entry_lo, e_lo)
        exit_hi = torch.maximum(exit_hi, e_hi)

    key_i = torch.clamp_min(entry_lo, 0.0)
    live_i = (exit_hi >= key_i) & (entry_lo < tmx) & any_grp
    if exclude is not None:
        live_i &= ~exclude
    keys_i = torch.where(live_i, key_i, torch.full_like(key_i, BIG_T))

    # K nearest candidates via one int32 sort of (key bits | column): the
    # index bits only round keys down, so they stay lower bounds
    idx_bits = 13 if c <= 8192 else 14
    idx_mask = (1 << idx_bits) - 1
    kb = keys_i.view(torch.int32)
    iota_c = torch.arange(c, dtype=torch.int32, device=dev)
    packed_k = (kb & ~idx_mask) | iota_c[None, :]
    sorted_k = torch.sort(packed_k, dim=-1).values[:, :k]
    cand = sorted_k & idx_mask
    cand_keys_i = (sorted_k & ~idx_mask).view(torch.float32)
    cand_live_i = cand_keys_i < float(np.float32(9e29))
    cand_ids = torch.where(cand_live_i, cand, torch.full_like(cand, -1))
    n_live_i = live_i.sum(dim=1, dtype=torch.int32)
    n_dropped = torch.clamp_min(n_live_i - k, 0)
    dropped_lb = cand_keys_i.amax(dim=1)

    # ---- stage B: exact per-ray rectangle over the candidates ----
    table = bounds if nrm is None else torch.cat([bounds, nrm], dim=1)
    rows = table[cand.long()]                               # (nb, k, 6|12)
    keys_e, live_e = _batched_slab_keys(
        o, d, tm, rows[:, :, 0:6], None if nrm is None else rows[:, :, 6:12])
    live_e &= cand_live_i
    keys_ce = torch.where(live_e, keys_e, torch.full_like(keys_e, BIG_T))

    ke = min(k, maxc)
    keys_s, perm = torch.sort(keys_ce, dim=1, stable=True)
    keys_sel = keys_s[:, :ke]
    ids_sorted = cand_ids.gather(1, perm[:, :ke])
    ids = torch.where(keys_sel < BIG_T, ids_sorted,
                      torch.full_like(ids_sorted, -1))
    count = live_e.sum(dim=1, dtype=torch.int32) + n_dropped
    count = torch.where(n_dropped > 0, torch.clamp_min(count, maxc + 1),
                        count)[:, None]
    ids, keys_sel = _pad_slots(ids, keys_sel, maxc)
    last = torch.where(n_dropped > 0,
                       torch.minimum(keys_sel[:, maxc - 1], dropped_lb),
                       keys_sel[:, maxc - 1])
    keys_sel = torch.cat([keys_sel[:, :maxc - 1], last[:, None]], dim=1)
    swept_ok = torch.cat([torch.where(live_e, torch.full_like(cand_ids, -1),
                                      cand_ids), ids], dim=1)
    return ids, count, keys_sel, swept_ok


def _cull(cm: ClusteredMesh, org, dirn, tmax, nrm=None, exclude=None):
    """Dense-tier cull: hierarchical above HIER_MIN_CLUSTERS (`hier_cull`:
    the kernel on the card, _hier_cull on the CPU), the exact rectangle
    below.  4th output: the ids a windowed round marks swept."""
    with profiling.span('pt.cull', packets=org.shape[0] // BLOCK):
        if cm.n_clusters > HIER_MIN_CLUSTERS:
            return hier_cull(cm.bounds, org, dirn, tmax, exclude=exclude,
                             nrm=nrm)
        ids, counts, keys = _dense_cull(cm.bounds, org, dirn, tmax,
                                        exclude=exclude, nrm=nrm)
        return ids, counts, keys, ids


def _leaf_nodes(cm: ClusteredMesh) -> torch.Tensor:
    """(C,) int64: the top-tree leaf that holds each cluster."""
    leaf = cm.top_leaf.nonzero()[:, 0]
    cnt = cm.top_b[leaf].long()
    first = cnt.cumsum(0) - cnt
    k = torch.arange(int(cnt.sum()), device=cnt.device) \
        - first.repeat_interleave(cnt)
    pos = cm.top_a[leaf].long().repeat_interleave(cnt) + k
    out = torch.empty(cm.n_clusters, dtype=torch.int64, device=cnt.device)
    out[cm.top_order.long()[pos]] = leaf.repeat_interleave(cnt)
    return out


def cull_tree_plain(cm: ClusteredMesh, org, dirn, tmax, work=None):
    """The tree cull's function computed directly: per packet, the exact
    slab rectangle over every cluster's leaf box; count = the live
    clusters, the MAXC nearest by (packet-min entry key, cluster id),
    sorted so.  A leaf is reached by the walk iff some lane is live for
    it: its ancestors' boxes contain it, and slab intervals only widen
    with the box under rounding.  By the same argument the walk expands
    the root and every inner node some lane is live for, whatever its
    order, so `work` ((nb, CULL_WORK) int64, optional) gets the kernel's
    first three counters from the inner nodes' rectangle too."""
    nb = org.shape[0] // BLOCK
    leaf = cm.top_leaf != 0
    nodes = torch.arange(leaf.shape[0], device=leaf.device)
    if work is None:
        nodes = nodes[leaf]                   # the leaves are enough
    keys_n, live_n = _batched_slab_keys(
        org.view(nb, BLOCK, 3), dirn.view(nb, BLOCK, 3),
        tmax.view(nb, BLOCK), cm.top_box[nodes][None])
    col = torch.full_like(leaf, -1, dtype=torch.int64)
    col[nodes] = torch.arange(nodes.shape[0], device=leaf.device)
    c = col[_leaf_nodes(cm)]
    live_c = live_n[:, c]
    keys_c = torch.where(live_c, keys_n[:, c], torch.full_like(keys_n[:, c],
                                                               BIG_T))
    ids, count, keys = _emit_from_keys(keys_c, live_c, MAXC)
    if work is not None:
        inner = live_n[:, ~leaf].sum(dim=1)
        if not bool(leaf[0]):                 # the root is expanded untested
            inner += 1 - live_n[:, 0].long()
        work[:, 0] = inner
        work[:, 1] = live_n[:, leaf].sum(dim=1)
        work[:, 2] = count[:, 0]
    return ids, count, keys


def cluster_cull(cm: ClusteredMesh, org, dirn, tmax):
    """Phase 1 without the backface cull (pallas_cluster.cluster_cull):
    (ids (nb, MAXC) int32 near-first, -1 padded; count (nb, 1) int32;
    keys (nb, MAXC) f32).  Up to DENSE_CULL_MAX clusters the dense-tier
    culls (_cull_all); above it the tree cull."""
    if cm.n_clusters > DENSE_CULL_MAX:
        return cull_tree(cm, org, dirn, tmax)
    return _cull_all(cm, org, dirn, tmax, None)[:3]


def _mark_swept(swept, ids):
    """OR emitted ids into the (nb, C + 1) exclusion mask in place; -1
    slots land in the sink column C."""
    c = swept.shape[1] - 1
    idx = torch.where(ids >= 0, ids, torch.full_like(ids, c)).long()
    swept.scatter_(1, idx, True)
    return swept


def _residual_lanes(counts, keys, t):
    """Lanes whose result may still be wrong after a round: the packet
    overflowed and the lane's best t exceeds the last kept key (a dropped
    cluster could hold a closer hit)."""
    nb = counts.shape[0]
    over = counts[:, 0] > MAXC
    return (over[:, None] & (t.view(nb, BLOCK)
                             > keys[:, MAXC - 1][:, None])).reshape(-1)


def _occ_residual(counts, keys, occ, tmax):
    """Occlusion analogue: residual iff not occluded, the packet
    overflowed, and a dropped cluster may start within the lane's limit."""
    nb = counts.shape[0]
    over = counts[:, 0] > MAXC
    klast = keys[:, MAXC - 1][:, None]
    return (over[:, None] & (klast < tmax.view(nb, BLOCK))).reshape(-1) & ~occ


def root_exit_clamp(bounds, org, dirn, tmax):
    """Clamp each lane's tmax at its exit of the (slightly inflated) root
    AABB, so the sweep's sorted-key early break also fires for packets
    holding sky lanes; lanes missing the root box get tmax = -1."""
    rlo = bounds[:, 0:3].amin(dim=0)
    rhi = bounds[:, 3:6].amax(dim=0)
    slack = 1e-4 * (rhi - rlo) + 1e-3
    lo = rlo - slack
    hi = rhi + slack
    inv = 1.0 / dirn
    t1 = (lo - org) * inv
    t2 = (hi - org) * inv
    zero = dirn == 0.0
    inside = (org >= lo) & (org <= hi)
    big = torch.full_like(t1, BIG_T)
    lo_t = torch.where(zero, torch.where(inside, -big, big),
                       torch.minimum(t1, t2))
    hi_t = torch.where(zero, torch.where(inside, big, -big),
                       torch.maximum(t1, t2))
    entry = lo_t.amax(dim=-1)
    exit_t = hi_t.amin(dim=-1)
    in_box = exit_t >= torch.clamp_min(entry, 0.0)
    return torch.where(in_box, torch.minimum(tmax, exit_t),
                       torch.full_like(tmax, -1.0))


def recompute_bary(soup: TriSoup, org, dirn, t, tri):
    """Per-ray (alpha, beta) of known (t, tri) winners with the edge-matrix
    formula of traverse._tri_test_block; misses return (1, 0)."""
    i = tri.clamp_min(0).long()
    px = org[:, 0] + t * dirn[:, 0] - soup.ax[i]
    py = org[:, 1] + t * dirn[:, 1] - soup.ay[i]
    pz = org[:, 2] + t * dirn[:, 2] - soup.az[i]
    b11 = px * soup.ux[i] + py * soup.uy[i] + pz * soup.uz[i]
    b21 = px * soup.vx[i] + py * soup.vy[i] + pz * soup.vz[i]
    beta = (b11 * soup.m22[i] - b21 * soup.m12[i]) * soup.invdetm[i]
    gamma = (b21 * soup.m11[i] - b11 * soup.m12[i]) * soup.invdetm[i]
    hit = tri >= 0
    al = torch.where(hit, 1.0 - beta - gamma, torch.ones_like(beta))
    be = torch.where(hit, beta, torch.zeros_like(beta))
    return al, be


# ---------------------------------------------------------------------------
# Phase 2: the sweeps — plain PyTorch versions
# ---------------------------------------------------------------------------

def _slab_live(box, o, inv, cap):
    """Per-lane slab test of (P, 6) boxes against (P, BLOCK) rays, live
    iff the ray enters the box before its own cap."""
    tmin = tmx = None
    for k in range(3):
        t1 = (box[:, None, k] - o[:, :, k]) * inv[:, :, k]
        t2 = (box[:, None, k + 3] - o[:, :, k]) * inv[:, :, k]
        lo_, hi_ = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo_ if tmin is None else torch.maximum(tmin, lo_)
        tmx = hi_ if tmx is None else torch.minimum(tmx, hi_)
    entry = torch.clamp_min(tmin, 0.0)
    return (tmx >= entry) & (entry < cap)


def _subtile_hits(planes, oc, d, tn):
    """t and barycentric acceptance of (P, BLOCK) rays against (P, 12,
    SUBT) subtile planes: (P, BLOCK, SUBT) t and accept mask."""
    pl = planes[:, None]                                   # (P,1,12,S)

    def dot4(v, r):
        return (v[:, :, 0:1] * pl[:, :, r] + v[:, :, 1:2] * pl[:, :, r + 1]
                + v[:, :, 2:3] * pl[:, :, r + 2])

    on = dot4(oc, 0) + pl[:, :, 3]
    ou = dot4(oc, 4) + pl[:, :, 7]
    ov = dot4(oc, 8) + pl[:, :, 11]
    t = on / -dot4(d, 0)
    beta = ou + t * dot4(d, 4)
    gamma = ov + t * dot4(d, 8)
    bary = torch.minimum(torch.minimum(beta, gamma), 1.0 - (beta + gamma))
    return t, (t > tn[:, :, None]) & (bary >= 0.0)


def _sweep_plain(cm, ids, counts, keys, org, dirn, tmax, tmin, any_hit,
                 group=BLOCK, stats=None, seen=None):
    """Shared slot walk of the plain sweeps, vectorized over units.

    A unit is a lane group of `group` rays of one packet (BLOCK // group
    units per packet, unit u = rays [u * group, (u + 1) * group)); it
    walks its packet's slots and makes every decision from its own lanes.
    Slot k of every still-active unit is processed together: cluster slab
    skip, then per subtile the subtile slab skip and the plane test on
    (units, group, SUBT) tensors; an any-hit unit stops as soon as all
    its lanes are occluded.  A unit stops after slot k when k + 1 >= count
    or the next key is >= every lane's best t (closest) or live cap
    (any-hit).

    `stats` ((units, STATS) int64), optional, receives each unit's slots
    visited, clusters entered, subtile slab tests and subtiles swept
    (columns 0-3; column 4, the kernel's cycles, is left as it is);
    `seen` ((C, n_sub) bool), optional, marks every subtile swept."""
    nb = ids.shape[0]
    gpp = BLOCK // group
    nu = nb * gpp
    dev = org.device
    o = org.view(nu, group, 3)
    d = dirn.view(nu, group, 3)
    inv = 1.0 / d
    tn = torch.clamp_min(tmin, 0.0).view(nu, group)
    tx = tmax.view(nu, group)
    best = tx.clone()
    btri = torch.full((nu, group), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros((nu, group), dtype=torch.bool, device=dev)
    pk = torch.arange(nu, device=dev) // gpp          # packet of each unit
    cnt = counts[:, 0].clamp(max=MAXC)[pk]
    active = cnt > 0

    def cap(p):
        if any_hit:
            return torch.where(occ[p], torch.full_like(tx[p], -1.0), tx[p])
        return best[p]

    def count(col, p):
        if stats is not None:
            stats[p, col] += 1

    for k in range(MAXC):
        p = active.nonzero()[:, 0]
        if p.numel() == 0:
            break
        count(0, p)
        cid = ids[pk[p], k].clamp_min(0).long()
        live = _slab_live(cm.ctab[cid, 0:6], o[p], inv[p], cap(p)).any(dim=1)
        p, cid = p[live], cid[live]
        count(1, p)
        for s in range(cm.n_sub):
            if p.numel() == 0:
                break
            count(2, p)
            ls = _slab_live(cm.sub_bounds[cid, s], o[p], inv[p],
                            cap(p)).any(dim=1)
            ps, cs = p[ls], cid[ls]
            if ps.numel() == 0:
                continue
            count(3, ps)
            if seen is not None:
                seen[cs, s] = True
            oc = o[ps] - cm.ctab[cs, None, 6:9]
            t, ok = _subtile_hits(cm.planes[cs, s], oc, d[ps], tn[ps])
            if any_hit:
                occ[ps] |= (ok & (t < cap(ps)[:, :, None])).any(dim=-1)
                # a unit whose lanes are all occluded leaves the walk
                left = occ[p].all(dim=1)
                p, cid = p[~left], cid[~left]
                continue
            t = torch.where(ok, t, torch.full_like(t, BIG_T))
            tj, j = t.min(dim=-1)
            trj = (cm.starts[cs, None] + s * SUBT + j).to(torch.int32)
            bp, tp = best[ps], btri[ps]
            win = (tj < bp) | ((tj == bp) & (trj < tp))
            best[ps] = torch.where(win, tj, bp)
            btri[ps] = torch.where(win, trj, tp)
        p = active.nonzero()[:, 0]
        kn = min(k + 1, MAXC - 1)
        active[p] = (k + 1 < cnt[p]) & (keys[pk[p], kn]
                                        < cap(p).amax(dim=1))
    if any_hit:
        return occ.view(-1)
    return best.view(-1), btri.view(-1)


def cluster_sweep_plain(cm, ids, counts, keys, org, dirn, tmax, tmin,
                        group=None, stats=None, seen=None):
    """Closest hit over the emitted slots: (t (N,) — tmax where nothing
    beat it, tri (N,) int32 global BVH position or -1).  Exact argmin;
    equal t goes to the lower triangle index.  Lane groups of `group`
    rays (None: SWEEP_GROUP); `stats` and `seen` as in _sweep_plain."""
    return _sweep_plain(cm, ids, counts, keys, org, dirn, tmax, tmin, False,
                        _group(group), stats, seen)


def cluster_sweep_any_plain(cm, ids, counts, keys, org, dirn, tmax, tmin,
                            group=None, stats=None, seen=None):
    """Occlusion over the emitted slots: (N,) bool, True iff a triangle is
    hit with tmin < t < tmax.  `group`, `stats`, `seen` as
    cluster_sweep_plain."""
    return _sweep_plain(cm, ids, counts, keys, org, dirn, tmax, tmin, True,
                        _group(group), stats, seen)


def _group(group):
    """The lane group size of a sweep call: SWEEP_GROUP when None."""
    g = SWEEP_GROUP if group is None else int(group)
    if g not in GROUPS:
        raise ValueError(f'sweep group {g} is not one of {GROUPS}')
    return g


# ---------------------------------------------------------------------------
# Hand-written CUDA kernels: the sweeps (csrc/cluster_sweep.cu), the
# tree cull (csrc/cluster_cull.cu) and the hierarchical cull
# (csrc/cluster_hier_cull.cu), launched through ops/binding.py
# ---------------------------------------------------------------------------

def kernel_info() -> dict:
    """{(wrapper name, group): (registers per thread, resident blocks per
    SM, static shared bytes)} of both sweep kernels, from the CUDA
    runtime."""
    return {(name, g): binding.info('cluster_sweep_info', any_hit, g)
            for name, any_hit in (('cluster_sweep_closest', 0),
                                  ('cluster_sweep_any', 1))
            for g in GROUPS}


def cull_kernel_info(cm: ClusteredMesh) -> tuple:
    """(registers per thread, resident blocks per SM, shared bytes per
    block, threads per block) of the tree cull kernel on this mesh's top
    tree, from the CUDA runtime."""
    return binding.info('cluster_cull_info', cm.top_depth)


def cull_tree(cm: ClusteredMesh, org, dirn, tmax, work=None):
    """Tree cull of nb = N / BLOCK packets: (ids, count, keys) as
    cluster_cull.  CPU tensors take cull_tree_plain; CUDA tensors launch
    the hand-written kernel (replaces the TPU kernel
    pallas_cluster._cull_kernel) or raise.  `work` ((nb, CULL_WORK) int64),
    optional: each packet's counters (see CULL_WORK)."""
    device.refuse_grad('cull_tree', org, dirn, tmax)
    with profiling.span('pt.cull', packets=org.shape[0] // BLOCK):
        return _cull_tree(cm, org, dirn, tmax, work)


def _cull_tree(cm, org, dirn, tmax, work):
    """cull_tree inside its span."""
    if org.device.type == 'cpu':
        return cull_tree_plain(cm, org, dirn, tmax, work)
    dev = org.device
    n = org.shape[0]
    nb = n // BLOCK
    if dev.type != 'cuda':
        raise ValueError(f'cull_tree takes CUDA or CPU tensors, got {dev}')
    f32, i32 = torch.float32, torch.int32
    checks = ((cm.top_pairs, f32), (cm.top_box, f32), (cm.top_order, i32),
              (org, f32), (dirn, f32), (tmax, f32))
    for x, dt in checks:
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError('cull_tree inputs must be contiguous tensors of '
                             'the kernel types on one device')
    if cm.top_pairs.data_ptr() % 16:
        raise ValueError('cull_tree node records must be 16-byte aligned')
    if n % BLOCK or org.shape != (n, 3) or dirn.shape != (n, 3) \
            or tmax.shape != (n,):
        raise ValueError('cull_tree takes whole packets of rays')
    if work is not None and (work.device != dev or work.dtype != torch.int64
                             or tuple(work.shape) != (nb, CULL_WORK)):
        raise ValueError(f'cull_tree work must be an (nb, {CULL_WORK}) '
                         f'int64 tensor')
    ids = torch.empty((nb, MAXC), dtype=i32, device=dev)
    count = torch.empty((nb, 1), dtype=i32, device=dev)
    keys = torch.empty((nb, MAXC), dtype=f32, device=dev)
    if nb == 0:
        return ids, count, keys
    # a tree without inner nodes is one leaf holding every cluster
    root_cnt = cm.n_clusters if cm.top_pairs.shape[0] == 0 else 0
    torch.ops.pathtracer_tpu_torch.cull_tree_launch(
        cm.top_pairs, cm.top_depth, cm.top_box, root_cnt, cm.top_order, org,
        dirn, tmax, nb, ids, count, keys, work)
    return ids, count, keys


def hier_cull_kernel_info(n_clusters: int, nrm: bool = False) -> tuple:
    """(registers per thread, resident blocks per SM, shared bytes per
    block, threads per block) of the hierarchical cull kernel for this
    many clusters, with or without normal bounds, from the CUDA
    runtime."""
    return binding.info('cluster_hier_cull_info', n_clusters, int(nrm), 0)


def _rows_arg(x, name, dev, dtype, shape):
    """Raise unless `x` is a `dtype` tensor of `shape` on `dev` whose rows
    are contiguous (a view of wider rows, as ClusteredMesh.bounds, is
    taken with its row stride)."""
    if (not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != dtype
            or tuple(x.shape) != shape or (x.numel() and x.stride(1) != 1)):
        raise ValueError(f'hier_cull {name} must be a {dtype} tensor of '
                         f'shape {shape} with contiguous rows on {dev}')


def hier_cull(bounds, org, dirn, tmax, exclude=None, nrm=None, work=None):
    """Hierarchical cull of nb = N / BLOCK packets, _hier_cull's function
    at MAXC: (ids (nb, MAXC) int32, count (nb, 1) int32, keys (nb, MAXC)
    f32, the ids a windowed round marks swept (nb, min(C, CAND_FACTOR *
    MAXC) + MAXC) int32).  `bounds` (C, 6) and `nrm` (C, 6) f32, `exclude`
    (nb, C) bool, each with contiguous rows; 1 <= C <= DENSE_CULL_MAX.
    The arguments are checked on every device; then CPU tensors take
    _hier_cull and CUDA tensors launch the hand-written kernel
    (csrc/cluster_hier_cull.cu; the JAX package leaves this cull to XLA,
    pallas_cluster._hier_cull) once over every packet, or raise.  `work`
    ((nb, HIER_WORK) int64, CUDA only), optional: the kernel writes each
    packet's counters there (see HIER_WORK)."""
    device.refuse_grad('hier_cull', org, dirn, tmax)
    dev = org.device
    n = org.shape[0]
    nb = n // BLOCK
    f32 = torch.float32
    for x, name in ((org, 'org'), (dirn, 'dirn'), (tmax, 'tmax')):
        if x.device != dev or x.dtype != f32 or not x.is_contiguous():
            raise ValueError(f'hier_cull {name} must be a contiguous float32 '
                             f'tensor on {dev}')
    if n % BLOCK or org.shape != (n, 3) or dirn.shape != (n, 3) \
            or tmax.shape != (n,):
        raise ValueError('hier_cull takes whole packets of rays')
    c = bounds.shape[0] if isinstance(bounds, torch.Tensor) else 0
    if not 1 <= c <= DENSE_CULL_MAX:
        raise ValueError(f'hier_cull takes 1 to {DENSE_CULL_MAX} clusters, '
                         f'got {c}')
    _rows_arg(bounds, 'bounds', dev, f32, (c, 6))
    if nrm is not None:
        _rows_arg(nrm, 'nrm', dev, f32, (c, 6))
    if exclude is not None:
        _rows_arg(exclude, 'exclude', dev, torch.bool, (nb, c))
    if work is not None and (
            dev.type != 'cuda' or work.device != dev
            or work.dtype != torch.int64 or not work.is_contiguous()
            or tuple(work.shape) != (nb, HIER_WORK)):
        raise ValueError(f'hier_cull work must be a contiguous (nb, '
                         f'{HIER_WORK}) int64 tensor beside CUDA rays: the '
                         f'counters are the kernel\'s')
    if dev.type == 'cpu':
        return _hier_cull(bounds, org, dirn, tmax, exclude=exclude, nrm=nrm)
    if dev.type != 'cuda':
        raise ValueError(f'hier_cull takes CUDA or CPU tensors, got {dev}')
    i32 = torch.int32
    ids = torch.empty((nb, MAXC), dtype=i32, device=dev)
    count = torch.empty((nb, 1), dtype=i32, device=dev)
    keys = torch.empty((nb, MAXC), dtype=f32, device=dev)
    swept = torch.empty((nb, min(c, CAND_FACTOR * MAXC) + MAXC), dtype=i32,
                        device=dev)
    if nb == 0:
        return ids, count, keys, swept
    torch.ops.pathtracer_tpu_torch.hier_cull_launch(
        bounds, bounds.stride(0), nrm, 0 if nrm is None else nrm.stride(0),
        exclude, 0 if exclude is None else exclude.stride(0), org, dirn, tmax,
        nb, c, ids, count, keys, swept, work)
    return ids, count, keys, swept


def heaviest_first(counts, group):
    """(units,) int32 unit order of a sweep launch: the lane groups of the
    packets with the most emitted slots first (one argsort on the
    device), so that the launch's last wave holds light groups."""
    gpp = BLOCK // group
    perm = torch.argsort(counts[:, 0], descending=True, stable=True)
    return (perm[:, None] * gpp + torch.arange(gpp, device=counts.device)
            ).reshape(-1).to(torch.int32)


def _sweep_order(cm, ids, counts, keys, org, dirn, tmax, tmin, group, order,
                 stats):
    """Validate the launch inputs; returns the unit order (`order`, or
    heaviest_first)."""
    nb = ids.shape[0]
    n = nb * BLOCK
    nu = nb * (BLOCK // group)
    dev = org.device
    if dev.type != 'cuda':
        raise ValueError(f'the cluster sweep kernels take CUDA tensors, got '
                         f'{dev}')
    if order is None:
        order = heaviest_first(counts, group)
    elif order.numel() and not (0 <= int(order.min())
                                and int(order.max()) < nu):
        raise ValueError(f'cluster sweep order must index the {nu} units')
    tensors = [ids, counts, keys, cm.planes, cm.ctab, cm.starts,
               cm.sub_bounds, org, dirn, tmax, tmin, order]
    names = ('ids', 'counts', 'keys', 'planes', 'ctab', 'starts',
             'sub_bounds', 'org', 'dirn', 'tmax', 'tmin', 'order')
    i32, f32 = torch.int32, torch.float32
    dtypes = (i32, i32, f32, f32, f32, i32, f32, f32, f32, f32, f32, i32)
    for x, name, dt in zip(tensors, names, dtypes):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f'cluster sweep input {name} must be a '
                             f'contiguous {dt} tensor on {dev}')
    if (ids.shape != (nb, MAXC) or keys.shape != (nb, MAXC)
            or counts.shape != (nb, 1) or org.shape != (n, 3)
            or dirn.shape != (n, 3) or tmax.shape != (n,)
            or tmin.shape != (n,) or order.shape != (nu,)):
        raise ValueError('cluster sweep shapes do not match the packets')
    if cm.planes.data_ptr() % 16:
        raise ValueError('cluster sweep planes must be 16-byte aligned (the '
                         'bulk copy)')
    if stats is not None and (
            stats.device != dev or stats.dtype != torch.int64
            or not stats.is_contiguous() or tuple(stats.shape) != (nu, STATS)):
        raise ValueError(f'cluster sweep stats must be a contiguous '
                         f'(units, {STATS}) int64 tensor on {dev}')
    return order


def cluster_sweep(cm, ids, counts, keys, org, dirn, tmax, tmin, group=None,
                  order=None, stats=None):
    """Phase-2 closest hit in lane groups of `group` rays (None:
    SWEEP_GROUP), one launch over every packet.  CPU tensors take
    cluster_sweep_plain; CUDA tensors launch the hand-written kernel
    (replaces the TPU kernel pallas_cluster._sweep_kernel) or raise.
    `order` ((units,) int32), optional: the unit each block takes (None:
    heaviest_first).  `stats` ((units, STATS) int64), optional: the kernel
    writes each unit's counters there."""
    device.refuse_grad('cluster_sweep', keys, org, dirn, tmax, tmin)
    group = _group(group)
    if org.device.type == 'cpu':
        return cluster_sweep_plain(cm, ids, counts, keys, org, dirn, tmax,
                                   tmin, group, stats)
    order = _sweep_order(cm, ids, counts, keys, org, dirn, tmax, tmin, group,
                         order, stats)
    t = torch.empty_like(tmax)
    tri = torch.empty(tmax.shape, dtype=torch.int32, device=org.device)
    torch.ops.pathtracer_tpu_torch.cluster_sweep_launch(
        ids, counts, keys, cm.planes, cm.ctab, cm.starts, cm.sub_bounds,
        cm.n_sub, org, dirn, tmax, tmin, order, t, tri, stats, order.shape[0],
        group)
    return t, tri


def cluster_sweep_any(cm, ids, counts, keys, org, dirn, tmax, tmin,
                      group=None, order=None, stats=None):
    """Phase-2 occlusion in lane groups, one launch over every packet.
    CPU tensors take cluster_sweep_any_plain; CUDA tensors launch the
    hand-written kernel (replaces the TPU kernel
    pallas_cluster._sweep_any_kernel) or raise.  `group`, `order` and
    `stats` as cluster_sweep."""
    device.refuse_grad('cluster_sweep_any', keys, org, dirn, tmax, tmin)
    group = _group(group)
    if org.device.type == 'cpu':
        return cluster_sweep_any_plain(cm, ids, counts, keys, org, dirn,
                                       tmax, tmin, group, stats)
    order = _sweep_order(cm, ids, counts, keys, org, dirn, tmax, tmin, group,
                         order, stats)
    occ = torch.empty(tmax.shape, dtype=torch.bool, device=org.device)
    torch.ops.pathtracer_tpu_torch.cluster_sweep_any_launch(
        ids, counts, keys, cm.planes, cm.ctab, cm.starts, cm.sub_bounds,
        cm.n_sub, org, dirn, tmax, tmin, order, occ, stats, order.shape[0],
        group)
    return occ


# ---------------------------------------------------------------------------
# The two-level queries
# ---------------------------------------------------------------------------

def _pad_rays(org, dirn, tmax, tmin, target_n):
    """Extend ray arrays with dead rays (tmax = -1: culled everywhere)."""
    pad = target_n - org.shape[0]
    if pad == 0:
        return org, dirn, tmax, tmin
    dev = org.device
    # a copy from pageable host memory: torch waits for the stream
    with profiling.span('pt.sync', site='pad_rays'):
        pad_dir = torch.tensor([[1.0, 0.0, 0.0]], device=dev)
    org = torch.cat([org, torch.full((pad, 3), 1e6, device=dev)])
    dirn = torch.cat([dirn, pad_dir.expand(pad, 3)])
    tmax = torch.cat([tmax, torch.full((pad,), -1.0, device=dev)])
    tmin = torch.cat([tmin, torch.zeros((pad,), device=dev)])
    return org, dirn, tmax, tmin


def _prepare(cm, org, dirn, tmax, tmin):
    n = org.shape[0]
    if tmin is None:
        tmin = torch.full((n,), -1.0, device=org.device)
    n_pad = -(-n // BLOCK) * BLOCK
    org, dirn, tmax, tmin = _pad_rays(org.contiguous(), dirn.contiguous(),
                                      tmax.contiguous(), tmin.contiguous(),
                                      n_pad)
    return org, dirn, tmax, tmin


def _chunks(n):
    step = CHUNK_PACKETS * BLOCK
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _packet_rows(x, p):
    """Rows of whole packets p of a per-lane tensor, flattened back."""
    nb = x.shape[0] // BLOCK
    return x.view(nb, BLOCK, *x.shape[1:])[p].reshape(-1, *x.shape[1:])


def _cull_all(cm, o, d, tm, nrm, exclude=None):
    """_cull over every packet of a round, so that the round sweeps all
    its packets in one launch.  On the card above HIER_MIN_CLUSTERS that
    is one hier_cull launch; torch code (the CPU, the exact dense
    rectangle) runs over CHUNK_PACKETS chunks, each bounding the cull's
    rectangles, and concatenates them."""
    if o.device.type == 'cuda' and cm.n_clusters > HIER_MIN_CLUSTERS:
        return _cull(cm, o, d, tm, nrm, exclude=exclude)
    outs = []
    for sl in _chunks(o.shape[0]):
        ex = None if exclude is None else \
            exclude[sl.start // BLOCK:sl.stop // BLOCK]
        outs.append(_cull(cm, o[sl], d[sl], tm[sl], nrm, exclude=ex))
    return tuple(torch.cat(x) for x in zip(*outs))


def _closest_rounds(cm, o, d, tx, tn, nrm):
    """Cull + sweep, then exhaustive windowed rounds over the packets that
    still hold residual lanes (pallas_cluster._two_level_exec dense_chunk;
    rounds on packets without residual lanes cannot change any lane).
    Each round culls all its packets as _cull_all does (on the card above
    HIER_MIN_CLUSTERS one hier_cull launch, else CHUNK_PACKETS chunks) and
    sweeps them in one launch; packets are independent, so results equal
    chunk-by-chunk culling and sweeping."""
    nb = o.shape[0] // BLOCK
    with profiling.span('pt.round', packets=nb):
        ids, counts, keys, cand = _cull_all(cm, o, d, tx, nrm)
        t, tri = cluster_sweep(cm, ids, counts, keys, o, d, tx, tn)
        res = _residual_lanes(counts, keys, t)
        swept = _mark_swept(torch.zeros((nb, cm.n_clusters + 1),
                                        dtype=torch.bool, device=o.device),
                            cand)
    for _ in range(-(-cm.n_clusters // MAXC)):
        with profiling.span('pt.sync', site='rounds'):
            p = res.view(nb, BLOCK).any(dim=1).nonzero()[:, 0]
        if p.numel() == 0:
            break
        with profiling.span('pt.round', packets=p.numel()):
            op, dp, tnp = _packet_rows(o, p), _packet_rows(d, p), \
                _packet_rows(tn, p)
            tp, trp = _packet_rows(t, p), _packet_rows(tri, p)
            ids, counts, keys, cand = _cull_all(cm, op, dp, tp, nrm,
                                                exclude=swept[p, :-1])
            t2, tri2 = cluster_sweep(cm, ids, counts, keys, op, dp, tp, tnp)
            win = t2 < tp
            t.view(nb, BLOCK)[p] = torch.where(win, t2, tp).view(-1, BLOCK)
            tri.view(nb, BLOCK)[p] = torch.where(win, tri2,
                                                 trp).view(-1, BLOCK)
            swept[p] = _mark_swept(swept[p], cand)
            res = torch.zeros_like(res)
            res.view(nb, BLOCK)[p] = _residual_lanes(
                counts, keys, _packet_rows(t, p)).view(-1, BLOCK)
    return t, tri


def _refined(cm, org, dirn, tx, tn, refine_rounds):
    """Tree tier (pallas_cluster._two_level_exec `chunk` when not dense):
    one cull + sweep round, then up to `refine_rounds` rounds that re-cull
    the packets holding residual lanes with their tightened per-lane t.
    A packet without residual lanes cannot change in a re-cull, so only
    those packets are re-culled.  Returns (t, tri, residual)."""
    nb = org.shape[0] // BLOCK

    def round_(o, d, tm, tn_):
        with profiling.span('pt.round', packets=o.shape[0] // BLOCK):
            ids, counts, keys = cluster_cull(cm, o, d, tm)
            t_, tri_ = cluster_sweep(cm, ids, counts, keys, o, d, tm, tn_)
            return t_, tri_, _residual_lanes(counts, keys, t_)

    t, tri, res = round_(org, dirn, tx, tn)
    for _ in range(refine_rounds):
        with profiling.span('pt.sync', site='rounds'):
            p = res.view(nb, BLOCK).any(dim=1).nonzero()[:, 0]
        if p.numel() == 0:
            break
        tp, trp = _packet_rows(t, p), _packet_rows(tri, p)
        t2, tri2, res2 = round_(_packet_rows(org, p), _packet_rows(dirn, p),
                                tp, _packet_rows(tn, p))
        win = t2 < tp
        t.view(nb, BLOCK)[p] = torch.where(win, t2, tp).view(-1, BLOCK)
        tri.view(nb, BLOCK)[p] = torch.where(win, tri2, trp).view(-1, BLOCK)
        res = torch.zeros_like(res)
        res.view(nb, BLOCK)[p] = res2.view(-1, BLOCK)
    return t, tri, res


def two_level_hit(cm: ClusteredMesh, org, dirn, tmax, tmin=None,
                  backface_cull: bool = False, exhaustive: bool = True,
                  refine_rounds: int = 1, return_residual: bool = False):
    """Closest hit: (t, tri) with tri the global BVH position (-1 on a
    miss) and t == the caller's tmax on a miss.

    Up to DENSE_CULL_MAX clusters with exhaustive=True, the windowed
    rounds make every lane exact.  Otherwise (the tree tier) a lane may
    stay residual after `refine_rounds` re-culls; return_residual=True
    appends that (N,) bool mask, and the caller must send those lanes to
    an exact fallback (traverse.bvh_hit_sparse).  The backface cull
    applies to the windowed rounds only, as in the reference."""
    n0 = org.shape[0]
    with profiling.span('pt.query', kind='closest', lanes=n0):
        org, dirn, tmax, tmin = _prepare(cm, org, dirn, tmax, tmin)
        tx = root_exit_clamp(cm.bounds, org, dirn, tmax)
        if exhaustive and cm.n_clusters <= DENSE_CULL_MAX:
            t, tri = _closest_rounds(cm, org, dirn, tx, tmin,
                                     cm.nrm if backface_cull else None)
            res = torch.zeros(tmax.shape, dtype=torch.bool,
                              device=org.device)
        else:
            t, tri, res = _refined(cm, org, dirn, tx, tmin, refine_rounds)
        t = torch.where(tri >= 0, t, tmax)
    if return_residual:
        return t[:n0], tri[:n0], res[:n0]
    return t[:n0], tri[:n0]


def _any_rounds(cm, o, d, tx, tn, nrm):
    """Occlusion cull + sweep with exhaustive windowed rounds
    (pallas_cluster._two_level_any_exec), one sweep launch per round as
    _closest_rounds; occluded lanes drop out."""
    nb = o.shape[0] // BLOCK
    with profiling.span('pt.round', packets=nb):
        ids, counts, keys, cand = _cull_all(cm, o, d, tx, nrm)
        occ = cluster_sweep_any(cm, ids, counts, keys, o, d, tx, tn)
        res = _occ_residual(counts, keys, occ, tx)
        swept = _mark_swept(torch.zeros((nb, cm.n_clusters + 1),
                                        dtype=torch.bool, device=o.device),
                            cand)
    for _ in range(-(-cm.n_clusters // MAXC)):
        with profiling.span('pt.sync', site='rounds'):
            p = res.view(nb, BLOCK).any(dim=1).nonzero()[:, 0]
        if p.numel() == 0:
            break
        with profiling.span('pt.round', packets=p.numel()):
            op, dp, tnp = _packet_rows(o, p), _packet_rows(d, p), \
                _packet_rows(tn, p)
            occ_p = _packet_rows(occ, p)
            live_tx = torch.where(occ_p, torch.full_like(tnp, -1.0),
                                  _packet_rows(tx, p))
            ids, counts, keys, cand = _cull_all(cm, op, dp, live_tx, nrm,
                                                exclude=swept[p, :-1])
            occ_p |= cluster_sweep_any(cm, ids, counts, keys, op, dp,
                                       live_tx, tnp)
            occ.view(nb, BLOCK)[p] = occ_p.view(-1, BLOCK)
            swept[p] = _mark_swept(swept[p], cand)
            res = torch.zeros_like(res)
            res.view(nb, BLOCK)[p] = _occ_residual(
                counts, keys, occ_p, live_tx).view(-1, BLOCK)
    return occ


def two_level_any(cm: ClusteredMesh, org, dirn, tmax, tmin=None,
                  backface_cull: bool = False):
    """Occlusion: (N,) bool, True iff any triangle is hit in (tmin, tmax).
    Up to DENSE_CULL_MAX clusters only: the reference's two_level_any
    always culls with _hier_cull / _dense_cull, and _hier_cull asserts
    c <= 1 << 14 (pallas_cluster.py:1413-1414), so above DENSE_CULL_MAX a
    shadow query fails there and the tree tier serves closest hits only."""
    if cm.n_clusters > DENSE_CULL_MAX:
        raise NotImplementedError(
            f'occlusion above DENSE_CULL_MAX = {DENSE_CULL_MAX} clusters: '
            f'the reference two_level_any fails _hier_cull\'s assertion '
            f'(pallas_cluster.py:1413-1414) there, so the tree tier serves '
            f'closest hits only (ROADMAP Queue 3)')
    n0 = org.shape[0]
    with profiling.span('pt.query', kind='shadow', lanes=n0):
        org, dirn, tmax, tmin = _prepare(cm, org, dirn, tmax, tmin)
        tx = root_exit_clamp(cm.bounds, org, dirn, tmax)
        occ = _any_rounds(cm, org, dirn, tx, tmin,
                          cm.nrm if backface_cull else None)
    return occ[:n0]
