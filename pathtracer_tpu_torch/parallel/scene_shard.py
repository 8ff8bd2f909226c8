"""Scene-sharded intersection: the geometry partitioned across ranks
(counterpart of pathtracer_tpu/parallel/scene_shard.py).

A mesh too large for one device is partitioned spatially (contiguous
ranges of the BVH build order are spatially coherent), each rank holds
one partition, and per-ray closest hits combine across the 'scene' axis.
Three standalone forms over raw triangles:

  * make_sharded_hit: every rank brute-forces the whole wavefront against
    its partition; an all_gather + argmin picks the winner;
  * make_routed_hit: each rank traverses its partition's own BVH for the
    rays that enter the partition's box only (sorted by octant), then the
    same combine;
  * make_ring_hit: rays and triangles both split 1/D; ray blocks travel
    the ring of ranks carrying their best hit (send/recv in place of
    ppermute), pruned by it in each rank's BVH walk.

And the integrated path: shard_clustered_mesh partitions a cluster-tier
mesh's clusters, and scene/scene.py combines hits (_one_hit), occlusion
(intersect_shadow) and shading rows (_shade_fetch) over the mesh's
`scene_group`.

Unlike the JAX package, where one program holds every partition under a
leading (D,) axis and shard_map hands each device its slice, a rank here
holds only its own partition: `shard_clustered_mesh` returns one mesh per
rank (`localize_scene` binds a rank's to the mesh's scene group), and
JAX's `scene_shard_specs`, a shard_map spec tree, has no counterpart.
The partition forms' arrays keep the leading (D,) axis for a like-for-like
comparison, and each rank reads its own row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from ..ops import bvh as bvh_mod
from ..ops import cluster
from ..ops import traverse
from . import distributed as pd

BIG_T = float(np.float32(1e30))


class ShardedMesh(NamedTuple):
    """(D, Tpad) per-partition triangle soup components + validity mask."""

    soup: traverse.TriSoup     # each leaf (D, Tpad)
    valid: torch.Tensor        # (D, Tpad) bool
    tri_base: torch.Tensor     # (D,) int32: partition offset in BVH order
    order: np.ndarray          # (T,) global BVH order (host)


def _stack_soup(soups, device):
    return traverse.TriSoup(*[torch.stack([s[i] for s in soups]).to(device)
                              for i in range(len(traverse.TriSoup._fields))])


def partition_mesh(tri_verts: np.ndarray, n_shards: int,
                   device=None) -> ShardedMesh:
    """Triangles in spatially coherent equal chunks: contiguous ranges of
    a global BVH build's order, zero-padded to a common length; on
    `device` (None: the card)."""
    device = device_mod.resolve(device)
    t = tri_verts.shape[0]
    fb = bvh_mod.build_bvh(tri_verts)
    ordered = tri_verts[fb.order]
    tpad = -(-t // n_shards)
    pad = n_shards * tpad - t
    if pad:
        ordered = np.concatenate(
            [ordered, np.zeros((pad, 3, 3), np.float32)], axis=0)
    flat = traverse.make_soup(ordered, device='cpu')
    soup = traverse.TriSoup(*[x.reshape(n_shards, tpad).to(device)
                              for x in flat])
    valid = (np.arange(n_shards * tpad) < t).reshape(n_shards, tpad)
    base = (np.arange(n_shards) * tpad).astype(np.int32)
    return ShardedMesh(soup=soup, valid=torch.as_tensor(valid, device=device),
                       tri_base=torch.as_tensor(base, device=device),
                       order=np.array(fb.order))


class ShardedBVH(NamedTuple):
    """Per-partition sub-BVH + soup, node arrays padded to a common
    length; the partition boxes route the rays."""

    soup: traverse.TriSoup     # each leaf (D, Tpad), LOCAL BVH order
    valid: torch.Tensor        # (D, Tpad)
    tri_base: torch.Tensor     # (D,)
    bvh: traverse.BVHArrays    # each leaf (D, Mpad)
    part_lo: torch.Tensor      # (D, 3) partition AABB
    part_hi: torch.Tensor      # (D, 3)
    max_leaf: int              # max over partitions
    order: np.ndarray          # (T,) global spatial order (host)


def partition_mesh_bvh(tri_verts: np.ndarray, n_shards: int,
                       device=None) -> ShardedBVH:
    """partition_mesh's chunks, each with a BVH of its own, so a rank
    traverses log(T/D) nodes instead of brute-forcing its soup.  An empty
    partition gets an inverted box, which routes no ray.  On `device`
    (None: the card)."""
    device = device_mod.resolve(device)
    t = tri_verts.shape[0]
    fb = bvh_mod.build_bvh(tri_verts)
    ordered = tri_verts[fb.order]
    order = np.array(fb.order)       # the cached build's arrays are shared
    tpad = -(-t // n_shards)

    soups, valids, bvhs, n_nodes, max_leafs = [], [], [], [], []
    lo_all, hi_all = [], []
    for d in range(n_shards):
        nv = max(0, min(tpad, t - d * tpad))
        chunk = ordered[d * tpad:d * tpad + nv]
        if nv == 0:
            chunk = np.zeros((1, 3, 3), np.float32)
        lfb = bvh_mod.build_bvh(chunk)
        local = chunk[lfb.order]
        if len(local) < tpad:
            local = np.concatenate(
                [local, np.zeros((tpad - len(local), 3, 3), np.float32)])
        soups.append(traverse.make_soup(local, device='cpu'))
        valids.append(np.arange(tpad) < nv)
        bvhs.append(lfb)
        n_nodes.append(len(lfb.node_a))
        max_leafs.append(lfb.max_leaf)
        if nv:
            lo_all.append(local[:nv].reshape(-1, 3).min(0))
            hi_all.append(local[:nv].reshape(-1, 3).max(0))
            # this partition's slice of the global order, in local order
            order[d * tpad:d * tpad + nv] = \
                order[d * tpad:d * tpad + nv][lfb.order]
        else:
            lo_all.append(np.full(3, BIG_T, np.float32))
            hi_all.append(np.full(3, -BIG_T, np.float32))

    mpad = max(n_nodes)

    def pad_nodes(get, fill, dtype):
        out = np.stack([
            np.concatenate([get(f).astype(dtype),
                            np.full((mpad - n,), fill, dtype)])
            for f, n in zip(bvhs, n_nodes)])
        return torch.as_tensor(out, device=device)

    f32 = np.float32
    bvh = traverse.BVHArrays(
        lo_x=pad_nodes(lambda f: f.node_lo[:, 0], BIG_T, f32),
        lo_y=pad_nodes(lambda f: f.node_lo[:, 1], BIG_T, f32),
        lo_z=pad_nodes(lambda f: f.node_lo[:, 2], BIG_T, f32),
        hi_x=pad_nodes(lambda f: f.node_hi[:, 0], -BIG_T, f32),
        hi_y=pad_nodes(lambda f: f.node_hi[:, 1], -BIG_T, f32),
        hi_z=pad_nodes(lambda f: f.node_hi[:, 2], -BIG_T, f32),
        a=pad_nodes(lambda f: f.node_a, 0, np.int32),
        b=pad_nodes(lambda f: f.node_b, 0, np.int32),
        leaf=pad_nodes(lambda f: f.node_leaf, True, bool),
    )
    base = (np.arange(n_shards) * tpad).astype(np.int32)
    return ShardedBVH(
        soup=_stack_soup(soups, device),
        valid=torch.as_tensor(np.stack(valids), device=device),
        tri_base=torch.as_tensor(base, device=device), bvh=bvh,
        part_lo=torch.as_tensor(np.stack(lo_all), device=device),
        part_hi=torch.as_tensor(np.stack(hi_all), device=device),
        max_leaf=int(max(max_leafs)), order=order)


def _group_and_rank(mesh, axis):
    group = mesh.groups[axis]
    return group, (0 if group is None else dist.get_rank(group))


def _local(sm, r):
    """Rank r's soup and (for a ShardedBVH) BVH."""
    soup = traverse.TriSoup(*[x[r] for x in sm.soup])
    bvh = (traverse.BVHArrays(*[x[r] for x in sm.bvh])
           if isinstance(sm, ShardedBVH) else None)
    return soup, bvh


def _mask_valid(t, tri, valid, base):
    """Padded triangles never win; local ids become global ones."""
    ok = (tri >= 0) & valid[tri.clamp_min(0).long()]
    return (torch.where(ok, t, torch.full_like(t, BIG_T)),
            torch.where(ok, tri + base, torch.full_like(tri, -1)))


def _enters(lo, hi, org, dirn):
    """Slab test of the rays against one box: (t_enter, t_exit) as the
    JAX package's routing computes them."""
    inv = 1.0 / dirn
    zero = dirn == 0.0
    t1 = (lo[None, :] - org) * inv
    t2 = (hi[None, :] - org) * inv
    inside = (org >= lo[None, :]) & (org <= hi[None, :])
    big = torch.full_like(t1, BIG_T)
    lo_t = torch.where(zero, torch.where(inside, -big, big),
                       torch.minimum(t1, t2))
    hi_t = torch.where(zero, torch.where(inside, big, -big),
                       torch.maximum(t1, t2))
    return torch.clamp_min(lo_t.amax(-1), 0.0), hi_t.amin(-1)


def make_sharded_hit(mesh, axis: str = 'scene'):
    """(ShardedMesh, org, dirn) -> (t, global tri): rays replicated, each
    rank brute-forces its partition, an all_gather + argmin combines."""
    def run(sm: ShardedMesh, org, dirn):
        group, r = _group_and_rank(mesh, axis)
        soup, _ = _local(sm, r)
        mh = traverse.brute_force_hit(soup, org, dirn)
        t, gtri = _mask_valid(mh.t, mh.tri, sm.valid[r],
                              sm.tri_base[r])
        return pd.group_closest(t, gtri, group)

    return run


def make_routed_hit(mesh, max_leaf: int, axis: str = 'scene',
                    block: int = 4096):
    """(ShardedBVH, org, dirn) -> (t, global tri): each rank sorts the
    rays by (enters my partition's box, direction octant), stably, and
    walks its own BVH (traverse.bvh_hit) over the blocks of `block` rays
    that hold the entering prefix; then the all_gather + argmin."""
    def run(sm: ShardedBVH, org, dirn):
        group, r = _group_and_rank(mesh, axis)
        soup, bvh = _local(sm, r)
        n = org.shape[0]
        t_enter, t_exit = _enters(sm.part_lo[r],
                                  sm.part_hi[r], org, dirn)
        enters = t_exit >= t_enter
        octant = ((dirn[:, 0] < 0).to(torch.int32)
                  + 2 * (dirn[:, 1] < 0).to(torch.int32)
                  + 4 * (dirn[:, 2] < 0).to(torch.int32))
        key = torch.where(enters, octant, torch.full_like(octant, 8))
        idx = torch.sort(key, stable=True).indices
        live = int(enters.sum())
        t_c = torch.full((n,), BIG_T, device=org.device)
        tri_c = torch.full((n,), -1, dtype=torch.int32, device=org.device)
        org_c, dir_c = org[idx], dirn[idx]
        for k0 in range(0, live, block):
            sl = slice(k0, min(k0 + block, n))
            mh = traverse.bvh_hit(bvh, soup, org_c[sl], dir_c[sl],
                                  max_leaf=max_leaf)
            t_c[sl], tri_c[sl] = mh.t, mh.tri
        t = torch.empty_like(t_c)
        tri = torch.empty_like(tri_c)
        t[idx], tri[idx] = t_c, tri_c
        t, gtri = _mask_valid(t, tri, sm.valid[r],
                              sm.tri_base[r])
        return pd.group_closest(t, gtri, group)

    return run


def make_ring_hit(mesh, max_leaf: int, axis: str = 'scene'):
    """(ShardedBVH, org, dirn) -> (t, global tri) with rays AND triangles
    split 1/D: rank p starts with ray block p (the rays zero-padded to a
    multiple of D); each of D steps intersects the visiting block with
    the local BVH, pruned by the block's carried best t, and passes the
    block with its best (t, tri) to the next rank.  After D shifts every
    block is home; the blocks are gathered so that every rank returns
    the whole (n,) result, as the JAX function's sharded output."""
    def run(sm: ShardedBVH, org, dirn):
        group, r = _group_and_rank(mesh, axis)
        ndev = 1 if group is None else dist.get_world_size(group)
        soup, bvh = _local(sm, r)
        lo, hi = sm.part_lo[r], sm.part_hi[r]
        valid, base = sm.valid[r], sm.tri_base[r]
        n = org.shape[0]
        nb = -(-n // ndev)
        pad = nb * ndev - n
        if pad:
            org = torch.cat([org, torch.zeros((pad, 3), dtype=org.dtype,
                                              device=org.device)])
            dirn = torch.cat([dirn, torch.ones((pad, 3), dtype=dirn.dtype,
                                               device=dirn.device)])
        o, d = org[r * nb:(r + 1) * nb], dirn[r * nb:(r + 1) * nb]
        t = torch.full((nb,), BIG_T, device=org.device)
        gtri = torch.full((nb,), -1, dtype=torch.int32, device=org.device)
        for _ in range(ndev):
            t_enter, t_exit = _enters(lo, hi, o, d)
            enters = (t_exit >= t_enter) & (t_enter < t)
            # lanes that do not enter walk with best 0: pruned at the root
            mh = traverse.bvh_hit(bvh, soup, o, d, max_leaf=max_leaf,
                                  t_init=torch.where(enters, t,
                                                     torch.zeros_like(t)))
            ok = (mh.tri >= 0) & valid[mh.tri.clamp_min(0).long()]
            win = enters & ok & (mh.t < t)
            t = torch.where(win, mh.t, t)
            gtri = torch.where(win, mh.tri + base, gtri)
            o, d, t, gtri = pd.ring_shift((o, d, t, gtri), group)
        return (pd.group_gather(t, group).reshape(-1)[:n],
                pd.group_gather(gtri, group).reshape(-1)[:n])

    return run


def _dummy_top(dev) -> dict:
    """A one-leaf top tree: a partition never takes the tree cull
    (c_pad <= DENSE_CULL_MAX), as the JAX package's 1-node dummies."""
    return cluster._top_fields(np.zeros((1, 6), np.float32), [0], [1], [1],
                               [0], dev)


def _shard_bounds(starts, t_total, c, n_shards):
    """Cluster-aligned partition bounds balancing triangles, not cluster
    indices (an index split skewed rows 3.8x across shards in JAX), and
    the partitions' shade_pack row ranges."""
    starts_ext = np.concatenate([starts, [t_total]]).astype(np.int64)
    targets = np.linspace(0, t_total, n_shards + 1)
    bounds = np.searchsorted(starts_ext, targets, side='left')
    bounds = np.clip(bounds, 0, c)
    bounds[0], bounds[-1] = 0, c
    bounds = np.maximum.accumulate(bounds)
    row_b = np.concatenate([starts_ext[bounds[:-1]],
                            [t_total]]).astype(np.int64)
    return bounds, row_b


def shard_clustered_mesh(mesh_arrays, n_shards: int, group=None):
    """The integrated scene-axis path: partition a cluster-tier mesh's
    CLUSTERS over n_shards ranks.  Returns one MeshArrays per rank, each
    holding:

      * a contiguous cluster range (contiguous BVH order, so spatially
        coherent) balancing triangles, padded to the common count c_pad
        with inert clusters: inverted boxes (never culled in, so never
        swept), zero starts, sub-boxes, planes and normal bounds;
      * its rows [shard_row0, shard_row0 + shard_rows) of the shade_pack,
        zero-padded to the largest partition's row count;
      * the whole mesh's triangle ids (cluster starts stay global BVH
        positions), so partition winners combine by t alone.

    No soup, BVH or top tree is kept (a one-leaf dummy: c_pad <=
    DENSE_CULL_MAX, the dense cull serves every partition).  `group` is
    the scene axis' process group (None: bind later, localize_scene).
    The partitions are slices of the built mesh's tensors, on its device;
    nothing goes through the host-build cache."""
    m = mesh_arrays
    assert m.use_cluster and m.clustered is not None, \
        'scene axis needs the cluster tier'
    if m.use_routed:
        raise NotImplementedError(
            'a scene-axis partition of a routed mesh (use_routed=True) is '
            'not ported (ROADMAP Queue 1 item 13): upload the mesh without '
            'use_routed to partition it')
    assert m.shade_pack is not None and m.col('bary') is not None, \
        'scene axis needs the packed bary columns'
    cm = m.clustered
    c = cm.n_clusters
    t_total = int(m.shade_pack.shape[0])
    bounds, row_b = _shard_bounds(cm.starts.cpu().numpy().astype(np.int64),
                                  t_total, c, n_shards)
    c_pad = int(np.max(np.diff(bounds)))
    r_pad = int(np.max(np.diff(row_b)))
    assert c_pad <= cluster.DENSE_CULL_MAX
    dev = cm.ctab.device
    inert = torch.tensor([BIG_T] * 3 + [-BIG_T] * 3 + [0.0] * 6, device=dev)
    top = _dummy_top(dev)

    def pad(x, b0, b1, n, fill=None):
        out = (x.new_zeros((n,) + x.shape[1:]) if fill is None
               else fill.expand((n,) + x.shape[1:]).clone())
        out[:b1 - b0] = x[b0:b1]
        return out

    shards = []
    for d in range(n_shards):
        b0, b1 = int(bounds[d]), int(bounds[d + 1])
        r0, r1 = int(row_b[d]), int(row_b[d + 1])
        part = cluster.ClusteredMesh(
            ctab=pad(cm.ctab, b0, b1, c_pad, inert),
            starts=pad(cm.starts, b0, b1, c_pad),
            sub_bounds=pad(cm.sub_bounds, b0, b1, c_pad),
            planes=pad(cm.planes, b0, b1, c_pad),
            nrm=pad(cm.nrm, b0, b1, c_pad), **top)
        shards.append(m.replace(
            clustered=part, shade_pack=pad(m.shade_pack, r0, r1, r_pad),
            soup=None, bvh=None, packed=None, use_brute=False,
            use_packet=False, scene_group=group, shard_row0=r0,
            shard_rows=r1 - r0))
    return shards


def localize_scene(sc, mesh, axis: str = 'scene'):
    """Bind the scene's partitions (meshes with shard_row0 set) to the
    mesh's scene group; call before tracing a scene-axis scene.  The
    JAX function strips the leading (1,) shard axis inside shard_map;
    here a rank already holds only its partition."""
    group = mesh.groups.get(axis)
    if not any(m.shard_row0 is not None for m in sc.meshes):
        return sc
    if group is None:
        raise ValueError('a scene-axis mesh needs a mesh with a scene '
                         'process group')
    return sc.replace(meshes=tuple(
        m.replace(scene_group=group) if m.shard_row0 is not None else m
        for m in sc.meshes))


def scene_axis_comm_model(n_rays: int, d: int, n_bounces: int,
                          shade_width: int):
    """Per-WAVE communication account of the scene-sharded render path
    (bytes per device):

      * closest hit: all_gather of (t f32, tri i32) over the axis
        (scene._one_hit) — each device receives (d-1)*N*8 bytes;
      * shadow any: sum of an i32 occlusion mask (scene.intersect_shadow)
        — ring cost 2*(d-1)/d*N*4 bytes;
      * shading row: sum of the winner's packed shade row
        (scene._shade_fetch) — 2*(d-1)/d*N*shade_width*4.

    Compute per device shrinks ~1/d while communication per device grows
    ~(d-1)/d * const; the crossover sets the useful scene-axis width."""
    n = n_rays
    ag_closest = (d - 1) * n * 8 * n_bounces
    ps_shadow = int(2 * (d - 1) / d * n * 4) * n_bounces
    ps_shade = int(2 * (d - 1) / d * n * shade_width * 4) * n_bounces
    total = ag_closest + ps_shadow + ps_shade
    return {
        'n_rays': n, 'devices': d, 'bounces': n_bounces,
        'shade_width': shade_width,
        'allgather_closest_bytes': ag_closest,
        'psum_shadow_bytes': ps_shadow,
        'psum_shade_bytes': ps_shade,
        'total_bytes_per_device_per_wave': total,
        'comm_bytes_per_ray_bounce': total / max(n * n_bounces, 1),
    }


def scene_axis_scaling_model(rays_per_s_1chip: float, d: int,
                             n_bounces: int, shade_width: int,
                             ici_bytes_per_s: float = 4.5e10):
    """Crude compute/communication ratio for the scene axis at width d:
    compute per ray-bounce shrinks to 1/d of one device's (balanced
    partitions), communication per ray-bounce comes from
    scene_axis_comm_model over `ici_bytes_per_s` of link bandwidth (the
    JAX package's default, kept for the comparison; not a figure of any
    GPU link).  Returns the modeled speedup over one device and the
    communication fraction."""
    cm = scene_axis_comm_model(1_000_000, d, n_bounces, shade_width)
    comm_s_per_ray_bounce = (cm['comm_bytes_per_ray_bounce']
                             / ici_bytes_per_s)
    base_s_per_ray_bounce = 1.0 / rays_per_s_1chip
    per_ray = base_s_per_ray_bounce / d + comm_s_per_ray_bounce
    speedup = base_s_per_ray_bounce / per_ray
    return {
        'devices': d,
        'modeled_speedup_vs_1chip': speedup,
        'comm_fraction': comm_s_per_ray_bounce / per_ray,
        'ici_bytes_per_s': ici_bytes_per_s,
    }


def shard_from_numpy_arrays(clustered, rank: int, dev) -> cluster.ClusteredMesh:
    """Rank `rank`'s ClusteredMesh from a JAX scene-axis mesh's cluster
    tuple as numpy (each of the 18 arrays with a leading (D,) axis): the
    packed records re-laid out by cluster.from_tpu_arrays, with the
    cluster boxes read from the bound arrays (the inert padding clusters'
    inverted boxes live there; their packed rows are zero) and the
    one-leaf top tree."""
    a = [np.asarray(x)[rank] for x in clustered]
    dummy = [np.zeros(1, np.float32)] * 6 + [np.zeros(1, np.int32),
                                             np.ones(1, np.int32),
                                             np.ones(1, np.int32),
                                             np.zeros(1, np.int32)]
    cm = cluster.from_tpu_arrays(dummy + a[10:], dev)
    cm.ctab[:, 0:6] = torch.as_tensor(np.stack(a[10:16], axis=1), device=dev)
    return cm
