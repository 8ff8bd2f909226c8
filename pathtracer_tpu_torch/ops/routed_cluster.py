"""Ray -> cluster routed sweeps: the per-lane variant of the cluster tier
(counterpart of pathtracer_tpu/ops/routed_cluster.py; a mesh takes it with
`upload_mesh(use_routed=True)`).

two_level_hit sweeps, per packet, the union of the clusters its lanes
enter.  The routed form inverts the loop:

  1. cull once (cluster.cluster_cull: the torch culls up to
     DENSE_CULL_MAX clusters, the tree cull kernel above);
  2. per lane, the slab entries of its packet's first `ks` slots
     (`_lane_entries`), and each round the nearest live one;
  3. route (`_route_and_sweep`): a stable sort of the lanes by that
     cluster, each cluster's run padded to BLOCK lanes, every run swept as
     a one-slot packet by the unchanged cluster.cluster_sweep (one launch
     a round), the results scattered back to ray order;
  4. seal: the ordinary packet sweep of the first cull's slot tables with
     each lane's tightened t, which finds a nearer hit in a lane's other
     clusters; then `refine_rounds` re-culls of the packets holding
     residual lanes (a packet overflowed MAXC and the lane's t is beyond
     its last kept key), as the tree tier does.  Lanes still residual go
     to the caller's exact fallback (scene.py: traverse.bvh_hit_sparse).

No backface cull applies, in the cull or in the sweeps, as in JAX.

Two of JAX's static-shape layouts go.  Its runs fill a fixed capacity of
n + C * BLOCK lanes (`routed_cluster.py:122`); here a round reads the
padded total once on the host and launches exactly the run packets that
hold lanes, so every lane's result is the same and no packet is empty.
Its `_sweep_full` chunking bounds the TPU's scalar memory; the sweep
kernel here takes every packet in one launch.

ROUTE_LOG: a list here receives one dict per routed_hit call: 'runs' and
'lanes' (run packets and routed lanes, per round), 'refined' (packets
re-culled, per refine round) and 'residual' (lanes left to the fallback).
"""

from __future__ import annotations

import torch

from . import cluster

BIG_T = cluster.BIG_T
BLOCK = cluster.BLOCK
MAXC = cluster.MAXC

ROUTE_LOG = None


def _lane_entries(bounds, ids, org, dirn, tmax, ks: int):
    """Per-lane slab entries of each packet's first `ks` emitted slots:
    (ent (N, ks) f32, BIG_T where the lane does not enter the slot's
    cluster before its tmax or the slot is empty; cid (N, ks) int32, the
    slot's cluster, -1 where empty).  The arithmetic is JAX's, operation
    for operation."""
    nb = ids.shape[0]
    idk = ids[:, :ks]                                     # (nb, ks)
    box = bounds[idk.clamp_min(0).long()]                 # (nb, ks, 6)
    o = org.view(nb, 1, BLOCK, 3)
    iv = 1.0 / dirn.view(nb, 1, BLOCK, 3)
    lo = box[:, :, None, 0:3]
    hi = box[:, :, None, 3:6]
    t1 = (lo - o) * iv
    t2 = (hi - o) * iv
    near = torch.minimum(t1, t2)
    far = torch.maximum(t1, t2)
    tmin = torch.maximum(near[..., 0], torch.maximum(near[..., 1],
                                                     near[..., 2]))
    tmx = torch.minimum(far[..., 0], torch.minimum(far[..., 1], far[..., 2]))
    entry = torch.clamp_min(tmin, 0.0)                    # (nb, ks, B)
    live = ((tmx >= entry) & (tmin < tmax.view(nb, 1, BLOCK))
            & (idk >= 0)[:, :, None])
    ent = torch.where(live, entry, torch.full_like(entry, BIG_T))
    ent = ent.transpose(1, 2).reshape(-1, ks)
    cid = idk[:, None, :].expand(nb, BLOCK, ks).reshape(-1, ks)
    return ent, cid


def _nearest_slot(ent):
    """Per lane, the smallest entry and its first slot (jnp.argmin's tie
    rule, stated as a scan)."""
    e_min = ent[:, 0]
    j = torch.zeros(ent.shape[0], dtype=torch.int64, device=ent.device)
    for k in range(1, ent.shape[1]):
        better = ent[:, k] < e_min
        e_min = torch.where(better, ent[:, k], e_min)
        j = torch.where(better, torch.full_like(j, k), j)
    return e_min, j


def run_layout(cid, n_clusters: int):
    """The run packets of one round: lanes sorted stably by cluster
    (`n_clusters` marks a lane routed nowhere), each cluster's run padded
    to BLOCK lanes.  Returns (cluster of each run packet (nb_runs,) int64,
    ray of each run lane (nb_runs * BLOCK,) int64, valid (same) bool):
    JAX's layout without its empty capacity."""
    c = n_clusters
    dev = cid.device
    n = cid.shape[0]
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=c + 1)[:c]
    zero = torch.zeros(1, dtype=counts.dtype, device=dev)
    off = torch.cat([zero, counts.cumsum(0)])
    padded = (counts + BLOCK - 1) // BLOCK * BLOCK
    pad_off = torch.cat([zero, padded.cumsum(0)])
    nb_runs = int(pad_off[-1]) // BLOCK                   # one host read
    starts = torch.arange(nb_runs, device=dev) * BLOCK
    # the run is constant inside a block: one search a block; right=True
    # lands on the non-empty cluster where empty ones share its boundary
    c_b = torch.searchsorted(pad_off, starts, right=True) - 1
    rank = (starts - pad_off[c_b])[:, None] \
        + torch.arange(BLOCK, device=dev)[None, :]
    valid = rank < counts[c_b][:, None]
    src = (off[c_b][:, None] + rank).clamp(max=max(n - 1, 0))
    return c_b, order[src].reshape(-1), valid.reshape(-1)


def _route_and_sweep(cm, org, dirn, tmin, cid, t_cur, tri):
    """Sweep each lane against ONE cluster (cid; n_clusters: none) as
    one-slot run packets; (t, tri) updated where the run found a nearer
    hit.  Returns (t, tri, run packets, routed lanes)."""
    c_b, ray, valid = run_layout(cid, cm.n_clusters)
    nb_runs = c_b.shape[0]
    if nb_runs == 0:
        return t_cur, tri, 0, 0
    dev = org.device
    ids = torch.full((nb_runs, MAXC), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = c_b.to(torch.int32)
    counts = torch.ones((nb_runs, 1), dtype=torch.int32, device=dev)
    keys = torch.full((nb_runs, MAXC), BIG_T, device=dev)
    keys[:, 0] = 0.0
    tmax_p = torch.where(valid, t_cur[ray], torch.full_like(valid, -1.0,
                                                            dtype=t_cur.dtype))
    t_p, tri_p = cluster.cluster_sweep(cm, ids, counts, keys, org[ray],
                                       dirn[ray], tmax_p, tmin[ray])
    # every routed lane sits in exactly one run lane: a unique scatter
    lane = ray[valid]
    t_c = t_cur.clone()
    tri_c = tri.clone()
    t_c[lane] = t_p[valid]
    tri_c[lane] = tri_p[valid]
    win = t_c < t_cur
    return (torch.where(win, t_c, t_cur), torch.where(win, tri_c, tri),
            nb_runs, int(lane.shape[0]))


def _seal(cm, ids, counts, keys, org, dirn, t_cur, tri, tmin):
    """The packet sweep of the slot tables at each lane's current t."""
    t_s, tri_s = cluster.cluster_sweep(cm, ids, counts, keys, org, dirn,
                                       t_cur, tmin)
    win = t_s < t_cur
    return torch.where(win, t_s, t_cur), torch.where(win, tri_s, tri)


def _refine(cm, org, dirn, tmin, t, tri, res, refine_rounds, log):
    """Re-cull the packets holding residual lanes with their per-lane t and
    sweep them (JAX's refine rounds; a packet without residual lanes
    cannot change in a re-cull, and none of its lanes turns residual)."""
    nb = org.shape[0] // BLOCK
    rows = cluster._packet_rows
    for _ in range(refine_rounds):
        p = res.view(nb, BLOCK).any(dim=1).nonzero()[:, 0]
        if p.numel() == 0:
            break
        if log is not None:
            log['refined'].append(int(p.numel()))
        op, dp, tp, trp = (rows(x, p) for x in (org, dirn, t, tri))
        ids, counts, keys = cluster.cluster_cull(cm, op, dp, tp)
        t2, tri2 = _seal(cm, ids, counts, keys, op, dp, tp, trp,
                         rows(tmin, p))
        t.view(nb, BLOCK)[p] = t2.view(-1, BLOCK)
        tri.view(nb, BLOCK)[p] = tri2.view(-1, BLOCK)
        res = torch.zeros_like(res)
        res.view(nb, BLOCK)[p] = cluster._residual_lanes(
            counts, keys, t2).view(-1, BLOCK)
    return t, tri, res


def routed_hit(cm: cluster.ClusteredMesh, org, dirn, tmax, tmin=None,
               rounds: int = 1, ks: int = 8, refine_rounds: int = 1,
               return_residual: bool = False, soup=None,
               with_bary: bool = True):
    """Closest hit by routed per-lane sweeps and a packet seal, with
    two_level_hit's contract: t (the caller's tmax on a miss), tri (the
    global BVH position, -1 on a miss), then with `with_bary` the winner's
    (alpha, beta) from `soup` (None: cluster.flat_soup of the mesh), and
    with `return_residual` the (N,) bool lanes the refine rounds left
    unresolved, which the caller must send to an exact fallback.  `tmin`:
    an optional per-lane strict floor.  `rounds` routed rounds, each over
    every lane's next-nearest of its packet's first `ks` slots."""
    n0 = org.shape[0]
    org, dirn, tmax, tmin = cluster._prepare(cm, org, dirn, tmax, tmin)
    tx = cluster.root_exit_clamp(cm.bounds, org, dirn, tmax)
    ids, counts, keys = cluster.cluster_cull(cm, org, dirn, tx)
    ent, cid_k = _lane_entries(cm.bounds, ids, org, dirn, tx, ks)
    log = None if ROUTE_LOG is None else dict(runs=[], lanes=[], refined=[])

    t = tx
    tri = torch.full(tx.shape, -1, dtype=torch.int32, device=org.device)
    for _ in range(rounds):
        # this round's per-lane nearest live slot, consumed afterwards
        e_min, j = _nearest_slot(ent)
        cid = cid_k.gather(1, j[:, None])[:, 0].long()
        cid = torch.where((e_min < t) & (cid >= 0), cid,
                          torch.full_like(cid, cm.n_clusters))
        ent = ent.scatter(1, j[:, None], BIG_T)
        t, tri, n_runs, n_lanes = _route_and_sweep(cm, org, dirn, tmin, cid,
                                                   t, tri)
        if log is not None:
            log['runs'].append(n_runs)
            log['lanes'].append(n_lanes)
    t, tri = _seal(cm, ids, counts, keys, org, dirn, t, tri, tmin)
    res = cluster._residual_lanes(counts, keys, t)
    t, tri, res = _refine(cm, org, dirn, tmin, t, tri, res, refine_rounds,
                          log)
    t = torch.where(tri >= 0, t, tmax)
    if log is not None:
        log['residual'] = int(res.sum())
        ROUTE_LOG.append(log)
    out = (t[:n0], tri[:n0])
    if with_bary:
        if soup is None:
            soup = cluster.flat_soup(cm, dev=org.device)
        out += cluster.recompute_bary(soup, org[:n0], dirn[:n0], out[0],
                                      out[1])
    if return_residual:
        out += (res[:n0],)
    return out
