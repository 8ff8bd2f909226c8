"""PyTorch port, the cluster sweeps' lane groups (ops/cluster.py): the
plain sweep in groups of G rays, G in cluster.GROUPS, on the CPU.

  * the vectorized plain sweep equals a one-unit-at-a-time statement of
    the grouped walk (the CUDA kernel's loop), outputs and counters; at
    G = 512 that statement is the packet walk of the earlier design;
  * every G agrees with G = 512: closest hits under the JAX-parity
    tolerance of tests/test_torch_cluster.py (a smaller group tests a
    subset of the packet's subtiles, so a lane whose own slab test and
    plane test disagree by rounding may differ; ties within 2^-16
    relative t), occlusion on >= 99.9% of lanes;
  * a group never does more than its packet: per packet, the lane x
    subtile rows tested at G are at most those at 512, and no unit
    visits more slots than its packet at 512;
  * a query whose packets span several cull chunks gives, with one
    sweep per round, the chunk-by-chunk results.
The kernel side of these statements runs on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.utils import procgen
from test_torch_cluster import _assert_hits_match, one_torch_thread  # noqa: F401

BIG_T = float(np.float32(1e30))


def _rays(seed):
    """Four packets: one aimed at the sphere's centre (every lane hits),
    one coherent camera packet, two incoherent packets from outside (they
    overflow the slot table)."""
    rng = np.random.default_rng(seed)
    b = tc.BLOCK
    d0 = np.stack([rng.uniform(-0.05, 0.05, b), rng.uniform(-0.05, 0.05, b),
                   -np.ones(b)], -1)
    d1 = np.stack([rng.uniform(-0.4, 0.4, b), rng.uniform(-0.4, 0.4, b),
                   -np.ones(b)], -1)
    o01 = np.tile([0.0, 0.0, 40.0], (2 * b, 1))
    p = rng.normal(size=(2 * b, 3))
    o2 = 14.0 * p / np.linalg.norm(p, axis=1, keepdims=True)
    d2 = rng.normal(size=(2 * b, 3))
    o = np.concatenate([o01, o2])
    d = np.concatenate([d0, d1, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32)),
            torch.as_tensor(d.astype(np.float32)))


@pytest.fixture(scope='module')
def work():
    """80k-tri sphere in clusters of 512 (two subtiles each, more than
    MAXC clusters), the first round's cull of four packets; packet 2's
    count set to exactly MAXC."""
    md = procgen.sphere_mesh(200, 200, radius=12.0, displace_amp=0.25)
    cm = tc.build_clustered(md.vertices[md.vtx_idx], tris_c=512, dev='cpu')
    assert cm.n_sub == 2 and cm.n_clusters > tc.MAXC
    o, d = _rays(41)
    n = o.shape[0]
    tmin = torch.full((n,), -1.0)
    tx = tc.root_exit_clamp(cm.bounds, o, d, torch.full((n,), BIG_T))
    ids, counts, keys, _ = tc._cull_all(cm, o, d, tx, None)
    assert (counts[2:, 0] > tc.MAXC).all()
    counts[2] = tc.MAXC
    lim = torch.where(tx > 0, tx * 0.5, tx)
    lim[:tc.BLOCK] = tx[:tc.BLOCK]
    return cm, (ids, counts, keys, o, d), tx, lim, tmin


def _walk_reference(cm, ids, counts, keys, org, dirn, tmax, tmin, any_hit,
                    group):
    """The grouped sweep one unit at a time, in the order of the kernel's
    walk: per slot the cluster decision, per subtile the subtile decision
    and the plane test, the any-hit exit once every lane is occluded, the
    early break on the next key against the group's max cap.  Returns
    (outputs, (units, 4) counters)."""
    gpp = tc.BLOCK // group
    nu = ids.shape[0] * gpp
    o = org.view(nu, 1, group, 3)
    d = dirn.view(nu, 1, group, 3)
    inv = 1.0 / d
    tn = torch.clamp_min(tmin, 0.0).view(nu, 1, group)
    tx = tmax.view(nu, 1, group)
    best = tmax.clone().view(nu, group)
    btri = torch.full((nu, group), -1, dtype=torch.int32)
    occ = torch.zeros((nu, group), dtype=torch.bool)
    stats = torch.zeros((nu, 4), dtype=torch.int64)
    for u in range(nu):
        b = u // gpp

        def cap():
            if any_hit:
                return torch.where(occ[u], torch.full_like(tx[u][0], -1.0),
                                   tx[u][0])[None]
            return best[u][None]

        cnt = min(int(counts[b, 0]), tc.MAXC)
        done = False
        for k in range(cnt):
            stats[u, 0] += 1
            cid = max(int(ids[b, k]), 0)
            if tc._slab_live(cm.ctab[cid:cid + 1, 0:6], o[u], inv[u],
                             cap()).any():
                stats[u, 1] += 1
                for s in range(cm.n_sub):
                    stats[u, 2] += 1
                    if not tc._slab_live(cm.sub_bounds[cid:cid + 1, s], o[u],
                                         inv[u], cap()).any():
                        continue
                    stats[u, 3] += 1
                    oc = o[u] - cm.ctab[cid, None, None, 6:9]
                    t, ok = tc._subtile_hits(cm.planes[cid:cid + 1, s], oc,
                                             d[u], tn[u])
                    if any_hit:
                        occ[u] |= (ok & (t < cap()[:, :, None])).any(-1)[0]
                        if bool(occ[u].all()):
                            done = True
                            break
                        continue
                    t = torch.where(ok, t, torch.full_like(t, BIG_T))[0]
                    tj, j = t.min(dim=-1)
                    trj = (int(cm.starts[cid]) + s * tc.SUBT + j).to(
                        torch.int32)
                    win = (tj < best[u]) | ((tj == best[u]) & (trj < btri[u]))
                    best[u] = torch.where(win, tj, best[u])
                    btri[u] = torch.where(win, trj, btri[u])
            if done or k + 1 >= cnt or not bool(keys[b, k + 1]
                                                < cap().amax()):
                break
    out = (occ.view(-1),) if any_hit else (best.view(-1), btri.view(-1))
    return out, stats


def _plain(cm, tables, lanes, tmin, any_hit, group):
    ids, counts, keys, o, d = tables
    st = torch.zeros((ids.shape[0] * (tc.BLOCK // group), tc.STATS),
                     dtype=torch.int64)
    fn = tc.cluster_sweep_any_plain if any_hit else tc.cluster_sweep_plain
    out = fn(cm, ids, counts, keys, o, d, lanes, tmin, group=group, stats=st)
    return (out if isinstance(out, tuple) else (out,)), st


@pytest.fixture(scope='module')
def at_512(work):
    cm, tables, tx, lim, tmin = work
    return {any_hit: _plain(cm, tables, lim if any_hit else tx, tmin,
                            any_hit, tc.BLOCK)
            for any_hit in (False, True)}


@pytest.mark.parametrize('group', tc.GROUPS)
def test_plain_sweep_matches_walk_reference(work, group):
    cm, tables, tx, lim, tmin = work
    for any_hit, lanes in ((False, tx), (True, lim)):
        out, st = _plain(cm, tables, lanes, tmin, any_hit, group)
        ref, st_ref = _walk_reference(cm, *tables, lanes, tmin, any_hit,
                                      group)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        assert torch.equal(st[:, :4], st_ref)
        assert bool((st[:, 4] == 0).all())       # cycles: the kernel's only
        assert int(st[:, 3].sum()) > 0
        if any_hit:
            assert bool(out[0][:tc.BLOCK].all())   # packet 0 all occluded
            assert 0.0 < out[0].float().mean().item() < 1.0


@pytest.mark.parametrize('group', [g for g in tc.GROUPS if g < tc.BLOCK])
def test_groups_agree_with_512(work, at_512, group):
    cm, tables, tx, lim, tmin = work
    (t, tri), _ = _plain(cm, tables, tx, tmin, False, group)
    t5, tri5 = at_512[False][0]
    assert (tri5 >= 0).float().mean().item() > 0.3
    _assert_hits_match(t5.numpy(), tri5.numpy(), t, tri)
    (occ,), _ = _plain(cm, tables, lim, tmin, True, group)
    assert (occ == at_512[True][0][0]).float().mean().item() >= 0.999


@pytest.mark.parametrize('group', [g for g in tc.GROUPS if g < tc.BLOCK])
def test_group_counters_within_512(work, at_512, group):
    cm, tables, tx, lim, tmin = work
    gpp = tc.BLOCK // group
    for any_hit, lanes in ((False, tx), (True, lim)):
        _, st = _plain(cm, tables, lanes, tmin, any_hit, group)
        st5 = at_512[any_hit][1]
        rows = st[:, 3].view(-1, gpp).sum(dim=1) * group
        assert bool((rows <= st5[:, 3] * tc.BLOCK).all())
        slots = st[:, 0].view(-1, gpp)
        assert bool((slots <= st5[:, 0:1]).all())
        assert int(rows.sum()) < int(st5[:, 3].sum()) * tc.BLOCK


def test_one_sweep_per_round_matches_chunked(monkeypatch):
    """CHUNK_PACKETS = 2: a six-packet query culls in three chunks and
    sweeps each round once; each chunk queried alone gives the same."""
    monkeypatch.setattr(tc, 'CHUNK_PACKETS', 2)
    md = procgen.sphere_mesh(100, 100, radius=12.0, displace_amp=0.25)
    cm = tc.build_clustered(md.vertices[md.vtx_idx], tris_c=tc.SUBT,
                            dev='cpu')
    rng = np.random.default_rng(42)
    n = 6 * tc.BLOCK
    p = rng.normal(size=(n, 3))
    o = torch.as_tensor((14.0 * p / np.linalg.norm(p, axis=1, keepdims=True))
                        .astype(np.float32))
    d = rng.normal(size=(n, 3))
    d = torch.as_tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                        .astype(np.float32))
    tmax = torch.full((n,), BIG_T)
    lim = torch.as_tensor(rng.uniform(2.0, 40.0, n).astype(np.float32))
    step = tc.CHUNK_PACKETS * tc.BLOCK
    t, tri = tc.two_level_hit(cm, o, d, tmax)
    parts = [tc.two_level_hit(cm, o[i:i + step], d[i:i + step],
                              tmax[i:i + step]) for i in range(0, n, step)]
    assert torch.equal(t, torch.cat([x[0] for x in parts]))
    assert torch.equal(tri, torch.cat([x[1] for x in parts]))
    assert (tri >= 0).float().mean().item() > 0.2
    occ = tc.two_level_any(cm, o, d, lim)
    occ_parts = [tc.two_level_any(cm, o[i:i + step], d[i:i + step],
                                  lim[i:i + step]) for i in range(0, n, step)]
    assert torch.equal(occ, torch.cat(occ_parts))
