"""The exact plain references of the tree cull and the packet walk, on the
CPU (the CUDA kernels are held to them bit for bit in
tests/test_torch_gpu.py and chip_smoke.py):

  * `cull_tree_plain`'s counters (inner nodes expanded, leaves reached,
    clusters emitted) equal a depth-first walk of the top tree written
    here in numpy, one packet at a time, descending wherever any lane's
    slab is live: the walk expands the root and exactly the inner nodes
    some lane is live for, whatever its order; and a ray dead (not NaN)
    at a node is dead at its children, the premise of the kernel's ray
    masks;
  * `packet_walk_plain` against a scalar numpy statement of one ray's walk
    (hits and counters equal), against JAX's `pallas_bvh.packet_hit_packed`
    in interpret mode and against the brute-force `packet_hit_plain`:
    tri equal on every lane, t within 1e-5 relative and the barycentrics
    within 1e-4 (another framework's rounding); and one pinned ray in the
    plane of a leaf box's face, which the walk's conservative slab test
    keeps (csrc/packet_bvh.cu);
  * the child-pair records decode back to box / na / nb / nleaf, for the
    packet tier's BVH and for the cluster tier's top tree.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.ops import bvh as jbvh
from pathtracer_tpu.ops import pallas_bvh as jpb
from pathtracer_tpu.ops import traverse as jtr
from pathtracer_tpu_torch.ops import bvh as tbvh
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import packet_bvh as tpb
from pathtracer_tpu_torch.ops import traverse as ttr

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tiers import _mixed_rays, _random_mesh, _sphere_tris

BIG_T = np.float32(1e30)
F32 = np.float32


def _slab(box, o, inv):
    """numpy float32 slab test of one box against rays: (tmin, tmax), the
    kernels' operation order, NaN propagated as torch.minimum does."""
    tmin = tmx = None
    for k in range(3):
        t1 = (box[k] - o[..., k]) * inv[..., k]
        t2 = (box[k + 3] - o[..., k]) * inv[..., k]
        lo_, hi_ = np.minimum(t1, t2), np.maximum(t1, t2)
        tmin = lo_ if tmin is None else np.maximum(tmin, lo_)
        tmx = hi_ if tmx is None else np.minimum(tmx, hi_)
    return tmin, tmx


# ---------------------------------------------------------------------------
# (a) the tree cull's counters
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module', params=[(9000, 5), (30000, 6)],
                ids=['9k', '30k'])
def top_tree(request):
    t, seed = request.param
    cm = tc.build_clustered(_random_mesh(t, seed), tris_c=tc.SUBT, dev='cpu')
    return cm, seed


def _dfs_counts(cm, o, d, tm):
    """One packet: depth-first over the top tree, entering a child where
    any lane is live; (inner nodes expanded, leaves reached, clusters)."""
    box = cm.top_box.numpy()
    a, b = cm.top_a.numpy(), cm.top_b.numpy()
    leaf = cm.top_leaf.numpy() != 0
    with np.errstate(divide='ignore', invalid='ignore', over='ignore'):
        inv = F32(1.0) / d

        def live(node):
            tmin, tmx = _slab(box[node], o, inv)
            return bool(((tmx >= np.maximum(tmin, F32(0.0)))
                         & (tmin < tm)).any())

        inner = leaves = clusters = 0
        if leaf[0]:
            return 0, int(live(0)), int(b[0]) if live(0) else 0
        stack = [0]
        while stack:
            node = stack.pop()
            inner += 1
            for child in (b[node], a[node]):
                if not live(child):
                    continue
                if leaf[child]:
                    leaves += 1
                    clusters += int(b[child])
                else:
                    stack.append(child)
    return inner, leaves, clusters


def test_cull_tree_plain_counts_equal_a_dfs(top_tree):
    cm, seed = top_tree
    n = 3 * tc.BLOCK
    o, d = _mixed_rays(n, seed + 300)
    tmax = np.full((n,), BIG_T, np.float32)
    tmax[::89] = -1.0                                  # dead lanes
    tmax[2 * tc.BLOCK:] = 6.0                          # a short packet
    work = torch.zeros((n // tc.BLOCK, tc.CULL_WORK), dtype=torch.int64)
    ids, count, keys = tc.cull_tree(cm, torch.as_tensor(o),
                                    torch.as_tensor(d), torch.as_tensor(tmax),
                                    work=work)
    want = [_dfs_counts(cm, o[p:p + tc.BLOCK], d[p:p + tc.BLOCK],
                        tmax[p:p + tc.BLOCK]) for p in range(0, n, tc.BLOCK)]
    np.testing.assert_array_equal(work[:, :3].numpy(), np.array(want))
    np.testing.assert_array_equal(work[:, 2].numpy(), count[:, 0].numpy())
    assert (work[:, 3:] == 0).all()                    # kernel only
    assert work[0, 0] > 1 and work[0, 1] > 0           # non-vacuous
    # the kept slots: sorted by (key, cluster id), the smallest pairs
    for p in range(n // tc.BLOCK):
        m = min(int(count[p, 0]), tc.MAXC)
        k, i = keys[p, :m].numpy(), ids[p, :m].numpy()
        assert (np.diff(k) >= 0).all()
        assert all((k[j], i[j]) < (k[j + 1], i[j + 1]) for j in range(m - 1))


def test_dead_ray_stays_dead_below(top_tree):
    """The premise of the tree cull kernel's ray masks: a ray whose slab
    test at a node is dead and not NaN is dead at both children (a child's
    box lies inside its parent's, and the rounded slab interval narrows
    with the box), so the kernel tests a node only on the rays its parent
    kept."""
    cm, seed = top_tree
    n = 4 * tc.BLOCK
    o, d = _mixed_rays(n, seed + 500)
    tm = np.full((n,), BIG_T, np.float32)
    tm[::7] = 5.0                                      # short lanes
    box = cm.top_box.numpy()
    a, b = cm.top_a.numpy(), cm.top_b.numpy()
    inner = np.flatnonzero(cm.top_leaf.numpy() == 0)
    with np.errstate(divide='ignore', invalid='ignore', over='ignore'):
        inv = F32(1.0) / d

        def test(node):
            tmin, tmx = _slab(box[node], o, inv)
            live = (tmx >= np.maximum(tmin, F32(0.0))) & (tmin < tm)
            return live, live | np.isnan(tmin)

        checked = 0
        for p in inner:
            _, keep = test(p)
            for c in (a[p], b[p]):
                live, _ = test(c)
                assert not (live & ~keep).any(), (p, c)
                checked += int(live.sum())
    assert checked > 0                                 # non-vacuous


# ---------------------------------------------------------------------------
# (b) the packet walk
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def walk_bvh():
    """The 2k mesh scene's sphere in both packages and 2048 rays, half
    camera-like, half incoherent (tests/test_torch_tiers.py small_bvh)."""
    tri = _sphere_tris()
    fj, ft = jbvh.build_bvh(tri), tbvh.build_bvh(tri)
    n = 2048
    rng = np.random.default_rng(41)
    dc = np.stack([rng.uniform(-0.4, 0.4, n // 2),
                   rng.uniform(-0.4, 0.4, n // 2), -np.ones(n // 2)], -1)
    oc = np.tile([0.0, 0.0, 40.0], (n // 2, 1))
    oi, di = _mixed_rays(n // 2, seed=42, radius=20.0)
    o = np.concatenate([oc, oi]).astype(np.float32)
    d = np.concatenate([dc / np.linalg.norm(dc, axis=1, keepdims=True),
                        di]).astype(np.float32)
    tmax = np.full((n,), BIG_T, np.float32)
    tmax[::5] = 30.0                                   # bounded lanes
    return dict(ft=ft, soup_j=jtr.make_soup(tri[fj.order]),
                pk_j=jpb.pack_bvh(fj),
                soup_t=ttr.make_soup(tri[ft.order], device='cpu'),
                pk_t=tpb.pack_bvh(ft, device='cpu'), o=o, d=d, tmax=tmax)


def _walk_slab(box, o, inv):
    """The packet walk's conservative slab (ops/packet_bvh._slab_live) in
    numpy float32: (entry, exit grown by SLAB_GROW); an axis where the ray
    lies in the plane of a face (0 * inf = NaN) holds the whole ray."""
    tmin = tmx = None
    for k in range(3):
        t1 = (box[k] - o[k]) * inv[k]
        t2 = (box[k + 3] - o[k]) * inv[k]
        lo_, hi_ = np.minimum(t1, t2), np.maximum(t1, t2)
        if np.isnan(lo_) and np.isinf(inv[k]):
            lo_, hi_ = F32(-np.inf), F32(np.inf)
        tmin = lo_ if tmin is None else np.maximum(tmin, lo_)
        tmx = hi_ if tmx is None else np.minimum(tmx, hi_)
    return tmin, tmx * F32(tpb.SLAB_GROW)


def _walk_one(pk, soup, o, d, tmax, tmin):
    """One ray's walk as csrc/packet_bvh.cu states it, in numpy float32:
    (t, tri, alpha, beta, inner nodes, triangle tests)."""
    box, na, nb = pk.box.numpy(), pk.na.numpy(), pk.nb.numpy()
    leaf = pk.nleaf.numpy() != 0
    s = np.stack([x.numpy() for x in soup], 1)
    with np.errstate(divide='ignore', invalid='ignore', over='ignore'):
        inv = F32(1.0) / d
        best, btri, bal, bbe, inner, tests = tmax, -1, F32(1), F32(0), 0, 0
        stack, node = [], 0
        while True:
            if leaf[node]:
                for j in range(na[node], na[node] + nb[node]):
                    tests += 1
                    r = s[j]
                    dn = d[0] * r[9] + d[1] * r[10] + d[2] * r[11]
                    t = ((r[0] - o[0]) * r[9] + (r[1] - o[1]) * r[10]
                         + (r[2] - o[2]) * r[11]) / dn
                    p = [o[k] + t * d[k] - r[k] for k in range(3)]
                    b11 = p[0] * r[3] + p[1] * r[4] + p[2] * r[5]
                    b21 = p[0] * r[6] + p[1] * r[7] + p[2] * r[8]
                    be = (b11 * r[14] - b21 * r[13]) * r[15]
                    ga = (b21 * r[12] - b11 * r[13]) * r[15]
                    al = F32(1) - be - ga
                    if (t >= 0 and be >= 0 and ga >= 0 and al >= 0
                            and t < best and t > tmin):
                        best, btri, bal, bbe = t, j, al, be
            else:
                inner += 1
                la, lb = [
                    bool((tmx >= np.maximum(tmin_, F32(0))) & (tmin_ < best))
                    for tmin_, tmx in (_walk_slab(box[c], o, inv)
                                       for c in (na[node], nb[node]))]
                if la:
                    if lb:
                        stack.append(nb[node])
                    node = na[node]
                    continue
                if lb:
                    node = nb[node]
                    continue
            if not stack:
                return best, btri, bal, bbe, inner, tests
            node = stack.pop()


@pytest.mark.parametrize('with_tmin', [False, True], ids=['tmax', 'tmin'])
def test_packet_walk_plain(walk_bvh, with_tmin):
    w = walk_bvh
    o, d, tmax = w['o'], w['d'], w['tmax']
    n = o.shape[0]
    ot, dt_, tmt = (torch.as_tensor(x) for x in (o, d, tmax))
    tmin = None
    if with_tmin:
        # exclude each lane's first hit, with a margin past it
        first = tpb.packet_hit_plain(w['soup_t'], ot, dt_, tmt)[0].numpy()
        tmin = np.where(first < tmax, first + 1e-3, -1.0).astype(np.float32)
    tnt = None if tmin is None else torch.as_tensor(tmin)
    t, tri, al, be, work = tpb.packet_walk_plain(w['pk_t'], w['soup_t'], ot,
                                                 dt_, tmt, tnt)
    assert (tri >= 0).float().mean().item() > 0.1           # non-vacuous
    # the walk, ray by ray: equal bit for bit, counters included
    tn_np = np.full((n,), -1.0, np.float32) if tmin is None else tmin
    for i in range(0, n, 37):
        want = _walk_one(w['pk_t'], w['soup_t'], o[i], d[i], tmax[i],
                         tn_np[i])
        got = (t[i].item(), tri[i].item(), al[i].item(), be[i].item(),
               work[i, 0].item(), work[i, 1].item())
        assert got == tuple(float(x) if k < 4 and k != 1 else int(x)
                            for k, x in enumerate(want)), i
    # against the TPU packet walk and against brute force: the same tri
    # on every lane (0 of the 2,048 differ in either variant)
    out_j = [np.asarray(x) for x in jpb.packet_hit_packed(
        w['pk_j'], w['soup_j'], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), interpret=True,
        tmin=None if tmin is None else jnp.asarray(tmin))]
    out_b = [x.numpy() for x in tpb.packet_hit_plain(w['soup_t'], ot, dt_,
                                                     tmt, tnt)]
    for t_r, tri_r, al_r, be_r in (out_j, out_b):
        same = tri.numpy() == tri_r
        assert same.all(), np.flatnonzero(~same)
        hit = same & (tri_r >= 0)
        np.testing.assert_allclose(t.numpy()[hit], t_r[hit], rtol=1e-5)
        np.testing.assert_allclose(al.numpy()[hit], al_r[hit], atol=1e-4)
        np.testing.assert_allclose(be.numpy()[hit], be_r[hit], atol=1e-4)


# A ray in the plane of leaf 551's top face (d_y = 0, o_y on the face),
# aimed at the vertex of triangle 916 on that face from 30 units away.
GRAZE_LEAF, GRAZE_TRI = 551, 916


def test_packet_walk_grazing_ray(walk_bvh):
    """The walk's answer on one grazing ray, beside JAX's packet walk and
    brute force.  The slab's y axis is (face - o_y) * inf = NaN there: the
    walk's conservative slab holds the whole ray on that axis and finds the
    vertex at t = 30, as brute force does (the same triangle).  Before the
    conservative slab the walk missed this ray entirely.  JAX's walk hits
    the vertex through a neighbouring triangle (a tie at 2^-16)."""
    w = walk_bvh
    pk, soup = w['pk_t'], w['soup_t']
    box = pk.box.numpy()[GRAZE_LEAF]
    first, cnt = int(pk.na[GRAZE_LEAF]), int(pk.nb[GRAZE_LEAF])
    assert pk.nleaf[GRAZE_LEAF] != 0 and first <= GRAZE_TRI < first + cnt
    rows = np.stack([x.numpy() for x in soup], 1)[GRAZE_TRI]
    verts = np.stack([rows[0:3], rows[0:3] + rows[3:6],
                      rows[0:3] + rows[6:9]])
    v = verts[verts[:, 1] == box[4]][0]          # a vertex on the top face
    d = np.array([np.cos(F32(0.3)), 0.0, np.sin(F32(0.3))], F32)
    o = (v - F32(30.0) * d).astype(F32)
    assert o[1] == box[4] and d[1] == 0.0        # in the face's plane
    o1, d1 = o[None], d[None]
    tmax = np.full((1,), BIG_T, F32)
    ot, dt_, tmt = (torch.as_tensor(x) for x in (o1, d1, tmax))
    t, tri, _, _, _ = tpb.packet_walk_plain(pk, soup, ot, dt_, tmt)
    t_b, tri_b, _, _ = tpb.packet_hit_plain(soup, ot, dt_, tmt)
    t_j, tri_j, _, _ = (np.asarray(x) for x in jpb.packet_hit_packed(
        w['pk_j'], w['soup_j'], jnp.asarray(o1), jnp.asarray(d1),
        jnp.asarray(tmax), interpret=True))
    got = (t.item(), tri.item())
    assert got == (t_b.item(), tri_b.item()) == (30.0, GRAZE_TRI), got
    assert tri_j[0] >= 0 and abs(t_j[0] - 30.0) <= 2.0 ** -16 * 30.0
    assert got == _walk_one(pk, soup, o, d, tmax[0], F32(-1.0))[:2]


# ---------------------------------------------------------------------------
# (c) the child-pair records
# ---------------------------------------------------------------------------

def _decode(pairs, box, na, nb, nleaf):
    """Walk the records from the root and check each child against the
    node arrays; returns the number of records reached."""
    rec = pairs.numpy()
    ints = rec.view(np.int32)
    box, na, nb = box.numpy(), na.numpy(), nb.numpy()
    leaf = nleaf.numpy() != 0
    seen, todo = 0, [(0, 0)]                  # (record, node)
    while todo:
        r, node = todo.pop()
        seen += 1
        assert not leaf[node]
        for side, child in enumerate((na[node], nb[node])):
            np.testing.assert_array_equal(rec[r, 6 * side:6 * side + 6],
                                          box[child])
            if leaf[child]:
                assert ints[r, 12 + side] == na[child]
                assert ints[r, 14 + side] == nb[child] >= 1
            else:
                assert ints[r, 14 + side] == 0
                todo.append((ints[r, 12 + side], child))
    return seen


def test_pair_records_decode(walk_bvh, top_tree):
    pk = walk_bvh['pk_t']
    assert pk.pairs.shape == (int((pk.nleaf == 0).sum()), tpb.PAIR_WORDS)
    assert _decode(pk.pairs, pk.box, pk.na, pk.nb, pk.nleaf) \
        == pk.pairs.shape[0]
    assert pk.depth == walk_bvh['ft'].depth
    cm, _ = top_tree
    assert _decode(cm.top_pairs, cm.top_box, cm.top_a, cm.top_b,
                   cm.top_leaf) == cm.top_pairs.shape[0]
