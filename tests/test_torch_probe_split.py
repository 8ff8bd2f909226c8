"""PyTorch port, the redesigned sweep probes on the CPU: the edge-matrix
kernel's cut of the reps into ranges and its combine rule
(ops/sweep_micro.edgemat_ranges, edgemat_combine), and the ablation's
lane groups and unit order (ops/sweep_ablate.py).

The CUDA kernels run only on a GPU (tests/test_torch_gpu.py,
chip_smoke.py); here the plain versions state what the kernels compute:
  * `edgemat_plain` over any cut of the reps into ranges, combined by the
    kernel's rule, equals the whole run bit for bit, signed zeros
    included (a case is built where t = -0.0 and t = +0.0 are both
    accepted, in different reps);
  * at a rep count that the kernel's cut does not divide evenly, the cut
    run agrees with the JAX package's `edgemat_kernel` (interpret mode,
    REPS patched) within test_torch_probes.py's edge-matrix tolerance,
    1e-6 relative plus 1e-6 absolute (XLA's CPU code contracts FMAs);
  * `sweep_ablate_plain` gives the same bits at every lane group size and
    under any unit order, and `sweep_ablate` refuses an order that is not
    a permutation of the units.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import sweep_ablate as sa
from pathtracer_tpu_torch.ops import sweep_micro as sm
from pathtracer_tpu_torch.scripts import ablate_sweep, prof_sweep
from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_probes import _interpret, _load_script, prof_inputs  # noqa: F401

EPS = 1e-3


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same(out, ref):
    """Bit equality of (t, tri, beta, gamma) tuples."""
    return all(torch.equal(_bits(a), _bits(b)) if a.is_floating_point()
               else torch.equal(a, b) for a, b in zip(out, ref))


def _split_run(o, d, tr, ranges, eps):
    """edgemat_plain on each range, combined by the kernel's rule."""
    return sm.edgemat_combine([sm.edgemat_plain(o, d, tr, r1, eps, rep0=r0)
                               for r0, r1 in ranges])


def _cut(reps, bounds):
    edges = [0, *sorted(b for b in bounds if 0 < b < reps), reps]
    return list(zip(edges[:-1], edges[1:]))


@pytest.fixture(scope='module')
def edge_inputs():
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    return t(3, 96), t(3, 96), t(12, sm.SUBT)


@pytest.mark.parametrize('reps,bounds', [
    (9, []), (9, [1]), (9, [4]), (9, [1, 2, 3, 4, 5, 6, 7, 8]),
    (9, [2, 7]), (12, [5, 6, 11]), (12, [3, 6, 9])])
def test_edgemat_split_equals_whole(edge_inputs, reps, bounds):
    o, d, tr = edge_inputs
    whole = sm.edgemat_plain(o, d, tr, reps, EPS)
    assert (whole < sm.BIG_T).float().mean() > 0.2        # rays do hit
    assert torch.equal(_bits(_split_run(o, d, tr, _cut(reps, bounds), EPS)),
                       _bits(whole))


def _signed_zeros(minus_rep, plus_rep):
    """One ray from o along d = (1, 1, 3) and SUBT triangles, of which
    triangle 0 meets the ray at its origin with t = -0.0 in rep
    `minus_rep` and triangle 1 with t = +0.0 in rep `plus_rep`.

    In its rep a triangle's shifted vertex a + step equals o exactly (a
    is searched with nextafter), so o - a = +0 in every axis, and on =
    ((+0 * nx) + (+0 * ny)) + (+0 * nz) = +0 unless all of n is negative.
    With on = +0, t = -(on / dn) is -0.0 for dn > 0 and +0.0 for dn < 0:
    n = (1, 1, 1) gives dn = 5, n = (1, 1, -1) gives dn = -1.  u = v = 0,
    so beta = gamma = 0 and every t >= 0 is accepted; in its other reps a
    triangle's t is small and nonzero.  The other triangles are far off
    the ray."""
    steps = sm.rep_steps(max(minus_rep, plus_rep) + 2, EPS, 'cpu').numpy()
    o = np.array([0.3, 0.6, 0.7], np.float32)
    tr = np.random.default_rng(9).uniform(20.0, 30.0, (12, sm.SUBT)) \
        .astype(np.float32)
    for tri, rep, n in ((0, minus_rep, (1, 1, 1)), (1, plus_rep, (1, 1, -1))):
        for k in range(3):
            a = np.float32(o[k] - steps[rep])
            while np.float32(a + steps[rep]) != o[k]:
                a = np.nextafter(a, np.float32(np.inf if a + steps[rep] < o[k]
                                               else -np.inf))
            tr[k, tri] = a
        tr[3:6, tri] = n
        tr[6:12, tri] = 0.0
    d = np.array([[1.0], [1.0], [3.0]], np.float32)
    return (torch.as_tensor(o[:, None]), torch.as_tensor(d),
            torch.as_tensor(tr))


@pytest.mark.parametrize('minus_rep,plus_rep', [(1, 3), (3, 1)])
@pytest.mark.parametrize('bounds', [[], [2], [1, 2, 3, 4], [3]])
def test_edgemat_split_keeps_the_first_signed_zero(minus_rep, plus_rep,
                                                   bounds):
    """t = -0.0 and +0.0 are both accepted, in different reps: the whole run
    keeps the earlier rep's zero, and so does every cut, combined by the
    kernel's rule; a min that orders -0.0 below +0.0 (a min of the float
    bits as integers) would give -0.0 both times."""
    o, d, tr = _signed_zeros(minus_rep, plus_rep)
    reps = 5
    per_rep = [float(sm.edgemat_plain(o, d, tr, i + 1, EPS, rep0=i))
               for i in range(reps)]
    assert per_rep[minus_rep] == 0.0 and np.signbit(per_rep[minus_rep])
    assert per_rep[plus_rep] == 0.0 and not np.signbit(per_rep[plus_rep])
    whole = sm.edgemat_plain(o, d, tr, reps, EPS)
    assert float(whole) == 0.0
    assert bool(torch.signbit(whole)) == (minus_rep < plus_rep)
    assert torch.equal(_bits(_split_run(o, d, tr, _cut(reps, bounds), EPS)),
                       _bits(whole))
    if bounds == [2]:            # the ranges part the two zeros
        parts = [sm.edgemat_plain(o, d, tr, r1, EPS, rep0=r0)
                 for r0, r1 in _cut(reps, bounds)]
        naive = torch.minimum(*(_bits(p) for p in parts)).view(torch.float32)
        assert bool(torch.signbit(naive))


@pytest.mark.parametrize('m,reps,resident', [
    (1024, 256, 528), (1024, 256, 1), (97, 7, 528), (97, 1, 528),
    (8, 256, 4), (1024, 7, 100), (5000, 3, 528), (1, 0, 528)])
def test_edgemat_ranges_cover_the_reps(m, reps, resident):
    ranges = sm.edgemat_ranges(m, reps, resident)
    tiles = -(-m // sm.EDGE_RAYS)
    assert ranges[0][0] == 0 and ranges[-1][1] == reps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(r1 > r0 for r0, r1 in ranges) or reps == 0
    assert len(ranges) == 1 or len(ranges) * tiles <= 4 * resident


def test_edgemat_uneven_split_matches_jax(prof_inputs, monkeypatch):
    """Seven reps cut into three ranges, (0, 2), (2, 4), (4, 7), against the
    JAX probe run whole."""
    tps = _load_script('tpu_prof_sweep')
    reps = 7
    monkeypatch.setattr(tps, 'REPS', reps)
    x = prof_inputs
    ranges = sm.edgemat_ranges(x['ov'].shape[1], reps, 100)
    assert ranges == [(0, 2), (2, 4), (4, 7)]
    ref = _interpret(tps.edgemat_kernel, (1, tps.BLOCK), x['ov'], x['dv'],
                     x['tr'])
    o, d, tr = (torch.as_tensor(x[k]) for k in ('ov', 'dv', 'tr'))
    out = _split_run(o, d, tr, ranges, prof_sweep.EPS)
    assert torch.equal(_bits(out), _bits(sm.edgemat(o, d, tr, reps,
                                                    prof_sweep.EPS)))
    assert (ref < 1e29).mean() > 0.2
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


# ---- the ablation: lane groups and unit order ----

@pytest.fixture(scope='module')
def ablate_args():
    """The probe's terrain at G = 40 in 256-triangle clusters (port build)
    and three packets of every 1350th camera ray, so that a packet sees
    more than SLOTS clusters; packet 1's count is set to 0."""
    tris = ablate_sweep.terrain(40)
    cm = tc.build_clustered(tris, tris_c=tc.SUBT, dev='cpu')
    n = 3 * tc.BLOCK
    o, d = (torch.as_tensor(np.ascontiguousarray(x[::1350][:n]))
            for x in ablate_sweep.camera_rays(ablate_sweep.H * ablate_sweep.W))
    tmax = torch.full((n,), tc.BIG_T)
    ids, count, _ = tc.cluster_cull(cm, o, d, tmax)
    assert int(count.max()) > sa.SLOTS            # the clamp is exercised
    counts = count.clone()
    counts[1] = 0
    return cm, ids, counts, o, d, tmax, torch.full((n,), -1.0)


def _orders(nu, counts, g):
    rng = np.random.default_rng(nu)
    return {'default': None,
            'heaviest': tc.heaviest_first(counts.clamp(max=sa.SLOTS), g),
            'packet': torch.arange(nu, dtype=torch.int32),
            'reversed': torch.arange(nu - 1, -1, -1, dtype=torch.int32),
            'shuffled': torch.as_tensor(rng.permutation(nu).astype(np.int32))}


@pytest.fixture(scope='module')
def ablate_ref(ablate_args):
    """Every variant at lane group 512 in packet order."""
    nu = ablate_args[1].shape[0]
    return {v: sa.sweep_ablate_plain(*ablate_args, v, group=tc.BLOCK,
                                     order=torch.arange(nu,
                                                        dtype=torch.int32))
            for v in sa.VARIANTS}


@pytest.mark.parametrize('variant', sa.VARIANTS)
def test_ablate_plain_same_bits_in_any_order(ablate_args, ablate_ref,
                                             variant):
    g = tc.SWEEP_GROUP
    nu = ablate_args[1].shape[0] * (tc.BLOCK // g)
    ref = ablate_ref[variant]
    if variant == 'full':
        assert (ref[1] >= 0).float().mean() > 0.3
    for name, order in _orders(nu, ablate_args[2], g).items():
        out = sa.sweep_ablate(*ablate_args, variant, order=order)
        assert _same(out, ref), name


@pytest.mark.parametrize('group', tc.GROUPS)
def test_ablate_plain_same_bits_at_every_group(ablate_args, ablate_ref,
                                               group):
    nu = ablate_args[1].shape[0] * (tc.BLOCK // group)
    stats = torch.full((nu, sa.STATS), -7, dtype=torch.int64)
    order = _orders(nu, ablate_args[2], group)['shuffled']
    for variant in ('full', 'pk'):
        out = sa.sweep_ablate(*ablate_args, variant, group=group,
                              order=order, stats=stats)
        assert _same(out, ablate_ref[variant])
    cnt = ablate_args[2][:, 0].clamp(max=sa.SLOTS)
    per_unit = cnt.repeat_interleave(tc.BLOCK // group) * ablate_args[0].n_sub
    assert torch.equal(stats[:, 0], per_unit)
    assert int(per_unit[nu // 3]) == 0 and int(per_unit.max()) == \
        sa.SLOTS * ablate_args[0].n_sub
    assert bool((stats[:, 1] == -7).all())      # cycles: the kernel's own


@pytest.mark.parametrize('bad', ['int64', 'short', 'repeat', 'range',
                                 'group'])
def test_ablate_refuses_a_bad_order(ablate_args, bad):
    nu = ablate_args[1].shape[0] * (tc.BLOCK // tc.SWEEP_GROUP)
    order = torch.arange(nu, dtype=torch.int32)
    kw = {}
    if bad == 'int64':
        order = order.long()
    elif bad == 'short':
        order = order[:-1]
    elif bad == 'repeat':
        order[3] = 4
    elif bad == 'range':
        order[-1] = nu
    else:
        kw = dict(group=48)
    match = 'group' if bad == 'group' else 'permutation'
    with pytest.raises(ValueError, match=match):
        sa.sweep_ablate(*ablate_args, 'full', order=order, **kw)
    with pytest.raises(ValueError, match=match):
        sa.sweep_ablate_plain(*ablate_args, 'full', order=order, **kw)
