"""PyTorch port, the hierarchical cluster cull's wrapper on the CPU.

`ops.cluster.hier_cull` checks its arguments on every device, then runs
the plain version (`_hier_cull`) for CPU tensors and the hand-written
kernel (csrc/cluster_hier_cull.cu) for CUDA tensors; the kernel against
the plain version is tests/test_torch_gpu.py's.  Here: the CPU route
returns the plain version's outputs, the wrapper refuses what the kernel
does not take (as cull_tree and the sweeps do), the dense-tier queries
reach it, and the plain version gives the empty emission where the
kernel writes it without a sort.  The JAX side is not called.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.utils import procgen, profiling
from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

BIG_T = float(np.float32(1e30))


def _boxes(c, seed):
    """c random cluster boxes in [-10, 10]^3 and normal bounds."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-10.0, 10.0, (c, 3))
    half = rng.uniform(0.2, 1.5, (c, 3))
    n = rng.normal(size=(c, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = rng.uniform(0.0, 1.2, (c, 1))
    bounds = np.concatenate([ctr - half, ctr + half], 1)
    nrm = np.concatenate([np.clip(n - w, -1, 1), np.clip(n + w, -1, 1)], 1)
    return (torch.as_tensor(bounds.astype(np.float32)),
            torch.as_tensor(nrm.astype(np.float32)))


def _rays(packets, seed):
    """Camera-like and incoherent packets, every 37th lane dead."""
    rng = np.random.default_rng(seed)
    n = packets * tc.BLOCK
    d = np.stack([rng.uniform(-0.03, 0.03, n), rng.uniform(-0.03, 0.03, n),
                  -np.ones(n)], 1)
    o = np.tile([0.0, 0.0, 40.0], (n, 1))
    half = slice(n // 2, n)
    p = rng.normal(size=(n - n // 2, 3))
    o[half] = 14.0 * p / np.linalg.norm(p, axis=1, keepdims=True)
    d[half] = rng.normal(size=(n - n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, BIG_T)
    tmax[::37] = -1.0
    return (torch.as_tensor(o.astype(np.float32)),
            torch.as_tensor(d.astype(np.float32)),
            torch.as_tensor(tmax.astype(np.float32)))


@pytest.fixture(scope='module')
def inputs():
    bounds, nrm = _boxes(300, seed=3)
    o, d, tm = _rays(4, seed=4)
    exclude = torch.as_tensor(np.random.default_rng(5).uniform(
        size=(4, 300)) < 0.25)
    return bounds, nrm, exclude, o, d, tm


@pytest.mark.parametrize('with_nrm', [False, True])
@pytest.mark.parametrize('with_exclude', [False, True])
def test_cpu_route_returns_the_plain_outputs(inputs, with_nrm, with_exclude):
    bounds, nrm, exclude, o, d, tm = inputs
    kw = dict(nrm=nrm if with_nrm else None,
              exclude=exclude if with_exclude else None)
    before = profiling.counters().get('hier_cull.launches', 0)
    out = tc.hier_cull(bounds, o, d, tm, **kw)
    assert profiling.counters().get('hier_cull.launches', 0) == before
    ref = tc._hier_cull(bounds, o, d, tm, **kw)
    assert len(out) == 4
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out[3].shape == (4, min(300, tc.CAND_FACTOR * tc.MAXC) + tc.MAXC)
    assert bool((out[1] > 0).all()) and bool((out[1] < tc.MAXC).any())
    if not with_exclude:
        assert bool((out[1] > tc.MAXC).any())       # overflow exercised


def test_cpu_route_takes_row_strided_views(inputs):
    """ClusteredMesh.bounds is a view of ctab's 12-float rows and a
    windowed round's exclusion mask a view of the swept mask's C + 1
    columns: both taken as they are."""
    bounds, nrm, exclude, o, d, tm = inputs
    wide = torch.cat([bounds, torch.zeros_like(bounds)], 1)
    mask = torch.cat([exclude, torch.ones((4, 1), dtype=torch.bool)], 1)
    out = tc.hier_cull(wide[:, 0:6], o, d, tm, exclude=mask[:, :-1], nrm=nrm)
    ref = tc._hier_cull(bounds, o, d, tm, exclude=exclude, nrm=nrm)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _bad(case, bounds, nrm, exclude, o, d, tm):
    """The wrapper's arguments with one fault."""
    kw = dict(nrm=nrm, exclude=exclude)
    if case == 'dtype':
        o = o.double()
    elif case == 'non_contiguous':
        o = o.t().contiguous().t()
    elif case == 'partial_packet':
        o, d, tm = o[:-12], d[:-12], tm[:-12]
        kw['exclude'] = None
    elif case == 'mixed_device':
        bounds = bounds.to('meta')
    elif case == 'grad':
        d = d.clone().requires_grad_()
    elif case == 'exclude_shape':
        kw['exclude'] = exclude[:, :-1]
    elif case == 'exclude_dtype':
        kw['exclude'] = exclude.to(torch.uint8)
    elif case == 'nrm_columns':
        kw['nrm'] = nrm[:, :5]
    elif case == 'cpu_work':
        kw['work'] = torch.zeros((4, tc.HIER_WORK), dtype=torch.int64)
    elif case == 'too_many_clusters':
        bounds = torch.zeros((tc.DENSE_CULL_MAX + 1, 6))
        kw = {}
    return (bounds, o, d, tm), kw


@pytest.mark.parametrize('case', ['dtype', 'non_contiguous', 'partial_packet',
                                  'mixed_device', 'grad', 'exclude_shape',
                                  'exclude_dtype', 'nrm_columns', 'cpu_work',
                                  'too_many_clusters'])
def test_wrapper_refuses_bad_arguments(inputs, case):
    args, kw = _bad(case, *inputs)
    before = profiling.counters().get('hier_cull.launches', 0)
    with pytest.raises(ValueError, match='detach' if case == 'grad' else ''):
        tc.hier_cull(*args, **kw)
    assert profiling.counters().get('hier_cull.launches', 0) == before


@pytest.mark.parametrize('case', ['dead_lanes', 'all_excluded'])
def test_empty_emission_without_live_clusters(inputs, case):
    """A packet with no live lane, or with every cluster excluded, emits
    nothing: ids -1, keys 1e30, count 0, no id to mark swept (the kernel
    writes this without its sorts)."""
    bounds, nrm, exclude, o, d, tm = inputs
    ex = None
    if case == 'dead_lanes':
        tm = torch.where(torch.arange(tm.shape[0]) < tc.BLOCK,
                         torch.full_like(tm, -1.0), tm)
    else:
        ex = exclude.clone()
        ex[0] = True
    ids, count, keys, swept = tc.hier_cull(bounds, o, d, tm, exclude=ex,
                                           nrm=nrm)
    assert int(count[0, 0]) == 0 and bool((ids[0] == -1).all())
    assert bool((keys[0] == BIG_T).all()) and bool((swept[0] == -1).all())
    assert int(count[1:].min()) > 0                  # the others emit


def test_dense_tier_queries_reach_the_wrapper(monkeypatch):
    """two_level_hit and two_level_any above HIER_MIN_CLUSTERS cull
    through hier_cull; on the CPU in CHUNK_PACKETS chunks, every windowed
    round with its exclusion mask."""
    md = procgen.sphere_mesh(200, 200, radius=12.0, displace_amp=0.25)
    cm = tc.build_clustered(md.vertices[md.vtx_idx], tris_c=tc.SUBT,
                            dev='cpu')
    assert cm.n_clusters > tc.HIER_MIN_CLUSTERS
    calls = []
    orig = tc.hier_cull

    def rec(bounds, org, *a, exclude=None, **k):
        calls.append((org.shape[0] // tc.BLOCK, exclude is not None))
        return orig(bounds, org, *a, exclude=exclude, **k)

    monkeypatch.setattr(tc, 'hier_cull', rec)
    monkeypatch.setattr(tc, 'CHUNK_PACKETS', 1)
    o, d, _ = _rays(3, seed=9)
    tmax = torch.full((o.shape[0],), BIG_T)
    tc.two_level_hit(cm, o, d, tmax)
    first = [c for c in calls if not c[1]]
    assert first == [(1, False)] * 3                # one call per chunk
    assert any(c[1] for c in calls)                 # a windowed round
    n = len(calls)
    tc.two_level_any(cm, o, d, torch.full_like(tmax, 20.0))
    assert len(calls) > n
