"""PyTorch port, the cluster sweep's cost probes (ops/sweep_micro.py,
ops/sweep_ablate.py, pathtracer_tpu_torch/scripts/) against the JAX
package's TPU probes.

The JAX side runs the probes' own kernel bodies (scripts/tpu_prof_sweep.py,
scripts/tpu_proto_mxu.py, imported by path and left as they are) through
`pl.pallas_call(..., interpret=True)` with REPS patched down; the port
runs the plain PyTorch versions (CPU tensors).  Tolerances:
  * products: on the CPU, JAX's DEFAULT and HIGHEST precision and the MXU
    and VPU kernels are all fp32, so each is held to the port's fp32 route
    within 1e-6 of the largest |value|; XLA's CPU dot over K = 8 is the
    same FMA chain in k order as the port's, so the matmul kernel at both
    precisions and the MXU kernel are also bit-equal to it (the VPU
    kernel's unrolled sums are contracted otherwise: about 85% of its
    elements are);
  * the TF32 plain version against a float64 product of the TF32-rounded
    operands: within 2^-20 of the absolute-value bound (fp32 accumulation
    of 16 products per element);
  * epilogue: tri equal on >= 99.9% of lanes, tbest within 1e-6 relative;
    edge-matrix test: within 1e-6 relative plus 1e-6 absolute (XLA's CPU
    code contracts products and sums into FMAs, and t near 0 comes from a
    cancelling o.n, so its relative error there is large);
  * ablation: each variant's plain version equal to a direct numpy
    statement of that variant; `full` against cluster_sweep_plain on the
    same clamped inputs, and against JAX's cluster_sweep (interpret mode)
    with test_torch_cluster.py's sweep tolerance (tri on >= 99.9% of lanes,
    other lanes ties within 2^-16 relative t, t within 1e-5 relative).
The CUDA kernels themselves run only on a GPU (tests/test_torch_gpu.py and
chip_smoke.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pathtracer_tpu.ops import pallas_cluster as pc
from pathtracer_tpu_torch.ops import cluster as tc
from pathtracer_tpu_torch.ops import sweep_ablate as sa
from pathtracer_tpu_torch.ops import sweep_micro as sm
from pathtracer_tpu_torch.scripts import ablate_sweep, prof_sweep, proto_mxu
from test_torch_cluster import _assert_hits_match, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 4


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'scripts', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def tps():
    return _load_script('tpu_prof_sweep')


@pytest.fixture(scope='module')
def tpm():
    return _load_script('tpu_proto_mxu')


def _interpret(kernel, out_shape, *inputs):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(*(jnp.asarray(x) for x in inputs)))


@pytest.fixture(scope='module')
def prof_inputs():
    return {k: v.numpy() for k, v in prof_sweep.inputs('cpu').items()}


def _close_to_max(a, ref, tol):
    assert np.abs(a - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize('prec', ['DEFAULT', 'HIGHEST'])
def test_matmul_matches_jax(tps, prof_inputs, monkeypatch, prec):
    monkeypatch.setattr(tps, 'REPS', REPS)
    x = prof_inputs
    ref = _interpret(tps.matmul_kernel(getattr(jax.lax.Precision, prec)),
                     (tps.BLOCK, 128), x['r'], x['a'])
    out, pairs = sm.dot_fp32(torch.as_tensor(x['r']), torch.as_tensor(x['a']),
                             REPS, prof_sweep.EPS, prof_sweep.OUT_COLS)
    _close_to_max(out.numpy(), ref, 1e-6)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert pairs.shape == (prof_sweep.BLOCK, prof_sweep.NS // 2)


def test_tf32_plain_matches_float64(prof_inputs):
    x, w = prof_inputs['r'], prof_inputs['a']
    steps = sm.rep_steps(REPS, prof_sweep.EPS, 'cpu').numpy()
    wt = sm.round_tf32(torch.as_tensor(w)).numpy().astype(np.float64)
    ref = np.zeros((x.shape[0], w.shape[1]))
    bound = np.zeros_like(ref)
    for i in range(REPS):
        r = sm.round_tf32(torch.as_tensor(x + steps[i])).numpy()
        ref += r.astype(np.float64) @ wt
        bound += np.abs(r).astype(np.float64) @ np.abs(wt)
    out, pairs = sm.dot_plain(torch.as_tensor(x), torch.as_tensor(w), REPS,
                              prof_sweep.EPS, 128, tf32=True)
    assert (np.abs(out.numpy() - ref[:, :128]) <= 2.0 ** -20 * bound[:, :128]
            ).all()
    assert (np.abs(pairs.numpy() - (ref[:, 0::2] + ref[:, 1::2]))
            <= 2.0 ** -20 * (bound[:, 0::2] + bound[:, 1::2])).all()
    # the operands really were rounded: TF32 differs from the fp32 route
    fp32 = sm.dot_plain(torch.as_tensor(x), torch.as_tensor(w), REPS,
                        prof_sweep.EPS, 128)[0].numpy()
    assert np.abs(out.numpy() - fp32).max() > 1e-4 * np.abs(fp32).max()
    # ties round away from zero in magnitude, as cvt.rna
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert sm.round_tf32(ties).tolist() == [1.0 + 2.0 ** -10,
                                            -(1.0 + 2.0 ** -10)]


def test_epilogue_matches_jax(tps, prof_inputs, monkeypatch):
    monkeypatch.setattr(tps, 'REPS', REPS)
    x = prof_inputs
    ref = _interpret(tps.epilogue_kernel, (2, tps.BLOCK), x['p'], x['tn'])
    out = sm.epilogue(torch.as_tensor(x['p']), torch.as_tensor(x['tn']),
                      REPS, prof_sweep.EPS).numpy()
    assert (ref[0] < 1e29).mean() > 0.5                 # lanes do hit
    assert (out[1] == ref[1]).mean() >= 0.999
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-6, atol=0)


def test_edgemat_matches_jax(tps, prof_inputs, monkeypatch):
    monkeypatch.setattr(tps, 'REPS', REPS)
    x = prof_inputs
    ref = _interpret(tps.edgemat_kernel, (1, tps.BLOCK), x['ov'], x['dv'],
                     x['tr'])
    out = sm.edgemat(*(torch.as_tensor(x[k]) for k in ('ov', 'dv', 'tr')),
                     REPS, prof_sweep.EPS).numpy()
    assert (ref < 1e29).mean() > 0.2
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('kernel', ['mxu_kernel', 'vpu_kernel'])
def test_proto_mxu_matches_jax(tpm, monkeypatch, kernel):
    monkeypatch.setattr(tpm, 'REPS', REPS)
    rays, tris = (x.numpy() for x in proto_mxu.inputs('cpu'))
    ref = _interpret(getattr(tpm, kernel), (tpm.BLOCK, tpm.NS), rays, tris)
    out, _ = sm.dot_fp32(torch.as_tensor(rays), torch.as_tensor(tris), REPS,
                         proto_mxu.EPS, proto_mxu.NS)
    _close_to_max(out.numpy(), ref, 1e-6)
    if kernel == 'mxu_kernel':
        np.testing.assert_array_equal(out.numpy().view(np.int32),
                                      ref.view(np.int32))


def test_probe_entry_points(capsys, monkeypatch):
    """The three entry points run their plain versions with --device cpu,
    print the JAX scripts' lines, and raise without a card otherwise."""
    out = prof_sweep.main(['--device', 'cpu', '--reps', '1'])
    assert set(out) == {'tf32', 'fp32', 'epilogue', 'edgemat'}
    out = proto_mxu.main(['--device', 'cpu', '--reps', '1'])
    assert out['max diff'] > 0.0          # TF32 against fp32
    out = ablate_sweep.main(['--device', 'cpu', '--grid', '40', '--packets',
                             '1'])
    assert tuple(out) == sa.VARIANTS
    text = capsys.readouterr().out
    for line in ('matmul fp32 (Precision.HIGHEST): ', 'epilogue: ',
                 'us per subtile (256 tris x 1024 rays)',
                 'fp32 CUDA cores (vpu unrolled): ', 'max diff ',
                 'us/slot incl. fixed)  hitfrac=', 'host-clock times'):
        assert line in text
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for main in (prof_sweep.main, proto_mxu.main, ablate_sweep.main):
        with pytest.raises(RuntimeError, match='--device cpu'):
            main([])


def test_probe_wrappers_refuse_other_devices():
    meta = dict(device='meta')
    counts = (sm.dot_fp32.launches, sm.dot_tf32.launches,
              sm.epilogue.launches, sm.edgemat.launches,
              sa.sweep_ablate.launches)
    x, w = torch.zeros((64, 8), **meta), torch.zeros((8, 128), **meta)
    for fn in (sm.dot_fp32, sm.dot_tf32):
        with pytest.raises(ValueError):
            fn(x, w, 2, 1e-3, 64)
    with pytest.raises(ValueError):
        sm.epilogue(torch.zeros((64, 6 * sm.SUBT), **meta),
                    torch.zeros((1, 64), **meta), 2, 1e-3)
    with pytest.raises(ValueError):
        sm.edgemat(torch.zeros((3, 64), **meta), torch.zeros((3, 64), **meta),
                   torch.zeros((12, sm.SUBT), **meta), 2, 1e-3)
    with pytest.raises(ValueError, match='variant'):
        sa.sweep_ablate(None, None, None, torch.zeros((1, 3)), None, None,
                        None, 'high')
    assert counts == (sm.dot_fp32.launches, sm.dot_tf32.launches,
                      sm.epilogue.launches, sm.edgemat.launches,
                      sa.sweep_ablate.launches)


# ---- the ablation ----

@pytest.fixture(scope='module')
def terrain():
    """The probe's terrain at G = 40 cut into 256-triangle clusters, both
    builds, and three packets of its camera rays with their cull: every
    1350th ray of the image, so that a packet sees more than SLOTS
    clusters (a packet of the 1080p tile order sees one cluster here)."""
    tris = ablate_sweep.terrain(40)
    cj = pc.build_clustered(tris, tris_c=pc.SUBT)
    ct = tc.from_tpu_arrays(pc.cluster_arrays(cj), dev='cpu')
    n = 3 * tc.BLOCK
    o, d = (torch.as_tensor(np.ascontiguousarray(x[::1350][:n]))
            for x in ablate_sweep.camera_rays(ablate_sweep.H * ablate_sweep.W))
    tmax = torch.full((n,), tc.BIG_T)
    ids, count, _ = tc.cluster_cull(ct, o, d, tmax)
    counts = count.clamp(max=sa.SLOTS)
    assert int(count.max()) > sa.SLOTS            # the clamp is exercised
    return cj, ct, (ct, ids, counts, o, d, tmax, torch.full((n,), -1.0))


def _numpy_ablate(cm, ids, counts, org, dirn, tmax, tmin, variant):
    """Direct numpy statement of each variant, packet by packet, slot by
    slot, subtile by subtile (ops/sweep_ablate.py's docstring)."""
    planes, ctab, starts = (x.numpy() for x in (cm.planes, cm.ctab,
                                                cm.starts))
    ids, counts, org, dirn, tmax, tmin = (
        x.numpy() for x in (ids, counts, org, dirn, tmax, tmin))
    bl, s_ = tc.BLOCK, tc.SUBT
    out_t, out_tri = tmax.copy(), np.full(tmax.shape, -1, np.int32)
    out_be, out_ga = np.zeros_like(tmax), np.zeros_like(tmax)
    lane = np.arange(s_)
    for b in range(ids.shape[0]):
        rs = slice(b * bl, (b + 1) * bl)
        o, d = org[rs], dirn[rs]
        tn = np.maximum(tmin[rs], np.float32(0))[:, None]
        best, btri = out_t[rs], out_tri[rs]
        bb, bg = out_be[rs], out_ga[rs]
        for k in range(min(int(counts[b, 0]), tc.MAXC, sa.SLOTS)):
            cid = max(int(ids[b, k]), 0)
            oc = o - ctab[cid, 6:9]
            for s in range(cm.n_sub):
                p = (planes[max(int(ids[b, 0]), 0), 0] if variant == 'no-load'
                     else planes[cid, s])
                base = int(starts[cid]) + s * s_

                def dot(v, r):
                    return ((v[:, 0:1] * p[r] + v[:, 1:2] * p[r + 1])
                            + v[:, 2:3] * p[r + 2])

                if variant == 'no-products':
                    on, ou, ov = p[0] + p[3], p[4] + p[7], p[8] + p[11]
                    dn, du, dv = p[1] + p[2], p[5] + p[6], p[9] + p[10]
                else:
                    on, ou, ov = (dot(oc, 0) + p[3], dot(oc, 4) + p[7],
                                  dot(oc, 8) + p[11])
                    dn, du, dv = dot(d, 0), dot(d, 4), dot(d, 8)
                with np.errstate(all='ignore'):
                    if variant == 'no-epi':
                        v = ((((on + ou) + ov) + dn) + du) + dv
                        v = np.where(np.isnan(v), np.inf, v).min(-1)
                        best[:] = np.minimum(best, v)
                        continue
                    t = np.broadcast_to(on / -dn, (bl, s_))
                    if variant == 'tonly':
                        t = np.where(np.isnan(t), np.inf, t).min(-1)
                        best[:] = np.minimum(best, t)
                        continue
                    be = np.broadcast_to(ou + t * du, (bl, s_))
                    ga = np.broadcast_to(ov + t * dv, (bl, s_))
                    ok = ((t > tn) & (be >= 0) & (ga >= 0)
                          & (np.float32(1) - (be + ga) >= 0))
                for r in range(bl):
                    acc = np.nonzero(ok[r])[0]
                    if variant in ('lean', 'notb', 'pk'):
                        tm = np.where(ok[r], t[r], np.float32(tc.BIG_T))
                        key = (tm.view(np.int32) & ~0xFF) | lane
                        j = int(key.argmin())
                        tj = (tm[j] if variant != 'notb' else
                              np.int32(key[j] & ~0xFF).view(np.float32))
                        if tj < best[r]:
                            best[r], btri[r] = tj, base + j
                            if variant == 'pk':
                                bb[r], bg[r] = be[r, j], ga[r, j]
                        continue
                    if acc.size == 0:
                        continue
                    tj = t[r, acc].min()
                    if variant == 'acc-only':
                        best[r] = min(best[r], tj)
                        continue
                    j = base + int(acc[t[r, acc] == tj].min())
                    if tj < best[r] or (tj == best[r] and j < btri[r]):
                        best[r], btri[r] = tj, j
    return out_t, out_tri, out_be, out_ga


@pytest.mark.parametrize('variant', sa.VARIANTS)
def test_ablate_plain_matches_numpy(terrain, variant):
    args = terrain[2]
    out = sa.sweep_ablate(*args, variant)           # CPU: the plain version
    ref = _numpy_ablate(*args, variant)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    if variant in ('full', 'pk'):
        assert (out[1].numpy() >= 0).mean() > 0.5


def test_ablate_full_matches_cluster_sweep(terrain):
    cm, ids, counts, o, d, tmax, tmin = terrain[2]
    t, tri, _, _ = sa.sweep_ablate(cm, ids, counts, o, d, tmax, tmin, 'full')
    t_s, tri_s = tc.cluster_sweep_plain(cm, ids, counts, torch.zeros_like(
        ids, dtype=torch.float32), o, d, tmax, tmin)
    _assert_hits_match(t_s.numpy(), tri_s.numpy(), t, tri)


def test_ablate_full_matches_jax(terrain):
    cj, _, (cm, ids, counts, o, d, tmax, tmin) = terrain
    t_j, tri_j, _, _ = pc.cluster_sweep(
        jnp.asarray(ids.numpy()), jnp.asarray(counts.numpy()),
        jnp.zeros(ids.shape, jnp.float32), cj.packed,
        *(jnp.asarray(x.numpy()) for x in (o, d, tmax, tmin)),
        interpret=True)
    t, tri, _, _ = sa.sweep_ablate(cm, ids, counts, o, d, tmax, tmin, 'full')
    assert (tri.numpy() >= 0).mean() > 0.5
    _assert_hits_match(t_j, tri_j, t, tri)
