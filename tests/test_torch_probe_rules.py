"""PyTorch port, the redesigned TF32 product and sweep epilogue probes on
the CPU: the rules their CUDA kernels follow, stated and checked with the
plain versions (ops/sweep_micro.py), and the products' library yardstick
(pathtracer_tpu_torch/scripts/__init__.py).

  * `epilogue_plain` keeps the first pair in (rep, tri) order among equal
    t, -0.0 and +0.0 equal, with that pair's own sign: on
    prof_sweep.signed_zero_inputs (tn < 0, t = -0.0 and +0.0 accepted in
    one rep and across reps) every ray's result is known in advance, the
    same on repeated runs, and equal in value and tri to the JAX
    package's `epilogue_kernel` (interpret mode, REPS patched; -0.0 ==
    +0.0 as floats there, since XLA's min picks either zero);
  * the epilogue kernel's rule (one thread per ray x triangle keeping its
    first least accepted t in rep order, the block's least (|t|, rep *
    256 + tri, sign) key) equals `epilogue_plain` bit for bit;
  * the one-call yardstick computes the probes' sum: X_cat @ W_cat of
    `concat_operands` in float64 agrees with `dot_plain` (both routes)
    within the fp32 summation bound (reps + 8) * 2^-24 of the
    absolute-value bound, 1.001 times for second-order terms;
  * `dot_tile` picks the TF32 tile width on the shapes it must cover.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import sweep_micro as sm
from pathtracer_tpu_torch.scripts import concat_operands, prof_sweep
from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_probes import _interpret, _load_script

NONE = torch.iinfo(torch.int64).max


def _bits(x):
    return x.contiguous().view(torch.int32)


def _first_pairs():
    """(tri, sign) of the first signed-zero pair of each ray pattern."""
    return [min(pairs, key=lambda q: (q[1], q[0]))[::2]
            for pairs in prof_sweep.SIGNED_ZERO_PAIRS]


@pytest.mark.parametrize('m,reps,eps', [(8, 3, 1e-3), (12, 7, 1e-3),
                                        (8, 5, 1e-9)])
def test_epilogue_plain_keeps_the_first_signed_zero(m, reps, eps):
    p, tn = prof_sweep.signed_zero_inputs('cpu', m, reps, eps)
    out = sm.epilogue_plain(p, tn, reps, eps)
    assert torch.equal(_bits(out), _bits(sm.epilogue_plain(p, tn, reps, eps)))
    first = _first_pairs()
    for r in range(m):
        tri, sign = first[r % 4]
        assert float(out[0, r]) == 0.0
        assert bool(torch.signbit(out[0, r])) == (sign < 0)
        assert int(out[1, r]) == tri


def test_epilogue_signed_zeros_match_jax(monkeypatch):
    """The JAX probe on the signed-zero inputs: the same tri, and t equal
    as floats (its min may pick either zero)."""
    tps = _load_script('tpu_prof_sweep')
    reps = 3
    monkeypatch.setattr(tps, 'REPS', reps)
    p, tn = prof_sweep.signed_zero_inputs('cpu', tps.BLOCK, reps,
                                          float(np.float32(1e-9)))
    ref = _interpret(tps.epilogue_kernel, (2, tps.BLOCK), p.numpy(),
                     tn.numpy())
    out = sm.epilogue_plain(p, tn, reps, 1e-9).numpy()
    assert (out[0] == 0.0).all()
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[0], ref[0])


def _kernel_rule(p, tn, reps, eps):
    """The epilogue kernel's rule in torch: every accepted pair's key
    (|t|'s bits, then rep * SUBT + tri, then t's sign; t < BIG_T only),
    the least key per ray, decoded into (tbest, tri)."""
    m = p.shape[0]
    steps = sm.rep_steps(reps, eps, 'cpu')
    on, ou, ov, dn, du, dv = (p[None] + steps[:, None, None]).split(
        sm.SUBT, dim=2)
    t = -(on / dn)
    beta = ou + t * du
    gamma = ov + t * dv
    ok = ((t >= 0.0) & (t > tn[0][None, :, None]) & (beta >= 0.0)
          & (gamma >= 0.0) & (beta + gamma <= 1.0) & (t < sm.BIG_T))
    b = _bits(t).long()
    place = (torch.arange(reps)[:, None, None] * sm.SUBT
             + torch.arange(sm.SUBT)[None, None, :])
    key = ((b & 0x7fffffff) << 32) | (place << 1) | ((b >> 31) & 1)
    key = torch.where(ok, key, torch.full_like(key, NONE))
    best = key.permute(1, 0, 2).reshape(m, -1).amin(dim=1)
    hit = best != NONE
    tb = ((best >> 32) | ((best & 1) << 31)).to(torch.int32).view(
        torch.float32)
    return torch.stack([torch.where(hit, tb, torch.full_like(tb, sm.BIG_T)),
                        torch.where(hit, (best >> 1) & (sm.SUBT - 1),
                                    0).to(torch.float32)])


@pytest.mark.parametrize('case,reps', [
    ('random', 1), ('random', 4), ('random', 9), ('negative_tn', 1),
    ('negative_tn', 4), ('signed_zeros', 3), ('signed_zeros', 9)])
def test_epilogue_kernel_rule_equals_plain(case, reps):
    m = 40
    if case == 'signed_zeros':
        p, tn = prof_sweep.signed_zero_inputs('cpu', m, reps, 1e-3)
    else:
        rng = np.random.default_rng(31 + reps)
        p = torch.as_tensor(rng.standard_normal((m, 6 * sm.SUBT))
                            .astype(np.float32))
        tn = torch.as_tensor(np.abs(rng.standard_normal((1, m)))
                             .astype(np.float32))
        tn = tn * 0.1 if case == 'random' else -tn
    want = sm.epilogue_plain(p, tn, reps, 1e-3)
    assert (want[0] < sm.BIG_T).float().mean() > 0.3      # rays do hit
    assert torch.equal(_bits(_kernel_rule(p, tn, reps, 1e-3)), _bits(want))


@pytest.mark.parametrize('tf32', [False, True])
@pytest.mark.parametrize('m,n,reps,eps', [(64, 64, 5, 1e-3),
                                          (32, 128, 9, 1e-7),
                                          (16, 192, 1, 1e-3)])
def test_concat_operands_compute_the_probe_sum(tf32, m, n, reps, eps):
    rng = np.random.default_rng(33)
    x = torch.as_tensor(rng.standard_normal((m, sm.AR)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((sm.AR, n)).astype(np.float32))
    x_cat, w_cat = concat_operands(x, w, reps, eps)
    assert x_cat.shape == (m, sm.AR * reps) and w_cat.shape == (sm.AR * reps,
                                                                n)
    steps = sm.rep_steps(reps, eps, 'cpu')
    for i in range(reps):
        assert torch.equal(x_cat[:, i * sm.AR:(i + 1) * sm.AR], x + steps[i])
        assert torch.equal(w_cat[i * sm.AR:(i + 1) * sm.AR], w)
    if tf32:
        x_cat, w_cat = sm.round_tf32(x_cat), sm.round_tf32(w_cat)
    ref = x_cat.double() @ w_cat.double()
    bound = x_cat.double().abs() @ w_cat.double().abs()
    out, pairs = sm.dot_plain(x, w, reps, eps, n, tf32)
    tol = (reps + sm.AR) * 2.0 ** -24 * 1.001
    assert bool(((out.double() - ref).abs() <= tol * bound).all())
    assert bool(((pairs.double() - (ref[:, 0::2] + ref[:, 1::2])).abs()
                 <= (tol + 2.0 ** -24) * (bound[:, 0::2] + bound[:, 1::2])
                 ).all())


@pytest.mark.parametrize('n,tile', [
    (1536, 96), (768, 96), (128, 64), (64, 64), (192, 96), (576, 96),
    (960, 96), (320, 64), (1024, 64)])
def test_dot_tile_covers_its_shapes(n, tile):
    """The two scripts' widths, N = 64 and the other multiples of 64: the
    width divides N, 96 where it does, else 64."""
    got = sm.dot_tile(n)
    assert got == tile and n % got == 0 and got in sm.DOT_TILES
    assert got == max(t for t in sm.DOT_TILES if n % t == 0)


def test_dot_tile_refuses_a_width_it_has_no_tile_for():
    with pytest.raises(ValueError):
        sm.dot_tile(40)
