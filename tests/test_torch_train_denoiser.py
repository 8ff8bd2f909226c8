"""PyTorch port, the KPCN-lite trainer and the denoiser gate
(pathtracer_tpu_torch/scripts/train_denoiser.py, denoiser_eval.py)
against the JAX package's scripts.

flax's initialisation cannot be reproduced, so the parameters are JAX's
init_params carried across (convert.kpcn_state_dict).  Tolerances: the
loss of every step within 1e-5 relative (the convolutions sum in another
order: the loss differs by 3e-6 relative before any update); after the
steps, >= 99.5% of each parameter tensor's elements within 1e-6 of its
largest |value| plus 1e-5 of a step (lr 2e-3) a step, and every element
within 1% of one step.  optax corrects the bias in float32, where
1 - 0.999 rounds 1.3e-5 low, torch.optim.Adam in float64: each step's
update differs by up to 6.5e-6 of itself (the biases start at zero, so
theirs is the whole difference).  And
where a gradient element is near zero, Adam's g / (sqrt(v) + eps) turns
the packages' rounding differences into a visible part of the step (0.2%
of one kernel's elements after 3 steps, 2.8e-6 at most), while a wrong sign or
schedule would move an element by a whole step; the saved weights
through JAX's loader within 1e-4 of the output's largest value
(tests/test_torch_denoise.py's KPCN tolerance); the gate's PSNRs within
0.5 dB of JAX's evaluate at its test size.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from pathtracer_tpu.render import denoise_net as jdnn
from pathtracer_tpu_torch import convert
from pathtracer_tpu_torch.render import denoise_net as tdnn
from pathtracer_tpu_torch.scripts import denoiser_eval as teval
from pathtracer_tpu_torch.scripts import train_denoiser as ttrain

from test_torch_cluster import one_torch_thread  # noqa: F401 (autouse)

STEPS = 4           # a short schedule, so that the decay shows in 3 steps
B, CROP = 2, 16


def _flat(params):
    return {'/'.join(str(getattr(k, 'key', k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _batch():
    rng = np.random.default_rng(3)
    cin = rng.gamma(1.0, 2.0, (B, CROP, CROP, 3)).astype(np.float32)
    alb = rng.uniform(0, 1, (B, CROP, CROP, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (B, CROP, CROP, 3)).astype(np.float32)
    tgt = (cin * rng.uniform(0.5, 1.5, cin.shape)).astype(np.float32)
    return cin, alb, nrm, tgt


@pytest.mark.parametrize('n', [1, 3])
def test_steps_match_optax(n):
    params = jdnn.init_params(jax.random.PRNGKey(0))
    model = tdnn.KPCNLite()
    model.load_state_dict(convert.kpcn_state_dict(_flat(params)))
    batch = _batch()
    tx = optax.adam(optax.cosine_decay_schedule(2e-3, STEPS))
    opt = tx.init(params)

    def loss_fn(p, cin, alb, nrm, ctgt):
        out = jax.vmap(lambda c, a, m: jdnn.denoise_apply(p, c, a, m))(
            cin, alb, nrm)
        return jnp.mean(jnp.abs(jnp.log1p(out) - jnp.log1p(ctgt)))

    @jax.jit
    def jstep(p, o, b):
        loss, g = jax.value_and_grad(loss_fn)(p, *b)
        up, o = tx.update(g, o)
        return optax.apply_updates(p, up), o, loss

    tstep = ttrain.make_step(model, STEPS)
    jb = tuple(jnp.asarray(x) for x in batch)
    tb = tuple(torch.as_tensor(x) for x in batch)
    for _ in range(n):
        params, opt, jl = jstep(params, opt, jb)
        tl = tstep(tb)
        assert abs(tl - float(jl)) <= 1e-5 * abs(float(jl)), (tl, float(jl))
    want = convert.kpcn_state_dict(_flat(params))
    got = model.state_dict()
    moved = 0.0
    start = convert.kpcn_state_dict(_flat(jdnn.init_params(
        jax.random.PRNGKey(0))))
    for k, w in want.items():
        w = w.numpy()
        err = np.abs(got[k].numpy() - w)
        tol = 1e-6 * np.abs(w).max() + n * 1e-5 * 2e-3
        assert (err <= tol).mean() >= 0.995, (k, err.max(), tol)
        assert err.max() <= 0.01 * 2e-3, (k, err.max())
        moved = max(moved, float(np.abs(w - start[k].numpy()).max()))
    assert moved > 1e-4                    # the steps moved the weights


def test_saved_weights_load_in_jax(tmp_path):
    """The port's file in the flax layout: JAX's load_weights reads it and
    its denoise_apply gives the port's output."""
    torch.manual_seed(1)
    model = tdnn.KPCNLite()
    path = str(tmp_path / 'w.npz')
    ttrain.save_weights(model, path)
    with np.load(path) as f:
        keys = sorted(f.files)
    assert keys == sorted(_flat(jdnn.init_params(jax.random.PRNGKey(0))))
    params = jdnn.load_weights(path)
    rng = np.random.default_rng(4)
    c, a, n = (rng.uniform(0, 3, (24, 20, 3)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jdnn.denoise_apply(params, jnp.asarray(c),
                                         jnp.asarray(a), jnp.asarray(n)))
    got = tdnn.denoise_apply(model, *(torch.as_tensor(x) for x in (c, a, n)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    back = tdnn.KPCNLite()
    back.load_state_dict(tdnn.load_weights(path))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(2e-3, 1500)
    for c in (0, 1, 7, 750, 1499, 1500, 1600):
        assert abs(ttrain.cosine_lr(c, 1500) - float(sched(c))) <= 1e-9


def test_shipped_weights_pass_the_gate():
    """The JAX gate at its test size (96x64, 2 vs 64 spp) on the port, and
    the PSNRs within 0.5 dB of JAX's evaluate."""
    res = teval.evaluate(width=96, height=64, spp_in=2, spp_ref=64,
                         device='cpu')
    assert res['learned_minus_noisy_db'] > 2.0, res
    assert res['learned_minus_atrous_db'] > 1.0, res
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                    'scripts'))
    try:
        import denoiser_eval as jeval
    finally:
        sys.path.pop(0)
    ref = jeval.evaluate(width=96, height=64, spp_in=2, spp_ref=64,
                         force_cpu=False)
    assert set(res) == set(ref)
    for k in ('psnr_noisy_db', 'psnr_atrous_db', 'psnr_learned_db'):
        assert abs(res[k] - ref[k]) < 0.5, (k, res[k], ref[k])


def test_negative_radiance_keeps_the_loss_finite():
    """The renderer emits radiance below -1 on a few pixels (scene 1000 of
    the trainer at 256x144 x 4 spp: two pixels at -79.8 in both packages,
    ROADMAP Queue 3), and JAX's log1p loss is NaN on a batch holding one;
    the port clamps radiance at 0 first, and on non-negative radiance both
    losses are the same."""
    params = jdnn.init_params(jax.random.PRNGKey(0))
    model = tdnn.KPCNLite()
    model.load_state_dict(convert.kpcn_state_dict(_flat(params)))
    cin, alb, nrm, tgt = _batch()
    tgt_neg = tgt.copy()
    tgt_neg[0, 3, 5] = -79.8

    def jloss(t):
        out = jax.vmap(lambda c, a, m: jdnn.denoise_apply(params, c, a, m))(
            jnp.asarray(cin), jnp.asarray(alb), jnp.asarray(nrm))
        return float(jnp.mean(jnp.abs(jnp.log1p(out) - jnp.log1p(t))))

    with torch.no_grad():
        tl = float(ttrain.batch_loss(model, *(torch.as_tensor(x) for x in (
            cin, alb, nrm, tgt_neg))))
    assert np.isnan(jloss(jnp.asarray(tgt_neg))) and np.isfinite(tl)
