"""PyTorch port, core: PCG32 streams, QMC lattice, camera and sampling
against the JAX package on the same numpy inputs.

PCG32, the lattice and the Cranley–Patterson rotation are integer or
exactly-rounded float work and must be bit-equal.  Ray generation and
cosine sampling go through sin/cos/sqrt, whose float32 implementations
differ between XLA and torch by an ulp or so: 1e-6 relative.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pathtracer_tpu.core import camera as jcam
from pathtracer_tpu.core import qmc as jqmc
from pathtracer_tpu.core import rng as jrng
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.core import sampling as jsampling
from pathtracer_tpu_torch.core import camera as tcam
from pathtracer_tpu_torch.core import qmc as tqmc
from pathtracer_tpu_torch.core import rng as trng
from pathtracer_tpu_torch.core import sampling as tsampling

RTOL = 1e-6


def _keys(n=257, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)
    keys[:4] = [0, 1, 2 ** 32 - 1, 2 ** 64 - 1]
    return (keys >> np.uint64(32)).astype(np.uint32), \
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_pcg32_official_vectors():
    """pcg32(42, 54) is the PCG distribution's demo stream."""
    expected = [0xa15c02b7, 0x7b47f409, 0xba1d3330, 0x83d2f293,
                0xbfa4784b, 0xcbed606e]
    # the port keys initstate == initseq; drive the generator core
    # directly with the demo's (42, 54) seeding
    inc = (54 << 1) | 1
    st = (_t([0]), _t([42]), _t([inc >> 32]), _t([inc & 0xFFFFFFFF]))
    s_hi, s_lo = trng._add64(st[0], st[1], st[2], st[3])
    s_hi, s_lo = trng.pcg32_bump(s_hi, s_lo, st[2], st[3])
    state = (s_hi, s_lo, st[2], st[3])
    got = []
    for _ in range(6):
        out, state = trng.next_uint32(state)
        got.append(int(out[0]))
    assert got == expected
    eng = rng_host.PCG32(42, 54)
    assert [eng.next_u32() for _ in range(6)] == expected


def test_streams_bit_equal_to_jax_and_host():
    hi, lo = _keys()
    js = jrng.make_stream(jnp.asarray(hi), jnp.asarray(lo))
    ts = trng.make_stream(_t(hi), _t(lo))
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())
    hosts = [rng_host.PCG32(int(k), int(k)) for k in
             (hi[:8].astype(np.uint64) << np.uint64(32)) | lo[:8]]
    for draw in range(24):
        jo, js = jrng.next_uint32(js)
        to, ts = trng.next_uint32(ts)
        np.testing.assert_array_equal(np.asarray(jo).astype(np.int64),
                                      to.numpy(), err_msg=f'draw {draw}')
        assert [h.next_u32() for h in hosts] == to.numpy()[:8].tolist()


def test_gated_uniforms_bit_equal():
    hi, lo = _keys(seed=3)
    gates = np.random.default_rng(4).random((6, hi.size)) < 0.5
    js = jrng.make_stream(jnp.asarray(hi), jnp.asarray(lo))
    ts = trng.make_stream(_t(hi), _t(lo))
    for g in gates:
        ju, js = jrng.next_uniform(js, gate=jnp.asarray(g))
        tu, ts = trng.next_uniform(ts, gate=torch.as_tensor(g))
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        ju1, ju2, js = jrng.next_uniform2(js, gate=jnp.asarray(~g))
        tu1, tu2, ts = trng.next_uniform2(ts, gate=torch.as_tensor(~g))
        np.testing.assert_array_equal(np.asarray(ju1), tu1.numpy())
        np.testing.assert_array_equal(np.asarray(ju2), tu2.numpy())
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


@pytest.mark.parametrize('ids', [np.arange(64), np.array([0, 1, 2 ** 31,
                                                          2 ** 32 - 1])])
def test_lattice_and_cp_bit_equal(ids):
    jl = np.asarray(jqmc.extensible_lattice_2d(jnp.asarray(ids, jnp.uint32)))
    tl = tqmc.extensible_lattice_2d(_t(ids)).numpy()
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_array_equal(
        tl, jqmc.extensible_lattice_2d_np(ids.astype(np.uint32)))
    cp = rng_host.random_per_pixel_fast(7, 5)
    jc = np.asarray(jqmc.cranley_patterson(jnp.asarray(jl[3])[None],
                                           jnp.asarray(cp)))
    tc = tqmc.cranley_patterson(torch.as_tensor(tl[3])[None],
                                torch.as_tensor(cp)).numpy()
    np.testing.assert_array_equal(jc, tc)


def test_generate_rays_matches_jax():
    w, h = 16, 12
    rng = np.random.default_rng(5)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    dx, dy, ax, ay = (rng.random(w * h).astype(np.float32) - 0.5
                      for _ in range(4))
    args = dict(position=(1.0, 2.0, 50.0), direction=(0.1, -0.2, -1.0),
                up=(0.0, 1.0, 0.0), aperture=0.3)
    jc = jcam.make_camera(**args)
    tc = tcam.make_camera(**args)
    jo, jd = jcam.generate_rays(jc, jnp.asarray(ii), jnp.asarray(jj),
                                jnp.asarray(dx), jnp.asarray(dy),
                                jnp.asarray(ax * 0.3), jnp.asarray(ay * 0.3),
                                w, h, init_t=0.5)
    to, td = tcam.generate_rays(tc, torch.as_tensor(ii), torch.as_tensor(jj),
                                torch.as_tensor(dx), torch.as_tensor(dy),
                                torch.as_tensor(ax * 0.3),
                                torch.as_tensor(ay * 0.3), w, h, init_t=0.5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=RTOL * 50)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=RTOL)


def test_random_cos_and_phong_match_jax():
    rng = np.random.default_rng(6)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    r1, r2 = rng.random((2, 512)).astype(np.float32)
    e = rng.uniform(1.0, 60.0, 512).astype(np.float32)
    jd = jsampling.random_cos(jnp.asarray(n), jnp.asarray(r1), jnp.asarray(r2))
    td = tsampling.random_cos(torch.as_tensor(n), torch.as_tensor(r1),
                              torch.as_tensor(r2))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=RTOL)
    jp = jsampling.random_phong(jnp.asarray(n), jnp.asarray(e),
                                jnp.asarray(r1), jnp.asarray(r2))
    tp = tsampling.random_phong(torch.as_tensor(n), torch.as_tensor(e),
                                torch.as_tensor(r1), torch.as_tensor(r2))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=RTOL)
