"""PyTorch port, the fp32 probe product's rounding (ops/sweep_micro.py):
`fma_rn`, the exactly rounded fp32 FMA that states what CUDA's __fmaf_rn
computes, and `dot_plain`, the FMA chain that the fp32 kernel follows.

Every expected value comes from an exact oracle: a * b + c in Fractions,
rounded once to fp32 (nearest, ties to even, subnormals kept, +-inf past
the largest float).  Bits are compared, so -0.0 differs from +0.0.
  * built double-rounding cases (a * b = 2^-24 (1 + t), 0 < t < 2^-29, c =
    1: the exact sum lies just above the fp32 midpoint 1 + 2^-24), where
    rounding the float64 sum straight to fp32 is wrong on every case;
  * random, cancelling and wide-exponent triples, signed zeros, subnormal
    results, overflow to +-inf, and a property test over finite triples;
  * `dot_plain`, both routes, against a scalar statement of the chain on
    the oracle; the fp32 route differs from the old unfused chain, the
    TF32 route does not (a product of two TF32 values is exact in fp32).
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pathtracer_tpu_torch.ops import sweep_micro as sm
from pathtracer_tpu_torch.scripts import prof_sweep
from test_torch_cluster import one_torch_thread  # noqa: F401

F32_MAX = float(np.finfo(np.float32).max)


def _round_f32(q: Fraction) -> float:
    """q rounded to fp32, to nearest with ties to even; subnormals kept,
    +-inf at or past FLT_MAX + half an ulp; a nonzero q that rounds to zero
    keeps its sign."""
    neg, q = q < 0, abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    m = q / quantum
    n = m.numerator // m.denominator
    rem = m - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    v = n * quantum
    f = math.inf if v >= Fraction(2) ** 128 else float(v)
    return -f if neg else f


def _fma_exact(a: float, b: float, c: float) -> float:
    """fp32 fma(a, b, c) rounded once, as IEEE 754 states it."""
    q = Fraction(a) * Fraction(b) + Fraction(c)
    if q != 0:
        return _round_f32(q)
    if (a == 0 or b == 0) and c == 0:
        # a sum of two zeros is -0.0 only when both are -0.0
        neg = (math.copysign(1, a) * math.copysign(1, b) < 0
               and math.copysign(1, c) < 0)
        return -0.0 if neg else 0.0
    return 0.0                      # exact cancellation: +0.0


def _f32(v):
    return np.asarray(v, dtype=np.float32)


def _check(a, b, c):
    """fma_rn on (a, b, c) equals the oracle bit for bit; returns the
    float64-once rounding for the caller to inspect."""
    a, b, c = _f32(a), _f32(b), _f32(c)
    got = sm.fma_rn(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = _f32([_fma_exact(float(x), float(y), float(z))
                 for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with np.errstate(over='ignore'):
        once = (a.astype(np.float64) * b + c.astype(np.float64)).astype(
            np.float32)
    return want, once


def test_fma_rn_on_built_double_rounding_cases(one_torch_thread):
    a, b, c = prof_sweep.double_rounding_cases()
    assert len(a) == 6224
    want, once = _check(a, b, c)
    # the exact sum lies above the midpoint: it rounds up, and the float64
    # sum, itself rounded down onto the midpoint, rounds to even (down)
    assert (want == np.float32(1 + 2.0 ** -23)).all()
    assert (once != want).all()


@pytest.mark.parametrize('kind', ['random', 'cancelling', 'wide'])
def test_fma_rn_matches_the_oracle(one_torch_thread, kind):
    rng = np.random.default_rng({'random': 1, 'cancelling': 2,
                                 'wide': 3}[kind])
    n = 4000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    if kind == 'random':
        c = rng.standard_normal(n).astype(np.float32)
    elif kind == 'cancelling':
        # c near -a*b: the rounded product plus a few ulps, so that the
        # sum cancels most of its bits
        c = -(a * b) + (rng.integers(-4, 5, n)
                        * np.spacing(a * b)).astype(np.float32)
    else:
        a = a * np.exp2(rng.integers(-60, 61, n)).astype(np.float32)
        b = b * np.exp2(rng.integers(-60, 61, n)).astype(np.float32)
        c = (rng.standard_normal(n)
             * np.exp2(rng.integers(-120, 121, n))).astype(np.float32)
    _check(a, b, c)


def test_fma_rn_signed_zeros(one_torch_thread):
    """The sign of a zero result follows IEEE 754: a zero product plus a
    zero is -0.0 only when both are -0.0; an exact cancellation is +0.0."""
    z = [(0.0, 3.0, 0.0, 0.0), (-0.0, 3.0, 0.0, 0.0), (0.0, -3.0, 0.0, 0.0),
         (-0.0, 3.0, -0.0, -0.0), (0.0, -3.0, -0.0, -0.0),
         (-0.0, -3.0, -0.0, 0.0), (0.0, 3.0, -0.0, 0.0), (2.0, 3.0, -6.0, 0.0),
         (-2.0, 3.0, 6.0, 0.0), (1.5, 2.0 ** -100, -0.0, 1.5 * 2.0 ** -100),
         (2.0 ** -100, 2.0 ** -100, -0.0, 0.0),
         (-(2.0 ** -100), 2.0 ** -100, 0.0, -0.0)]
    a, b, c, expected = (np.array(col, np.float32) for col in zip(*z))
    want, _ = _check(a, b, c)
    np.testing.assert_array_equal(want.view(np.int32),
                                  expected.view(np.int32))


def test_fma_rn_subnormal_results(one_torch_thread):
    """Results below 2^-126 keep their bits, as nvcc keeps denormals
    without -ftz=true; the rounding there is to the subnormal grid."""
    rng = np.random.default_rng(4)
    n = 4000
    a = (rng.standard_normal(n) * 2.0 ** -70).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** -62).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** -133).astype(np.float32)
    want, _ = _check(a, b, c)
    tiny = np.abs(want) < np.finfo(np.float32).tiny
    assert tiny.mean() > 0.9 and (want[tiny] != 0).mean() > 0.9


def test_fma_rn_overflow(one_torch_thread):
    """Past FLT_MAX + half an ulp the result is +-inf; an exact product
    beyond FLT_MAX brought back into range by c is finite."""
    big = 2.0 ** 127
    a = [big, -big, big, F32_MAX, F32_MAX, F32_MAX]
    b = [2.0, 2.0, 3.0, 1.0, 1.0, 2.0]
    c = [0.0, 0.0, -F32_MAX, 2.0 ** 103, 2.0 ** 102, -F32_MAX]
    want, _ = _check(a, b, c)
    assert want[0] == np.inf and want[1] == -np.inf
    assert want[2] == big + 2.0 ** 104
    assert want[3] == np.inf               # the tie at FLT_MAX + ulp / 2
    assert want[4] == F32_MAX and want[5] == F32_MAX


_finite = st.floats(width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=400, deadline=None, database=None, derandomize=True)
@given(st.lists(st.tuples(_finite, _finite, _finite), min_size=1,
                max_size=8))
def test_fma_rn_property(triples):
    a, b, c = (np.array(col, np.float32) for col in zip(*triples))
    _check(a, b, c)


def _chain_scalar(x, w, reps, eps, tf32, fused=True):
    """The fp32 product's statement, one output at a time on the oracle
    (fused) or with the product rounded before its sum (the old chain)."""
    steps = sm.rep_steps(reps, eps, 'cpu').numpy()
    if tf32:
        w = sm.round_tf32(torch.as_tensor(w)).numpy()
    m, n = x.shape[0], w.shape[1]
    acc = np.zeros((m, n), np.float32)
    for i in range(reps):
        r = x + steps[i]
        if tf32:
            r = sm.round_tf32(torch.as_tensor(r)).numpy()
        for row in range(m):
            for col in range(n):
                s = np.float32(r[row, 0] * w[0, col])
                for k in range(1, sm.AR):
                    if fused:
                        s = np.float32(_fma_exact(float(r[row, k]),
                                                  float(w[k, col]), float(s)))
                    else:
                        s = np.float32(s + np.float32(r[row, k] * w[k, col]))
                acc[row, col] = np.float32(acc[row, col] + s)
    return acc


@pytest.mark.parametrize('tf32', [False, True])
@pytest.mark.parametrize('eps', [1e-3, 1e-7])
def test_dot_plain_is_the_fma_chain(one_torch_thread, tf32, eps):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, sm.AR)).astype(np.float32)
    w = rng.standard_normal((sm.AR, 64)).astype(np.float32)
    reps = 3
    out, pairs = sm.dot_plain(torch.as_tensor(x), torch.as_tensor(w), reps,
                              eps, 40, tf32)
    want = _chain_scalar(x, w, reps, eps, tf32)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want[:, :40].view(np.int32))
    np.testing.assert_array_equal(
        pairs.numpy().view(np.int32),
        (want[:, 0::2] + want[:, 1::2]).view(np.int32))
    unfused = _chain_scalar(x, w, reps, eps, tf32, fused=False)
    if tf32:
        np.testing.assert_array_equal(unfused.view(np.int32),
                                      want.view(np.int32))
    else:
        assert (unfused != want).mean() > 0.05
