"""Port parity: repro_torch.core.numerics and repro_torch.random against the
JAX reference (Threefry, counter bits and key words bitwise; δ formulas to
rtol 1e-6; jax.random draws bitwise, normals within 4 ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import numerics as jnum
from repro_torch import random as jr
from repro_torch.core import numerics as tnum

RNG = np.random.default_rng(1234)


def _i32(a):
    return tnum.to_int32(a).numpy()


def test_threefry_bitwise_on_random_words():
    w = RNG.integers(-(2**31), 2**31, size=(4, 4096), dtype=np.int64).astype(np.int32)
    y0, y1 = jnum.threefry2x32(*(jnp.asarray(v) for v in w))
    t0, t1 = tnum.threefry2x32(*(torch.from_numpy(v) for v in w))
    np.testing.assert_array_equal(np.asarray(y0), _i32(t0))
    np.testing.assert_array_equal(np.asarray(y1), _i32(t1))


@pytest.mark.parametrize("draw", [tnum.DRAW_DARKEN, tnum.DRAW_CAND, tnum.DRAW_BRIGHT])
def test_counter_bits24_and_uniform_bitwise(draw):
    kw = RNG.integers(-(2**31), 2**31, size=2, dtype=np.int64).astype(np.int32)
    datum = RNG.integers(0, 2**31, size=3000, dtype=np.int64).astype(np.int32)
    ref = np.asarray(jnum.counter_bits24(jnp.asarray(kw), draw, jnp.asarray(datum)))
    kw_t = torch.from_numpy(kw.astype(np.int64))[None]
    got = tnum.counter_bits24(kw_t, draw, torch.from_numpy(datum)[None])[0]
    np.testing.assert_array_equal(ref, got.numpy())
    ref_u = np.asarray(jnum.counter_uniform(jnp.asarray(kw), draw, jnp.asarray(datum)))
    got_u = tnum.counter_uniform(kw_t, draw, torch.from_numpy(datum)[None])[0]
    np.testing.assert_array_equal(ref_u, got_u.numpy())


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_key_words_bitwise(seed):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    ref = np.asarray(jnum.key_words_of(k))
    got = tnum.key_words_of(jr.fold_in(jr.key(seed, device="cpu"), 3))
    np.testing.assert_array_equal(ref, _i32(got))


def test_delta_formulas_match_reference():
    s = RNG.normal(0, 4, 5000).astype(np.float32)
    xi = np.abs(RNG.normal(0, 3, 5000)).astype(np.float32)
    xi[:50] = RNG.uniform(-5e-5, 5e-5, 50).astype(np.float32)  # Taylor branch
    d = np.abs(RNG.normal(0, 30, 5000)).astype(np.float32)
    d[:20] = 0.0
    ts = lambda a: torch.from_numpy(a)
    pairs = [
        (jnum.log_expm1(jnp.asarray(d)), tnum.log_expm1(ts(d))),
        (jnum.jj_a(jnp.asarray(xi)), tnum.jj_a(ts(xi))),
        (jnum.jj_c(jnp.asarray(xi)), tnum.jj_c(ts(xi))),
        (jnum.logistic_delta(jnp.asarray(s), jnp.asarray(xi)),
         tnum.logistic_delta(ts(s), ts(xi))),
        (jnum.student_t_delta(jnp.asarray(s), jnp.asarray(xi), 4.0, 1.5),
         tnum.student_t_delta(ts(s), ts(xi), 4.0, 1.5)),
        (jax.nn.softplus(jnp.asarray(s)), tnum.softplus(ts(s))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_softmax_delta_padded_matches_reference():
    b, kc, kp = 400, 3, 8
    eta = RNG.normal(0, 2, (b, kp)).astype(np.float32)
    eta0 = RNG.normal(0, 2, (b, kp)).astype(np.float32)
    t = RNG.integers(0, kc, b)
    onehot = np.eye(kp, dtype=np.float32)[t]
    ref = jnum.softmax_delta_padded(jnp.asarray(eta), jnp.asarray(eta0),
                                    jnp.asarray(onehot), kc)
    got = tnum.softmax_delta_padded(torch.from_numpy(eta), torch.from_numpy(eta0),
                                    torch.from_numpy(onehot), kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_tree_sum_is_invariant_to_zero_padding_and_batch():
    x = torch.from_numpy(RNG.normal(0, 1, (3, 37)).astype(np.float32))
    base = tnum.tree_sum(x)
    padded = tnum.tree_sum(torch.nn.functional.pad(x, (0, 91)))
    assert torch.equal(base, padded)
    assert torch.equal(tnum.tree_sum(x[1:2]), base[1:2])
    np.testing.assert_allclose(base.numpy(), x.double().sum(-1).numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# repro_torch.random against jax.random (threefry, partitionable)
# ---------------------------------------------------------------------------


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 3, 123456789])
def test_split_and_fold_in_bitwise(seed):
    kj, kt = jax.random.key(seed), jr.key(seed, device="cpu")
    np.testing.assert_array_equal(_kd(kj), kt.numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_kd(jax.random.split(kj, num)),
                                      jr.split(kt, num).numpy())
    for data in (0, 1, 999, 2**31 + 5):
        np.testing.assert_array_equal(_kd(jax.random.fold_in(kj, data)),
                                      jr.fold_in(kt, data).numpy())
    ks_j, ks_t = jax.random.split(kj, 4), jr.split(kt, 4)
    batched = jax.vmap(lambda k: jax.random.fold_in(k, 17))(ks_j)
    np.testing.assert_array_equal(_kd(batched), jr.fold_in(ks_t, 17).numpy())


@pytest.mark.parametrize("shape", [(), (7,), (33, 5)])
def test_uniform_bernoulli_randint_bitwise(shape):
    kj, kt = jax.random.key(11), jr.key(11, device="cpu")
    u = np.asarray(jax.random.uniform(kj, shape))
    np.testing.assert_array_equal(u.view(np.int32),
                                  jr.uniform(kt, shape).numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(kj, 0.02, shape)),
                                  jr.bernoulli(kt, 0.02, shape).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.randint(kj, shape, 0, 3)),
                                  jr.randint(kt, shape, 0, 3).numpy())
    ks_j, ks_t = jax.random.split(kj, 3), jr.split(kt, 3)
    ub = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(ks_j))
    np.testing.assert_array_equal(ub, jr.uniform(ks_t, shape).numpy())


def test_normal_within_4_ulp():
    kj, kt = jax.random.key(5), jr.key(5, device="cpu")
    ref = np.asarray(jax.random.normal(kj, (20000,))).view(np.int32).astype(np.int64)
    got = jr.normal(kt, (20000,)).numpy().view(np.int32).astype(np.int64)
    assert np.max(np.abs(ref - got)) <= 4
