"""Port parity: the plain flash-decode of repro_torch.kernels.decode_attention
against the JAX reference ``decode_attention_ref`` and the JAX Pallas kernel
``decode_attention`` (interpret mode on the CPU), on the shapes of
``tests/test_kernels.py::test_decode_attention``, the ring-wraparound case and
the serving path's head layout (D=256, MQA, window 2048); the split-and-merge
plan the CUDA kernel runs (per-split partials merged in split order) against
the whole reference and the JAX one; the wrapper's split planner. The CUDA
kernel is held against the plain version on the card
(``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    split_merge_ref,
    split_partials_ref,
)

# Tolerances of the JAX kernel test: f32 2e-5; bf16 inputs 2e-2 (both sides
# upcast the same bf16 values, so the gap is f32 summation order).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H100_SMS = 132  # the wrapper reads the SM count off the card it launches on


def _inputs(b, h, hk, d, w, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, w, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, w, hk, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, pos, t, window, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    return jx, tx


def _check(got, want, tol):
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,h,hk,d,w,t,window",
    [
        (2, 8, 2, 128, 256, 200, None),
        (1, 4, 4, 128, 384, 380, 128),
        (2, 16, 2, 128, 256, 100, None),
        (1, 8, 1, 128, 512, 511, 256),  # MQA + window
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(b, h, hk, d, w, t, window, dtype):
    q, k, v = _inputs(b, h, hk, d, w, seed=w + h)
    pos = np.where(np.arange(w) < t + 1, np.arange(w), -1).astype(np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v, pos, t, window, dtype)
    got = decode_attention_ref(tq, tk, tv, torch.from_numpy(pos), t, window)
    want_ref = jax_ref(jq, jk, jv, jnp.asarray(pos), t, window=window)
    want_kernel = jax_kernel(jq, jk, jv, jnp.asarray(pos), jnp.int32(t),
                             window=window)
    _check(got, want_ref, TOL[dtype])
    _check(got, want_kernel, TOL[dtype])


@pytest.mark.parametrize(
    "b,h,hk,d,w,t,window",
    [
        (1, 2, 1, 128, 128, 300, 128),  # test_kernels' wraparound case
        (2, 16, 1, 256, 256, 5000, 2048),  # the serving path's head layout
    ],
)
def test_ring_wraparound_matches_jax(b, h, hk, d, w, t, window):
    """Only slots with pos in (t - window, t] take part; slot s holds the
    largest position ≤ t that is ≡ s (mod W)."""
    q, k, v = _inputs(b, h, hk, d, w, seed=t)
    slots = np.arange(w)
    pos = (slots + ((t - slots) // w) * w).astype(np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v, pos, t, window, "float32")
    got = decode_attention_ref(tq, tk, tv, torch.from_numpy(pos), t, window)
    _check(got, jax_ref(jq, jk, jv, jnp.asarray(pos), t, window=window), 2e-5)
    _check(got, jax_kernel(jq, jk, jv, jnp.asarray(pos), jnp.int32(t),
                           window=window), 2e-5)


def test_fully_masked_row_matches_reference():
    """An empty ring (every pos = -1): m = -1e30, every weight 1, as the
    reference computes it."""
    q, k, v = _inputs(1, 4, 2, 32, 40, seed=3)
    pos = np.full(40, -1, np.int32)
    got = decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(pos), 7)
    want = jax_ref(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos), 7)
    _check(got, want, 2e-5)
    assert np.all(got[1].numpy() == -1e30) and np.all(got[2].numpy() == 40)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 96, seed=5))
    pos = torch.arange(96, dtype=torch.int32)
    before = ops.launch_count
    got = ops.decode_attention(q, k, v, pos, 90, 64)
    want = decode_attention_ref(q, k, v, pos, 90, 64)
    assert ops.launch_count == before  # the kernel only runs on the card
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def _ring(w, t, empty_from=None):
    """Ring positions after writing 0..t (slot s holds the largest p <= t
    with p = s mod W, or -1); slots from ``empty_from`` on are empty."""
    slots = np.arange(w)
    pos = slots + ((t - slots) // w) * w
    pos = np.where(pos >= 0, pos, -1)
    if empty_from is not None:
        pos[empty_from:] = -1
    return pos.astype(np.int32)


# (b, h, hk, d, w, t, window, empty_from): a ragged ring; whole splits masked
# on both sides of a 16-slot window in a partly filled ring; the serving
# path's head layout over a wrapped ring; an empty ring (fully masked rows).
SPLIT_CASES = {
    "ragged": (2, 8, 2, 64, 100, 90, None, None),
    "masked-splits": (1, 4, 1, 32, 130, 40, 16, None),
    "serving-layout": (1, 16, 1, 256, 256, 5000, 2048, None),
    "fully-masked": (2, 4, 2, 32, 45, 7, None, 0),
}


@pytest.mark.parametrize("split_len", [1, 7, 64, "W", "plan"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_merge_matches_whole_and_jax(case, split_len):
    """The ring cut into splits of 1, 7, 64, W slots (and the wrapper's
    plan), each split's (m_j, l_j, acc_j) merged in split order, equals the
    whole plain reference and the JAX reference. Float32 sums of the same
    terms in another order, values O(1): 1e-5 against the plain version,
    2e-5 (the JAX kernel test's float32 tolerance) against JAX."""
    b, h, hk, d, w, t, window, empty_from = SPLIT_CASES[case]
    q, k, v = _inputs(b, h, hk, d, w, seed=w + t)
    pos = _ring(w, t, empty_from)
    plan = ops.plan_splits(b * hk, w, H100_SMS)[0]
    n = {"W": w, "plan": plan}.get(split_len, split_len)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    m_j, l_j, acc_j = split_partials_ref(tq, tk, tv, tpos, t, window, n)
    assert m_j.shape[0] == -(-w // n)
    got = split_merge_ref(m_j, l_j, acc_j)
    whole = decode_attention_ref(tq, tk, tv, tpos, t, window)
    for g_, w_ in zip(got, whole):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
    _check(got, jax_ref(*(jnp.asarray(a) for a in (q, k, v, pos)), t,
                        window=window), 2e-5)
    if empty_from == 0:  # every row fully masked: m = -1e30, weights 1
        assert torch.all(got[1] == -1e30) and torch.all(got[2] == w)
        assert torch.all(l_j == torch.tensor(
            [min(n, w - s0) for s0 in range(0, w, n)])[:, None, None, None])
    if case == "masked-splits" and n == 7:
        # whole splits masked on both sides of the window (t - 16, t]
        assert torch.all(m_j[:3] == -1e30) and torch.all(m_j[6:] == -1e30)
        assert torch.all(m_j[3:6] > -1e30)


def test_plan_splits_fills_the_card():
    """At the serving shape (B·Hk = 4, W = 2048) the grid has at least one
    CTA per SM, every slot lies in exactly one split, and the last split is
    ragged; a small ring is one split; no split is shorter than
    MIN_SPLIT slots."""
    split, n = ops.plan_splits(4, 2048, H100_SMS)
    assert 4 * n >= H100_SMS
    assert split * (n - 1) < 2048 <= split * n
    assert 2048 % split != 0
    assert ops.plan_splits(4, 20, H100_SMS) == (ops.MIN_SPLIT, 1)
    assert ops.plan_splits(1, ops.MIN_SPLIT, H100_SMS) == (ops.MIN_SPLIT, 1)
    for bh, w in [(1, 100_000), (64, 2048), (2, 70), (132, 4096)]:
        split, n = ops.plan_splits(bh, w, H100_SMS)
        assert split >= ops.MIN_SPLIT and split * (n - 1) < w <= split * n
        assert bh * n >= H100_SMS or split == ops.MIN_SPLIT or n == 1
