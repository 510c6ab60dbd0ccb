"""Port parity: the plain flash-decode of repro_torch.kernels.decode_attention
against the JAX reference ``decode_attention_ref`` and the JAX Pallas kernel
``decode_attention`` (interpret mode on the CPU), on the shapes of
``tests/test_kernels.py::test_decode_attention``, the ring-wraparound case and
the serving path's head layout (D=256, MQA, window 2048). The CUDA kernel is
held against the plain version on the card (``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# Tolerances of the JAX kernel test: f32 2e-5; bf16 inputs 2e-2 (both sides
# upcast the same bf16 values, so the gap is f32 summation order).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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
