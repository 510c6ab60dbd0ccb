"""Port parity: the plain chunked WKV6 of repro_torch.kernels.rwkv6_scan
against the JAX Pallas kernel ``rwkv6_scan`` (interpret mode on the CPU),
the JAX sequential oracle ``rwkv6_ref`` (with a carried-in state) and the
model's own chunk ``layers._wkv_chunk`` chained over chunks. The CUDA kernel
is held against the plain version on the card (``test_torch_cuda.py``).

Tolerances: 3e-4 against the Pallas kernel and the sequential oracle (the
tolerance of ``tests/test_kernels.py::test_rwkv6_scan``: the closed form
scales by e^{±cumsum logw} and the two sum in other orders); 1e-5 against
``_wkv_chunk``, which is the same closed form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_kernel
from repro.kernels.rwkv6_scan.ref import rwkv6_ref as jax_ref
from repro.models.layers import _wkv_chunk as jax_wkv_chunk
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_chunked_ref,
                                                 rwkv6_seq_ref)


def _inputs(b, h, s, d, seed, logw=None, lo=0.01, hi=0.9):
    """r, k, v, logw (B, H, S, D), u (H, D), state0 (B, H, D, D) float32;
    logw uniform in [-hi, -lo] unless given."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    lw = (-rng.uniform(lo, hi, size=(b, h, s, d)).astype(np.float32)
          if logw is None else np.full((b, h, s, d), logw, np.float32))
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32)
    return r, k, v, lw, u, s0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_chunks(r, k, v, lw, u, s0, c):
    """The model's path: ``_wkv_chunk`` over chunks of c, state carried."""
    state = jnp.asarray(s0)
    ys = []
    for i in range(0, r.shape[2], c):
        sl = slice(i, i + c)
        y, state = jax.jit(jax_wkv_chunk)(
            *(jnp.asarray(a[:, :, sl]) for a in (r, k, v, lw)),
            jnp.asarray(u), state)
        ys.append(y)
    return np.asarray(jnp.concatenate(ys, axis=2)), np.asarray(state)


def _close(got, want, tol):
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize(
    "b,h,s,d,chunk", [(2, 3, 64, 16, 16), (1, 2, 128, 64, 64), (2, 1, 96, 32, 32)]
)
def test_plain_matches_pallas_kernel(b, h, s, d, chunk):
    """The shapes of tests/test_kernels.py::test_rwkv6_scan, zero state."""
    r, k, v, lw, u, _ = _inputs(b, h, s, d, seed=s + d)
    want = jax_kernel(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                      chunk=chunk)
    got = ops.rwkv6_scan(*_t(r, k, v, lw, u), chunk=chunk)
    _close(got, want, 3e-4)


@pytest.mark.parametrize("s,chunk", [(128, 64), (96, 32), (40, 8)])
def test_plain_matches_sequential_oracle_with_state0(s, chunk):
    """A random carried-in state: against the JAX ``rwkv6_ref(state0=)``,
    and the port's own sequential oracle against the same."""
    r, k, v, lw, u, s0 = _inputs(2, 3, s, 32, seed=s)
    want = jax_ref(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                   state0=jnp.asarray(s0))
    _close(ops.rwkv6_scan(*_t(r, k, v, lw, u, s0), chunk=chunk), want, 3e-4)
    _close(rwkv6_seq_ref(*_t(r, k, v, lw, u, s0)), want, 3e-4)


@pytest.mark.parametrize("b,h,s,d,chunk,logw", [
    (2, 4, 128, 32, 64, None),  # the reduced model's heads
    (1, 2, 192, 64, 64, None),  # the published head dim
    (2, 3, 32, 32, 64, None),  # S = 32 < chunk: c = 32
    (1, 2, 33, 16, 64, None),  # c = 33, the reference's rule at S = 33
    (2, 2, 5, 16, 1, None),  # c = 1
    (1, 2, 1, 64, 64, None),  # a single step
    (1, 2, 128, 64, 64, -1.0),  # edge decay: e^{±64} inside a chunk
])
def test_plain_matches_model_chunks(b, h, s, d, chunk, logw):
    """The model's own closed form chained over chunks with a carried
    state, logw in [-1, -1e-6] (the model's clip)."""
    r, k, v, lw, u, s0 = _inputs(b, h, s, d, seed=s * d, logw=logw,
                                 lo=1e-6, hi=1.0)
    c = min(chunk, s)
    want = _jax_chunks(r, k, v, lw, u, s0, c)
    got = ops.rwkv6_scan(*_t(r, k, v, lw, u, s0), chunk=chunk)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    tol = 1e-5 * max(1.0, float(np.abs(want[0]).max()))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5, atol=tol)


def test_chunking_does_not_change_the_function():
    """One sequence through chunks of 64, 16 and 1 and through the
    sequential oracle: the same y and state to float32 rounding (3e-4),
    including the edge decay logw = -1."""
    for logw in (None, -1.0):
        r, k, v, lw, u, s0 = _inputs(1, 2, 128, 32, seed=5, logw=logw)
        ref = rwkv6_seq_ref(*_t(r, k, v, lw, u, s0))
        for chunk in (64, 16, 1):
            got = rwkv6_chunked_ref(*_t(r, k, v, lw, u, s0), chunk=chunk)
            for g, w_ in zip(got, ref):
                torch.testing.assert_close(g, w_, rtol=3e-4, atol=3e-4)


def test_wrapper_runs_plain_version_on_cpu():
    r, k, v, lw, u, s0 = _t(*_inputs(2, 2, 48, 16, seed=9))
    before = ops.launch_count
    got = ops.rwkv6_scan(r, k, v, lw, u, s0, chunk=16)
    want = rwkv6_chunked_ref(r, k, v, lw, u, s0, chunk=16)
    assert ops.launch_count == before  # the kernel only runs on the card
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, lw, u, s0 = _t(*_inputs(1, 2, 48, 16, seed=3))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.rwkv6_scan(r, k, v, lw, u, chunk=32)  # 48 % 32 != 0
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6_scan(r, k, v, lw, u, chunk=128)
    big = _t(*_inputs(1, 1, 8, 80, seed=4))  # D = 80 > 64
    with pytest.raises(ValueError, match="head dim 80"):
        ops.rwkv6_scan(*big[:5])
    with pytest.raises(ValueError, match="u must be"):
        ops.rwkv6_scan(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="state0 must be"):
        ops.rwkv6_scan(r, k, v, lw, u, s0[..., :8])
    with pytest.raises(ValueError, match="float32"):
        ops.rwkv6_scan(r.double(), k, v, lw, u)
    meta = [a.to("meta") for a in (r, k, v, lw, u)]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rwkv6_scan(*meta)
