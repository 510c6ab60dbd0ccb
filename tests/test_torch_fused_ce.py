"""Port parity: the plain fused cross-entropy of repro_torch.kernels.fused_ce
against the JAX Pallas kernel ``fused_ce`` (interpret mode on the CPU) and
the JAX reference ``fused_ce_ref``, and the ``FusedCE`` gradients against
``jax.grad`` of Σ ``fused_ce_ref``. The CUDA kernel is held against the plain
version on the card (``test_torch_cuda.py``).

The port (like the Pallas kernel) forms float32 products of its inputs'
values; JAX's ``fused_ce_ref`` multiplies bfloat16 inputs in bfloat16 and
rounds the logits, so for bfloat16 inputs it is given the same values as
float32 arrays. Tolerance 1e-5: float32 sums over D ≤ 128 in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_ce.ops import fused_ce as jax_kernel
from repro.kernels.fused_ce.ref import fused_ce_ref as jax_ref
from repro_torch.kernels.fused_ce import ops
from repro_torch.kernels.fused_ce.ref import fused_ce_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(t, d, v, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    lab = rng.integers(0, v, t).astype(np.int32)
    return x, w, lab


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


# tests/test_kernels.py::test_fused_ce's shapes, and a ragged T (13, 21)
# that the Pallas wrapper pads to its token block
@pytest.mark.parametrize("t,d,v,bt,bv", [
    (16, 64, 512, 8, 128), (24, 128, 1024, 8, 256), (8, 32, 256, 8, 256),
    (13, 64, 512, 8, 128), (21, 32, 256, 8, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_reference(t, d, v, bt, bv, dtype):
    x, w, lab = _inputs(t, d, v, seed=t * d)
    tdt = getattr(torch, dtype)
    tx, tw = _torch(x, tdt), _torch(w, tdt)
    lse, tgt = fused_ce_ref(tx, tw, torch.from_numpy(lab))
    nll = ops.fused_ce(tx, tw, torch.from_numpy(lab))
    assert torch.equal(nll, lse - tgt)
    # the values the port multiplies, as JAX arrays of the input dtype
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    jw = jnp.asarray(tw.float().numpy()).astype(getattr(jnp, dtype))
    want_kernel = np.asarray(jax_kernel(jx, jw, jnp.asarray(lab),
                                        block_t=bt, block_v=bv,
                                        interpret=True))
    want_ref = np.asarray(jax_ref(jx.astype(jnp.float32),
                                  jw.astype(jnp.float32), jnp.asarray(lab)))
    np.testing.assert_allclose(nll.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(nll.numpy(), want_ref, **TOL)
    # lse alone, against the reference's logsumexp
    logits = np.asarray(jx.astype(jnp.float32) @ jw.astype(jnp.float32))
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.scipy.special.logsumexp(logits, -1)),
        **TOL)


def _jax_grads(x, w, lab, weights):
    f = lambda xx, ww: jnp.sum(jnp.asarray(weights)
                               * jax_ref(xx, ww, jnp.asarray(lab)))
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(gx), np.asarray(gw)


def _port_grads(x, w, lab, weights):
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    nll = ops.fused_ce(tx, tw, torch.from_numpy(lab).long())
    (nll * torch.from_numpy(weights)).sum().backward()
    return tx.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("t,d,v", [(16, 64, 512), (40, 32, 256)])
def test_gradients_match_jax_grad(t, d, v):
    """dx and dw of Σ c_t·nll_t (per-token weights c, as the mean's 1/T is)
    against jax.grad of the reference, float32."""
    x, w, lab = _inputs(t, d, v, seed=3 + t)
    c = np.random.default_rng(t).uniform(0.5, 1.5, t).astype(np.float32)
    gx, gw = _port_grads(x, w, lab, c)
    wx, ww = _jax_grads(x, w, lab, c)
    np.testing.assert_allclose(gx, wx, **TOL)
    np.testing.assert_allclose(gw, ww, **TOL)


@pytest.mark.parametrize("t", [1, 255, 256, 600])
def test_backward_chunking(t):
    """The backward's 256-token chunks: one partial chunk (T=1, 255), one
    whole (256), two whole and a partial (600) give the gradients of the
    unchunked reference."""
    x, w, lab = _inputs(t, 32, 256, seed=t)
    c = np.full(t, 1.0 / t, np.float32)
    gx, gw = _port_grads(x, w, lab, c)
    wx, ww = _jax_grads(x, w, lab, c)
    np.testing.assert_allclose(gx, wx, **TOL)
    np.testing.assert_allclose(gw, ww, **TOL)


def test_bf16_gradients_follow_the_reference_chunk_vjp():
    """In bfloat16 the backward recomputes the logits in bfloat16 and casts
    dlogits back, as the reference's chunk VJP does: against jax.grad of
    fused_ce_ref on bfloat16 inputs (whose logits are bfloat16 products),
    to bfloat16 rounding."""
    x, w, lab = _inputs(48, 64, 512, seed=5)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    ops.fused_ce(tx, tw, torch.from_numpy(lab).long()).mean().backward()
    f = lambda xx, ww: jnp.mean(jax_ref(xx, ww, jnp.asarray(lab)))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    gx, gw = jax.grad(f, argnums=(0, 1))(jx, jw)
    for got, want in ((tx.grad, gx), (tw.grad, gw)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


def test_wrapper_runs_plain_version_on_cpu_and_checks_operands():
    x, w, lab = _inputs(9, 16, 64, seed=1)
    before = ops.launch_count
    lse, tgt = ops.lse_and_target(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(lab))
    assert ops.launch_count == before  # the kernel only runs on the card
    assert lse.shape == tgt.shape == (9,) and lse.dtype == torch.float32
    with pytest.raises(ValueError, match="do not chain"):
        ops.lse_and_target(torch.zeros(3, 4), torch.zeros(5, 8),
                           torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="integers"):
        ops.lse_and_target(torch.zeros(3, 4), torch.zeros(4, 8),
                           torch.zeros(3))
