"""Port parity: the plain RG-LRU recurrence of repro_torch.kernels.rglru_scan
against the JAX reference ``rglru_ref``, the JAX Pallas kernel ``rglru_scan``
(interpret mode on the CPU) and the model's own ``layers._rglru_scan``. The
CUDA kernel is held against the plain version on the card
(``test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ops import rglru_scan as jax_kernel
from repro.kernels.rglru_scan.ref import rglru_ref as jax_ref
from repro.models.layers import _rglru_scan as jax_model_scan
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import rglru_ref


def _np(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


@pytest.mark.parametrize(
    "b,s,c,chunk", [(2, 64, 96, 16), (1, 128, 256, 64), (3, 96, 130, 32)]
)
def test_plain_matches_jax_kernel_and_reference(b, s, c, chunk):
    """The JAX kernel test's own range: log_a in [-2, -0.001], chunk <= 64
    (the closed form of the Pallas kernel stays finite there). 3e-4, the
    kernel test's tolerance."""
    rng = np.random.default_rng(s + c)
    la = -rng.uniform(0.001, 2.0, size=(b, s, c)).astype(np.float32)
    bx = rng.normal(size=(b, s, c)).astype(np.float32)
    y, hf = rglru_ref(torch.from_numpy(la), torch.from_numpy(bx))
    for want in (jax_ref(jnp.asarray(la), jnp.asarray(bx)),
                 jax_kernel(jnp.asarray(la), jnp.asarray(bx), chunk=chunk)):
        wy, wh = _np(*want)
        np.testing.assert_allclose(y.numpy(), wy, rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(hf.numpy(), wh, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("log_a", [-5.25, -1e-6])
def test_plain_matches_model_scan_at_model_decays(log_a):
    """At the model's own gates (softplus(1)·8·0.5 ≈ 5.25 per step, where the
    Pallas kernel's e^{-cumA} overflows) and at the slowest decay the clip
    allows, the port stays finite and matches the model's associative scan.
    1e-5 absolute and relative: float32 rounding of a few hundred steps."""
    rng = np.random.default_rng(7)
    b, s, c = 2, 256, 64
    la = (log_a * rng.uniform(0.9, 1.1, size=(b, s, c))).astype(np.float32)
    bx = rng.normal(size=(b, s, c)).astype(np.float32)
    y, hf = rglru_ref(torch.from_numpy(la), torch.from_numpy(bx))
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    want = np.asarray(jax.jit(jax_model_scan)(jnp.asarray(la),
                                              jnp.asarray(bx)))
    tol = 1e-5 if log_a < -1 else 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(hf.numpy(), want[:, -1], rtol=1e-5, atol=tol)


def test_h0_carries_across_a_split_sequence():
    """Scanning [0, 40) then [40, 100) from the first part's final state
    equals scanning [0, 100) at once, bitwise; h0 matches the JAX
    reference's h0."""
    rng = np.random.default_rng(11)
    la = -rng.uniform(0.01, 3.0, size=(2, 100, 48)).astype(np.float32)
    bx = rng.normal(size=(2, 100, 48)).astype(np.float32)
    tla, tbx = torch.from_numpy(la), torch.from_numpy(bx)
    y, hf = rglru_ref(tla, tbx)
    y1, h1 = rglru_ref(tla[:, :40], tbx[:, :40])
    y2, h2 = rglru_ref(tla[:, 40:], tbx[:, 40:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, hf)
    wy, wh = _np(*jax_ref(jnp.asarray(la[:, 40:]), jnp.asarray(bx[:, 40:]),
                          jnp.asarray(h1.numpy())))
    np.testing.assert_allclose(y2.numpy(), wy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), wh, rtol=1e-5, atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu():
    la = -torch.rand(2, 30, 20) - 0.01
    bx = torch.randn(2, 30, 20)
    h0 = torch.randn(2, 20)
    before = ops.launch_count
    got = ops.rglru_scan(la, bx, h0)
    want = rglru_ref(la, bx, h0)
    assert ops.launch_count == before  # the kernel only runs on the card
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
