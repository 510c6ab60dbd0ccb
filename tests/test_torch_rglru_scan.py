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
from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref, rglru_ref


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


def _grad_inputs(log_a, seed, b=2, s=96, c=40):
    rng = np.random.default_rng(seed)
    la = (log_a * rng.uniform(0.9, 1.1, size=(b, s, c))).astype(np.float32)
    la = np.minimum(la, -1e-6).astype(np.float32)  # the model's clip
    bx = rng.normal(size=(b, s, c)).astype(np.float32)
    h0 = rng.normal(size=(b, c)).astype(np.float32)
    g_h = rng.normal(size=(b, s, c)).astype(np.float32)
    g_last = rng.normal(size=(b, c)).astype(np.float32)
    return la, bx, h0, g_h, g_last


def _jax_scan_grads(la, bx, h0, g_h, g_last):
    """jax.grad of Σ ḡ·h + Σ ḡ_final·h_final through the model's own
    associative scan; h0 enters as b_0 + a_0·h0 (the recurrence's first
    step), or not at all when it is None."""

    def f(la_, bx_, h0_):
        if h0_ is not None:
            bx_ = bx_.at[:, 0].add(jnp.exp(la_[:, 0]) * h0_)
        h = jax_model_scan(la_, bx_)
        return jnp.sum(g_h * h) + jnp.sum(g_last * h[:, -1])

    args = (jnp.asarray(la), jnp.asarray(bx),
            None if h0 is None else jnp.asarray(h0))
    argnums = (0, 1) if h0 is None else (0, 1, 2)
    return [np.asarray(g) for g in jax.grad(f, argnums=argnums)(*args)]


def _torch_grads(scan, la, bx, h0, g_h, g_last):
    ts = [torch.from_numpy(a).requires_grad_() for a in (la, bx)]
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    h, h_last = scan(*ts, th0)
    ((h * torch.from_numpy(g_h)).sum()
     + (h_last * torch.from_numpy(g_last)).sum()).backward()
    return [t.grad.numpy() for t in ts + ([] if th0 is None else [th0])]


@pytest.mark.parametrize("log_a", [-5.25, -1.0, -1e-6])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_gradients_match_jax_grad(log_a, with_h0):
    """RGLRUScan's backward (the reversed recurrence) against jax.grad of
    the reference's ``_rglru_scan`` and torch autograd through the plain
    loop: ∂log_a, ∂b and ∂h0 with cotangents on every h_t and on h_final.
    1e-5 relative plus 1e-5 of the largest value (float32 sums of up to 96
    terms in another order)."""
    la, bx, h0, g_h, g_last = _grad_inputs(log_a, seed=int(-log_a * 7) + 3)
    h0 = h0 if with_h0 else None
    got = _torch_grads(ops.rglru_scan, la, bx, h0, g_h, g_last)
    for want in (_jax_scan_grads(la, bx, h0, g_h, g_last),
                 _torch_grads(rglru_ref, la, bx, h0, g_h, g_last)):
        assert len(got) == len(want)
        for a, w in zip(got, want):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


def test_scan_backward_is_one_more_scan(monkeypatch):
    """The backward is one more scan, reversed in time: on the CPU a
    forward and backward through the wrapper call the forward scan once and
    the plain backward (``rglru_bwd_ref``, whose reversed scan is that one
    more scan) once, and nothing else."""
    la, bx, h0, g_h, g_last = _grad_inputs(-1.0, seed=2, s=20, c=8)
    calls = []
    real_scan, real_bwd = ops._scan, ops.rglru_bwd_ref

    def counting_scan(*args):
        calls.append(("scan", args[0].shape))
        return real_scan(*args)

    def counting_bwd(*args):
        calls.append(("bwd", args[0].shape))
        return real_bwd(*args)

    monkeypatch.setattr(ops, "_scan", counting_scan)
    monkeypatch.setattr(ops, "rglru_bwd_ref", counting_bwd)
    _torch_grads(ops.rglru_scan, la, bx, h0, g_h, g_last)
    assert calls == [("scan", (2, 20, 8)), ("bwd", (2, 20, 8))]


@pytest.mark.parametrize("log_a", [-5.25, -1e-6])
@pytest.mark.parametrize("with_h0", [False, True])
def test_bwd_ref_matches_jax_grad(log_a, with_h0):
    """``rglru_bwd_ref`` alone (the backward kernel's yardstick on the card),
    fed the plain forward's h, against jax.grad of the model's
    ``layers._rglru_scan``: ∂log_a, ∂b and ∂h0, at the model's decays and
    at the slowest the clip allows. 1e-5 relative plus 1e-5 of the largest
    value, as the gradient cases above."""
    la, bx, h0, g_h, g_last = _grad_inputs(log_a, seed=int(-log_a * 5) + 9)
    h0 = h0 if with_h0 else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    h, _ = rglru_ref(t(la), t(bx), t(h0))
    d_la, d_bx, d_h0 = rglru_bwd_ref(t(la), h, t(h0), t(g_h), t(g_last))
    got = [d_la.numpy(), d_bx.numpy()] + ([d_h0.numpy()] if with_h0 else [])
    want = _jax_scan_grads(la, bx, h0, g_h, g_last)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("with_h0", [False, True])
def test_cpu_backward_goes_through_bwd_ref(with_h0):
    """On the CPU the wrapper's backward is ``rglru_bwd_ref`` itself: no
    launch is counted, its gradients are bitwise the plain backward's, and
    an unused h_final (its cotangent None, not materialised) gives the same
    gradients as a zero cotangent."""
    la, bx, h0, g_h, _ = _grad_inputs(-1.0, seed=4, s=33, c=12)
    h0 = h0 if with_h0 else None
    before = (ops.launch_count, ops.bwd_launch_count)
    ts = [torch.from_numpy(a).requires_grad_() for a in (la, bx)]
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    h, _ = ops.rglru_scan(*ts, th0)  # h_final unused: g_last is None
    (h * torch.from_numpy(g_h)).sum().backward()
    assert (ops.launch_count, ops.bwd_launch_count) == before
    got = [a.grad for a in ts + ([] if th0 is None else [th0])]
    t = lambda a: None if a is None else torch.from_numpy(a)
    hp, _ = rglru_ref(t(la), t(bx), t(h0))
    zero = torch.zeros(la.shape[0], la.shape[2])
    want = rglru_bwd_ref(t(la), hp, t(h0), t(g_h), zero)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    nothing = rglru_bwd_ref(t(la), hp, t(h0), t(g_h), None)
    assert all(torch.equal(a, w) for a, w in zip(nothing, want))
    d_la, d_bx, d_h0 = ops.rglru_scan_backward(
        t(la), hp, t(h0), t(g_h), None, needs=(False, True, True))
    assert d_la is None and torch.equal(d_bx, want[1])
    assert (d_h0 is None) == (h0 is None)
