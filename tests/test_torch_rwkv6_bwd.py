"""Port parity: the plain WKV6 backward ``rwkv6_bwd_ref`` of
repro_torch.kernels.rwkv6_scan against the VJP that JAX derives from the
reference model's own chunk, ``repro.models.layers._wkv_chunk`` chained over
the chunks from ``state0`` (the function the reference trains rwkv6
through: its Pallas kernel has no backward), and against autograd through
the port's plain chunked WKV; the same backward split as the card splits
it (``rwkv6_bwd_split_ref``: the dS pass, the chunk pass fed its dS, du)
against both; and the CPU path of ``RWKV6Scan``. The CUDA backward kernels
are held against ``rwkv6_bwd_ref`` and their own plain pieces on the card
(``test_torch_cuda.py``).

Tolerance: every gradient within 1e-4 relative plus 1e-4 of its largest
value. The closed form scales by e^{±cumsum logw}, the two packages sum in
other orders, and dlogw is a reverse cumulative sum whose terms cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _wkv_chunk as jax_wkv_chunk
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_bwd_ref,
                                                 rwkv6_bwd_split_ref,
                                                 rwkv6_chunked_ref)

NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


def _inputs(b, h, s, d, seed, logw=None):
    """r, k, v, logw (B, H, S, D), u (H, D), state0 (B, H, D, D) and the
    cotangents dy (B, H, S, D), d_state (B, H, D, D), float32; logw
    uniform in [-1, -1e-6] (the model's clip) unless given."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    lw = (-rng.uniform(1e-6, 1.0, size=(b, h, s, d)).astype(np.float32)
          if logw is None else np.full((b, h, s, d), logw, np.float32))
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32)
    dy = rng.normal(size=(b, h, s, d)).astype(np.float32)
    ds = rng.normal(size=(b, h, d, d)).astype(np.float32)
    return r, k, v, lw, u, s0, dy, ds


def _jax_chain(r, k, v, lw, u, s0, c):
    """The reference model's WKV: ``_wkv_chunk`` over chunks of c."""
    ys, state = [], s0
    for i in range(0, r.shape[2], c):
        sl = slice(i, i + c)
        y, state = jax_wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 lw[:, :, sl], u, state)
        ys.append(y)
    return jnp.concatenate(ys, axis=2), state


def _plain_grads(r, k, v, lw, u, s0, dy, ds, c, with_s0=True, with_ds=True,
                 bwd=rwkv6_bwd_ref):
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u, s0, dy, ds)]
    _, _, states = rwkv6_chunked_ref(*t[:5], t[5] if with_s0 else None, c,
                                     return_states=True)
    return bwd(*t[:5], states, t[6], t[7] if with_ds else None, c)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("b,h,s,d,chunk,logw", [
    (2, 3, 64, 16, 16, None),  # four chunks, the state carried
    (2, 4, 192, 32, 64, None),  # the twin's heads, three 64-step chunks
    (1, 2, 1, 8, 64, None),  # a single step
    (2, 2, 40, 8, 64, None),  # c = min(64, 40): one ragged chunk
    (1, 2, 33, 5, 64, None),  # c = 33, D = 5
    (1, 2, 128, 16, 64, -1.0),  # the edge decay: e^{±64} in a chunk
])
def test_bwd_ref_matches_jax_vjp_of_wkv_chunk(b, h, s, d, chunk, logw):
    r, k, v, lw, u, s0, dy, ds = _inputs(b, h, s, d, seed=s * d + h,
                                         logw=logw)
    c = min(chunk, s)
    _, vjp = jax.vjp(lambda *a: _jax_chain(*a, c),
                     *(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = _plain_grads(r, k, v, lw, u, s0, dy, ds, c)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, name)


@pytest.mark.parametrize("b,h,s,d,chunk,with_s0,with_ds", [
    (2, 3, 96, 16, 32, True, True),
    (2, 2, 64, 8, 64, False, True),  # state0 None: zeros
    (1, 2, 48, 8, 16, True, False),  # d_state None: zeros
    (2, 2, 5, 4, 1, True, True),  # c = 1
])
def test_bwd_ref_matches_autograd_of_chunked_ref(b, h, s, d, chunk, with_s0,
                                                 with_ds):
    r, k, v, lw, u, s0, dy, ds = _inputs(b, h, s, d, seed=7 + s)
    c = min(chunk, s)
    ins = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, lw, u)]
    if with_s0:
        ins.append(torch.from_numpy(s0).requires_grad_())
    y, st = rwkv6_chunked_ref(*ins[:5], ins[5] if with_s0 else None, c)
    out = (y * torch.from_numpy(dy)).sum()
    if with_ds:
        out = out + (st * torch.from_numpy(ds)).sum()
    want = torch.autograd.grad(out, ins)
    got = _plain_grads(r, k, v, lw, u, s0, dy, ds, c, with_s0, with_ds)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w.numpy(), name)


SPLIT_CASES = [
    (1, 2, 64, 40, 64, True, True),  # one chunk, D = 40 (not a multiple of 16)
    (2, 3, 192, 40, 64, False, True),  # three chunks, no state0
    (1, 2, 96, 16, 32, True, False),  # c = 32 < 64, no d_state
    (2, 2, 48, 40, 16, False, False),  # c = 16, D = 40, neither
    (1, 2, 33, 5, 64, True, True),  # c = 33, D = 5
    (2, 2, 5, 4, 1, True, True),  # c = 1
]


@pytest.mark.parametrize("b,h,s,d,chunk,with_s0,with_ds", SPLIT_CASES)
def test_bwd_split_ref_matches_bwd_ref(b, h, s, d, chunk, with_s0, with_ds):
    """The backward as the kernels split it (the dS pass alone, then every
    chunk at once from its dS, du) against the reverse walk."""
    args = _inputs(b, h, s, d, seed=100 + s + d)
    c = min(chunk, s)
    got = _plain_grads(*args, c, with_s0, with_ds, bwd=rwkv6_bwd_split_ref)
    want = _plain_grads(*args, c, with_s0, with_ds)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("b,h,s,d,chunk,with_s0,with_ds", SPLIT_CASES)
def test_bwd_split_ref_matches_jax_vjp_of_wkv_chunk(b, h, s, d, chunk,
                                                    with_s0, with_ds):
    """The split backward against ``jax.vjp`` of the reference's
    ``_wkv_chunk`` chain; a missing state0 or d_state is zeros on both
    sides (dstate0 is then the gradient at a zero state)."""
    r, k, v, lw, u, s0, dy, ds = _inputs(b, h, s, d, seed=200 + s + d)
    s0 = s0 if with_s0 else np.zeros_like(s0)
    ds = ds if with_ds else np.zeros_like(ds)
    c = min(chunk, s)
    _, vjp = jax.vjp(lambda *a: _jax_chain(*a, c),
                     *(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = _plain_grads(r, k, v, lw, u, s0, dy, ds, c, with_s0, with_ds,
                       bwd=rwkv6_bwd_split_ref)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, name)


@pytest.mark.parametrize("use_final_state", [False, True])
def test_cpu_backward_goes_through_bwd_ref(monkeypatch, use_final_state):
    """On the CPU ``rwkv6_scan`` under autograd is ``RWKV6Scan``: its
    backward calls ``rwkv6_bwd_ref`` exactly once a call and counts no
    launch; its gradients are bitwise the plain backward's on the forward's
    states, and an unused final state (its cotangent None, not
    materialised) gives those of a zero cotangent."""
    r, k, v, lw, u, s0, dy, ds = _inputs(2, 3, 96, 8, seed=3)
    calls = []
    plain = ops.rwkv6_bwd_ref

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(ops, "rwkv6_bwd_ref", counted)
    before = (ops.launch_count, ops.bwd_launch_count)
    ins = [torch.from_numpy(a).requires_grad_()
           for a in (r, k, v, lw, u, s0)]
    y, st = ops.rwkv6_scan(*ins, chunk=32)
    out = (y * torch.from_numpy(dy)).sum()
    if use_final_state:
        out = out + (st * torch.from_numpy(ds)).sum()
    out.backward()
    assert len(calls) == 1
    assert (ops.launch_count, ops.bwd_launch_count) == before
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u, s0)]
    y0, st0, states = rwkv6_chunked_ref(*t, 32, return_states=True)
    assert torch.equal(y.detach(), y0) and torch.equal(st.detach(), st0)
    d_state = (torch.from_numpy(ds) if use_final_state
               else torch.zeros_like(t[5]))
    want = plain(*t[:5], states, torch.from_numpy(dy), d_state, 32)
    for a, w, name in zip(ins, want, NAMES):
        assert torch.equal(a.grad, w), name
    if not use_final_state:
        nothing = plain(*t[:5], states, torch.from_numpy(dy), None, 32)
        assert all(torch.equal(a, w) for a, w in zip(nothing, want))


def test_no_graph_takes_the_serving_path():
    """Without a gradient to track, a call is the plain forward itself (the
    serving path's call on the card: one forward launch, no saved
    states)."""
    r, k, v, lw, u, s0, _, _ = _inputs(1, 2, 16, 4, seed=5)
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u, s0)]
    with torch.no_grad():
        got = ops.rwkv6_scan(*[a.requires_grad_() for a in t])
    want = rwkv6_chunked_ref(*[a.detach() for a in t])
    assert all(g.grad_fn is None and torch.equal(g, w)
               for g, w in zip(got, want))
