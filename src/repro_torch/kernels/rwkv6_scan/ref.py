"""Plain PyTorch WKV6: the chunked closed form and the sequential oracle.

:func:`wkv_chunk` is the model's closed form for one chunk, the counterpart
of ``repro.models.layers._wkv_chunk`` and the function ``csrc/rwkv6_scan.cu``
computes for each chunk. :func:`rwkv6_chunked_ref` chains it over the
chunks of a sequence from ``state0``: the CPU path runs it, and on the card
it is only the kernel's yardstick of correctness. :func:`rwkv6_bwd_ref` is
its backward, a reverse walk over :func:`wkv_chunk_bwd`; the card computes
it in two kernels, whose plain versions are :func:`rwkv6_bwd_ds_ref` (the
dS pass), :func:`rwkv6_bwd_chunks_ref` (the chunk pass) and
:func:`rwkv6_bwd_du_ref`, composed by :func:`rwkv6_bwd_split_ref`.
:func:`rwkv6_seq_ref` is the sequential recurrence
(``repro.kernels.rwkv6_scan.ref.rwkv6_ref``), an oracle for the tests.

Layout (B, H, S, D) float32 for r, k, v and the per-step log decay ``logw``
(in [-1, 0), as the model clips it: e^{±c·|logw|} stays inside float32 for
c <= 64); the bonus ``u`` is (H, D); the state is (B, H, D, D), key × value.
"""

from __future__ import annotations

import torch


def wkv_chunk(r, k, v, logw, u, state):
    """One chunk: r, k, v, logw (B, H, c, D); u (H, D); state (B, H, D, D).
    Returns (y (B, H, c, D), new state)::

        y  = tril_strict(rq·kkᵀ)·v + rq·S₀ + diag(r·u·k)·v
        S' = diag(P_c)·S₀ + (k·P_c/P_j)ᵀ·v

    with P = exp(cumsum logw) inclusive, rq = r·P_{i-1}, kk = k/P_j.
    """
    c = r.shape[2]
    logp = torch.cumsum(logw, dim=2)  # inclusive: decay through step i
    logp_excl = logp - logw  # exclusive: through i - 1
    rq = r * torch.exp(logp_excl)
    kk = k * torch.exp(-logp)
    a = torch.einsum("bhid,bhjd->bhij", rq, kk)  # Σ_d r_i P_{i-1}/P_j k_j
    mask = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    a = torch.where(mask, a, 0.0)  # strictly j < i
    y = torch.einsum("bhij,bhje->bhie", a, v)
    y = y + torch.einsum("bhid,bhde->bhie", rq, state)  # carry-in state
    diag = (r * u[None, :, None, :] * k).sum(-1)  # the bonus self term
    y = y + diag[..., None] * v
    p_end = torch.exp(logp[:, :, -1:, :])  # (B, H, 1, D)
    k2 = k * torch.exp(logp[:, :, -1:, :] - logp)  # k_j · P_c/P_j
    new_state = state * p_end[:, :, 0, :, None] + torch.einsum(
        "bhjd,bhje->bhde", k2, v)
    return y, new_state


def rwkv6_chunked_ref(r, k, v, logw, u, state0=None, chunk: int = 64,
                      return_states: bool = False):
    """r, k, v, logw (B, H, S, D); u (H, D); state0 (B, H, D, D) or None
    (zeros), all of one float dtype (float32 on the model path). Chunks of
    c = min(chunk, S) (S % c == 0). Returns (y (B, H, S, D), final state
    (B, H, D, D)) in that dtype; with ``return_states`` also the state
    entering each chunk, (B, H, S/c, D, D), which :func:`rwkv6_bwd_ref`
    takes."""
    b, h, s, d = r.shape
    c = min(chunk, s)
    state = (r.new_zeros(b, h, d, d) if state0 is None else state0)
    ys, states = [], []
    for i in range(0, s, c):
        sl = slice(i, i + c)
        states.append(state)
        y, state = wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                             logw[:, :, sl], u, state)
        ys.append(y)
    if return_states:
        return torch.cat(ys, dim=2), state, torch.stack(states, dim=2)
    return torch.cat(ys, dim=2), state


def wkv_chunk_bwd(r, k, v, logw, u, s0, ds, dy):
    """The backward of :func:`wkv_chunk` for one chunk, the function of
    ``rwkv6_scan_bwd_chunk_kernel``: r, k, v, logw, dy (..., c, D); s0, the
    state entering the chunk, and ds, the cotangent of the state leaving
    it, (..., D, D); u broadcastable to (..., 1, D). Returns (dr, dk, dv,
    dlogw, ds0), ds0 being the cotangent of s0. From :func:`wkv_chunk`'s
    definitions (logp the inclusive cumsum, A = tril_strict(rq·kkᵀ),
    diag = Σ r·u·k, p_end = exp(logp_c))::

        dA   = tril_strict(dy·vᵀ)           ddiag = Σ_e dy·v
        dv   = Aᵀ·dy + diag·dy + k2·dS
        drq  = dA·kk + dy·S₀ᵀ               dkk = dAᵀ·rq
        dk2  = v·dSᵀ                        dp_end = Σ_e S₀ ⊙ dS
        dr   = drq·e^{logp−logw} + ddiag·u·k
        dk   = dkk·e^{−logp} + dk2·e^{logp_c−logp} + ddiag·u·r
        G    = drq·rq − dkk·kk − dk2·k2, and at the last row also
               Σ_j dk2·k2 + dp_end·p_end    (∂/∂logp)
        dlogw = revcumsum(G) − drq·rq       (logp − logw is the exclusive
                                             decay)
        dS₀  = rqᵀ·dy + diag(p_end)·dS
    """
    c = r.shape[-2]
    mask = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    logp = torch.cumsum(logw, dim=-2)
    ex = torch.exp(logp - logw)
    rq = r * ex
    e_kk = torch.exp(-logp)
    kk = k * e_kk
    lpc = logp[..., -1:, :]
    p_end = torch.exp(lpc)  # (..., 1, D)
    e_k2 = torch.exp(lpc - logp)
    k2 = k * e_k2
    a = torch.where(mask, rq @ kk.transpose(-1, -2), 0.0)
    da = torch.where(mask, dy @ v.transpose(-1, -2), 0.0)
    diag = (r * u * k).sum(-1, keepdim=True)
    ddiag = (dy * v).sum(-1, keepdim=True)
    dpend = (s0 * ds).sum(-1).unsqueeze(-2)  # (..., 1, D)
    dv = a.transpose(-1, -2) @ dy + diag * dy + k2 @ ds
    drq = da @ kk + dy @ s0.transpose(-1, -2)
    dkk = da.transpose(-1, -2) @ rq
    dk2 = v @ ds.transpose(-1, -2)
    dr = drq * ex + ddiag * u * k
    dk = dkk * e_kk + dk2 * e_k2 + ddiag * u * r
    x = drq * rq
    g = x - dkk * kk - dk2 * k2
    extra = (dk2 * k2).sum(-2, keepdim=True) + dpend * p_end
    g = torch.cat([g[..., :-1, :], g[..., -1:, :] + extra], dim=-2)
    dlogw = torch.flip(torch.cumsum(torch.flip(g, [-2]), -2), [-2]) - x
    ds0 = rq.transpose(-1, -2) @ dy + p_end.transpose(-1, -2) * ds
    return dr, dk, dv, dlogw, ds0


def rwkv6_bwd_ref(r, k, v, logw, u, states, dy, d_state=None,
                  chunk: int = 64):
    """The backward of :func:`rwkv6_chunked_ref`: the cotangents ``dy``
    (B, H, S, D) of y and ``d_state`` (B, H, D, D) or None (zeros) of the
    final state, given the inputs and ``states``, the state entering each
    chunk (``return_states``). Returns (dr, dk, dv, dlogw, du (H, D),
    dstate0 (B, H, D, D)).

    It walks the chunks in reverse with dS, the cotangent of the state
    leaving the chunk (``d_state`` at the end), through
    :func:`wkv_chunk_bwd`, and du = Σ over batch rows and steps of
    ddiag·r·k (:func:`rwkv6_bwd_du_ref`). :func:`rwkv6_bwd_split_ref` is
    the same function split as the kernels split it."""
    b, h, s, d = r.shape
    c = min(chunk, s)
    ds = r.new_zeros(b, h, d, d) if d_state is None else d_state
    uu = u[None, :, None, :]
    grads = [torch.empty_like(r) for _ in range(4)]  # dr, dk, dv, dlogw
    for n in reversed(range(s // c)):
        sl = slice(n * c, (n + 1) * c)
        rc, kc, vc, wc, dyc = (t[:, :, sl] for t in (r, k, v, logw, dy))
        *vals, ds = wkv_chunk_bwd(rc, kc, vc, wc, uu, states[:, :, n], ds,
                                  dyc)
        for out, val in zip(grads, vals):
            out[:, :, sl] = val
    return (*grads, rwkv6_bwd_du_ref(r, k, v, dy), ds)


def rwkv6_bwd_ds_ref(r, logw, dy, d_state=None, chunk: int = 64):
    """The dS pass, the function of ``rwkv6_scan_bwd_ds_kernel``: the
    cotangent dS of the state leaving each chunk, (B, H, S/c, D, D)
    (``d_state`` or zeros for the last), and dstate0 (B, H, D, D), from the
    recurrence dS₀ = rqᵀ·dy + diag(p_end)·dS alone."""
    b, h, s, d = r.shape
    c = min(chunk, s)
    n = s // c
    rc, wc, dyc = (t.reshape(b, h, n, c, d) for t in (r, logw, dy))
    logp = torch.cumsum(wc, dim=3)
    rq = rc * torch.exp(logp - wc)
    p_end = torch.exp(logp[:, :, :, -1, :, None])  # (B, H, n, D, 1)
    inc = rq.transpose(-1, -2) @ dyc  # rqᵀ·dy per chunk
    ds = r.new_empty(b, h, n, d, d)
    cur = r.new_zeros(b, h, d, d) if d_state is None else d_state
    for i in reversed(range(n)):
        ds[:, :, i] = cur
        cur = inc[:, :, i] + p_end[:, :, i] * cur
    return ds, cur


def rwkv6_bwd_chunks_ref(r, k, v, logw, u, states, ds, dy, chunk: int = 64):
    """The chunk pass, the function of ``rwkv6_scan_bwd_chunk_kernel``:
    :func:`wkv_chunk_bwd` on every chunk at once, given ``states`` (the
    state entering each chunk) and ``ds`` (the cotangent of the state
    leaving it), both (B, H, S/c, D, D). Returns (dr, dk, dv, dlogw), each
    (B, H, S, D)."""
    b, h, s, d = r.shape
    c = min(chunk, s)
    rc, kc, vc, wc, dyc = (t.reshape(b, h, s // c, c, d)
                           for t in (r, k, v, logw, dy))
    out = wkv_chunk_bwd(rc, kc, vc, wc, u[None, :, None, None, :], states,
                        ds, dyc)
    return tuple(t.reshape(b, h, s, d) for t in out[:4])


def rwkv6_bwd_du_ref(r, k, v, dy):
    """du (H, D): Σ over batch rows and steps of ddiag·r·k, ddiag = Σ_e
    dy·v (summed by ``rwkv6_scan_bwd_ds_kernel`` per batch row and by the
    chunk kernel over batch rows)."""
    ddiag = (dy * v).sum(-1, keepdim=True)
    return (ddiag * r * k).sum((0, 2))


def rwkv6_bwd_split_ref(r, k, v, logw, u, states, dy, d_state=None,
                        chunk: int = 64):
    """:func:`rwkv6_bwd_ref` as the kernels compute it: the dS pass, then
    the chunk pass fed its dS, and du. Same returns."""
    ds, dstate0 = rwkv6_bwd_ds_ref(r, logw, dy, d_state, chunk)
    grads = rwkv6_bwd_chunks_ref(r, k, v, logw, u, states, ds, dy, chunk)
    return (*grads, rwkv6_bwd_du_ref(r, k, v, dy), dstate0)


def rwkv6_seq_ref(r, k, v, logw, u, state0=None):
    """The sequential recurrence, step by step: y_t = r_t·S + (r_t·u·k_t)
    v_t, S ← diag(e^{logw_t})·S + k_tᵀv_t. Same layout and result as
    :func:`rwkv6_chunked_ref`."""
    b, h, s, d = r.shape
    state = r.new_zeros(b, h, d, d) if state0 is None else state0
    ys = torch.empty_like(r)
    for t in range(s):
        rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
        ys[:, :, t] = (torch.einsum("bhd,bhde->bhe", rt, state)
                       + (rt * u * kt).sum(-1, keepdim=True) * vt)
        state = (torch.exp(logw[:, :, t])[..., None] * state
                 + kt[..., :, None] * vt[..., None, :])
    return ys, state
