"""Plain PyTorch WKV6: the chunked closed form and the sequential oracle.

:func:`wkv_chunk` is the model's closed form for one chunk, the counterpart
of ``repro.models.layers._wkv_chunk`` and the function ``csrc/rwkv6_scan.cu``
computes for each chunk. :func:`rwkv6_chunked_ref` chains it over the
chunks of a sequence from ``state0``: the CPU path runs it, and on the card
it is only the kernel's yardstick of correctness. :func:`rwkv6_seq_ref` is
the sequential recurrence (``repro.kernels.rwkv6_scan.ref.rwkv6_ref``), an
oracle for the tests.

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


def rwkv6_chunked_ref(r, k, v, logw, u, state0=None, chunk: int = 64):
    """r, k, v, logw (B, H, S, D); u (H, D); state0 (B, H, D, D) or None
    (zeros), all of one float dtype (float32 on the model path). Chunks of
    c = min(chunk, S) (S % c == 0). Returns (y (B, H, S, D), final state
    (B, H, D, D)) in that dtype."""
    b, h, s, d = r.shape
    c = min(chunk, s)
    state = (r.new_zeros(b, h, d, d) if state0 is None else state0)
    ys = []
    for i in range(0, s, c):
        sl = slice(i, i + c)
        y, state = wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                             logw[:, :, sl], u, state)
        ys.append(y)
    return torch.cat(ys, dim=2), state


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
