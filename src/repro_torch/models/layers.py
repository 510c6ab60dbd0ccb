"""Model layers of the LM serving path, single device.

The port's counterpart of :mod:`repro.models.layers`, with only what the
recurrentgemma serving path runs: norms, RoPE, the chunked (online-softmax)
prefill attention, the head-parallel ("TP mode") attention and MLP, the
RG-LRU mixer and the embedding. Each function keeps the reference's name;
``w`` is the layer's :class:`~repro_torch.models.params.Params` module where
the reference takes a weight dict. On one device every gather and psum of
the reference is the identity and is left out.

Weights are cast to the compute ``dtype`` where the reference's
``gather_param`` casts them (a no-op when the model is stored in ``dtype``).
The RG-LRU scan goes through :mod:`repro_torch.kernels.rglru_scan`, a CUDA
kernel on the card; the reference's model path uses ``lax.associative_scan``
for the same recurrence.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Params, WDef

_NEG = -1e30
_I32_MAX = 2**31 - 1


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation (layers.py:303, :756).
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_defs(d: int) -> dict[str, WDef]:
    return {"scale": WDef((d,), init="ones")}


def apply_norm(x, w: Params, dtype):
    """RMSNorm in float32 (the only norm of the archs the port runs; the
    reference's bias-free layernorm branch waits with the SP configs)."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (xf * w.scale.to(dtype).float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions: (S,) absolute (half-split
    rotation, as the reference)."""
    d = x.shape[-1]
    ar = torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -ar / d)
    angles = positions.float()[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (online-softmax) attention — the prefill attention
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, q_pos, k_pos, causal: bool = True,
                      window: int | None = None, chunk: int = 1024):
    """Memory-efficient attention: a loop over KV chunks with online
    max/denominator accumulators, GQA by head grouping, in float32.

    q: (B, Sq, H, D); k, v: (B, Sk, Hk, D); q_pos (Sq,), k_pos (Sk,)
    absolute positions. O(Sq·chunk) live scores instead of O(Sq·Sk). Not a
    kernel in the reference either: plain tensor code."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, sq, hk, g, d)

    chunk = min(chunk, sk)
    n_chunks = (sk + chunk - 1) // chunk
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_I32_MAX)

    m = torch.full((b, hk, g, sq), _NEG, device=q.device)
    l = torch.zeros((b, hk, g, sq), device=q.device)
    acc = torch.zeros((b, hk, g, sq, d), device=q.device)
    for c in range(n_chunks):
        kci = k[:, c * chunk:(c + 1) * chunk].float()
        vci = v[:, c * chunk:(c + 1) * chunk].float()
        pci = k_pos[c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, kci)
        mask = pci[None, :] < _I32_MAX  # padding
        if causal:
            mask = mask & (pci[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (pci[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqc,bchd->bhgqd", p, vci)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention sublayer — TP mode (recurrentgemma local attention)
# ---------------------------------------------------------------------------


def attn_tp_defs(cfg: ModelConfig) -> dict[str, WDef]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": WDef((d, qd)), "wk": WDef((d, kvd)), "wv": WDef((d, kvd)),
            "wo": WDef((qd, d))}


def attn_tp(x, w: Params, cfg: ModelConfig, *, causal: bool = True,
            window: int | None = None, return_kv: bool = False):
    """Head-parallel attention (on one device: all heads). x: (B, S, d).
    With ``return_kv`` also returns the roped (k, v) for the decode cache."""
    dtype = x.dtype
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ w.wq.to(dtype)).reshape(b, s, cfg.n_heads, hd)
    k = (x @ w.wk.to(dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ w.wv.to(dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    out = chunked_attention(q, k, v, pos, pos, causal=causal, window=window)
    y = out.reshape(b, s, cfg.q_dim) @ w.wo.to(dtype)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# MLP — TP variant, gelu branch (the swiglu branch waits with the SP configs)
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig) -> dict[str, WDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": WDef((d, ff)), "w2": WDef((ff, d))}


def mlp_tp(x, w: Params):
    dtype = x.dtype
    return _gelu(x @ w.w1.to(dtype)) @ w.w2.to(dtype)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin) recurrence block
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_defs(cfg: ModelConfig) -> dict[str, WDef]:
    d, r = cfg.d_model, cfg.rnn_dim
    return {
        "wx": WDef((d, r)),
        "wgate": WDef((d, r)),  # gelu branch
        "wa": WDef((d, r)),  # recurrence gate a_t
        "wi": WDef((d, r)),  # input gate i_t
        "conv": WDef((4, r), init="scaled", init_scale=0.5),
        "lam": WDef((r,), init="ones"),  # Λ (softplus-parameterized)
        "wo": WDef((r, d)),
    }


def _depthwise_conv(x, kern):
    """Causal depthwise conv, width K. x: (B, S, C), kern: (K, C). The taps
    are summed in order 0..K-1, as the reference's ``sum`` does."""
    k = kern.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * kern[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * kern[i]
    return out


def rglru_gates(x_a, x_i, lam):
    """(log_a, a·h scale, input gate) from the gate pre-activations; log_a
    is clipped to [-60, -1e-6] before the scan, as in the reference."""
    a_gate = torch.sigmoid(x_a.float())
    i_gate = torch.sigmoid(x_i.float())
    log_a = torch.clamp(-_RGLRU_C * F.softplus(lam.float()) * a_gate,
                        -60.0, -1e-6)
    beta = torch.sqrt(1.0 - torch.exp(2.0 * log_a))
    return log_a, beta, i_gate


def rglru_mix(x, w: Params, cfg: ModelConfig, return_state: bool = False):
    """RG-LRU mixer over the whole sequence. x: (B, S, d). With
    ``return_state`` also returns (final h (B, r) f32, last 3 pre-conv
    inputs (B, 3, r) f32), the decode cache."""
    dtype = x.dtype
    bx_pre = x @ w.wx.to(dtype)
    bx = _depthwise_conv(bx_pre, w.conv.to(dtype))
    log_a, beta, i_gate = rglru_gates(x @ w.wa.to(dtype), x @ w.wi.to(dtype),
                                      w.lam)
    bterm = beta * (i_gate * bx.float())
    h32, h_last = rglru_ops.rglru_scan(log_a, bterm)
    gate = _gelu(x @ w.wgate.to(dtype))
    y = (h32.to(dtype) * gate) @ w.wo.to(dtype)
    if return_state:
        # a copy, so the decode cache holds no view of the whole sequence
        return y, (h_last, bx_pre[:, -3:].to(torch.float32, copy=True))
    return y


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict[str, WDef]:
    vp, d = cfg.padded_vocab(), cfg.d_model
    return {"table": WDef((vp, d), init_scale=1.0), "head": WDef((d, vp))}


def embed_tokens(ids, w: Params, dtype):
    """ids: (B, S) → (B, S, d). Rows are gathered, then cast (the reference
    casts the table first; the values are the same)."""
    return w.table[ids].to(dtype)
