"""Model layers of the LM serving and training paths, single device.

The port's counterpart of :mod:`repro.models.layers`, with only what the
recurrentgemma and rwkv6 paths run: norms, RoPE, the chunked
(online-softmax) prefill attention, the head-parallel ("TP mode") attention
and MLP, the RG-LRU mixer, the RWKV6 time and channel mixes and the
embedding. Each function keeps the reference's name; ``w`` is the layer's
:class:`~repro_torch.models.params.Params` module where the reference takes
a weight dict. On one device every gather and psum of the reference is the
identity and is left out.

Weights are cast to the compute ``dtype`` where the reference's
``gather_param`` casts them (a no-op when the model is stored in ``dtype``).
The RG-LRU scan goes through :mod:`repro_torch.kernels.rglru_scan`, a CUDA
kernel on the card; the reference's model path uses ``lax.associative_scan``
for the same recurrence. The RWKV6 WKV goes through
:mod:`repro_torch.kernels.rwkv6_scan`, a CUDA kernel on the card; the
reference's model path runs the same chunked closed form (``_wkv_chunk``)
under ``lax.scan``. The cross-entropy's logsumexp and target logit go
through :mod:`repro_torch.kernels.fused_ce`, a CUDA kernel on the card; the
reference's model path computes them in jnp over 256-token chunks.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Params, WDef

_NEG = -1e30
_I32_MAX = 2**31 - 1


@functools.cache
def _gelu_consts(dtype):
    """The reference's constants 0.044715 and √(2/π), rounded to ``dtype``
    as ``jax.nn.gelu`` rounds them."""
    return (float(torch.tensor(0.044715, dtype=dtype)),
            float(torch.tensor(math.sqrt(2 / math.pi), dtype=dtype)))


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu`` (the tanh approximation, layers.py:303, :756) as the
    reference writes it: one op at a time in the input's dtype, so in
    bfloat16 every intermediate is rounded to bfloat16 where the
    reference's is. ``F.gelu`` keeps them in float32 and rounds once, which
    moves about 40% of the bf16 outputs by an ulp. The backward is the
    reference's VJP of the same ops, in the same order and dtype."""

    @staticmethod
    def forward(ctx, x):
        c1, c2 = _gelu_consts(x.dtype)
        t = torch.tanh(c2 * (x + c1 * (x * x * x)))
        ctx.save_for_backward(x, t)
        return x * (0.5 * (1.0 + t))

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        c1, c2 = _gelu_consts(x.dtype)
        p = (0.5 * (x * g)) * (1.0 - t)
        s = c2 * (p + p * t)
        return (g * (0.5 * (1.0 + t)) + s) + (c1 * s) * (3.0 * (x * x))


def _gelu(x):
    return _Gelu.apply(x)


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
    # torch.full, not torch.tensor: a host scalar copied to the card makes
    # the host wait for the device (a decode step calls this twice a layer)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
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
# RWKV6 time mix (chunked WKV) + channel mix — TP mode
# ---------------------------------------------------------------------------

_RWKV_LORA = 32
_WKV_CHUNK = 64  # WKV closed-form chunk: e^{±64} stays inside float32
RWKV_TIME_CHUNK = 512  # time chunk of a whole RWKV block (the reference's)


def rwkv_defs(cfg: ModelConfig) -> dict[str, WDef]:
    """The reference's ``rwkv_defs``: time mix, decay LoRA, bonus, group
    norm and the channel mix (``cm_*``) of one RWKV block. The token-shift
    mixes ``mu``, the LoRA's ``wb`` and the bonus ``u`` start at zero."""
    d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff
    return {
        "mu": WDef((5, d), init="zeros"),  # r, k, v, g, w token shifts
        "wr": WDef((d, d)),
        "wk": WDef((d, d)),
        "wv": WDef((d, d)),
        "wg": WDef((d, d)),
        # decay base: exp(w0) ≈ 0.05 per step (see the clip in rwkv_mix)
        "w0": WDef((d,), init="const", init_scale=-3.0),
        "wa": WDef((d, _RWKV_LORA)),  # decay LoRA
        "wb": WDef((_RWKV_LORA, d), init="zeros"),
        "u": WDef((h, hd), init="zeros"),  # per-head bonus
        "ln_x": WDef((d,), init="ones"),  # per-head group norm
        "wo": WDef((d, d)),
        "cm_r": WDef((d, d)),
        "cm_k": WDef((d, ff)),
        "cm_v": WDef((ff, d)),
    }


def _shifted(x, shift0):
    """x_{t-1} along the sequence: ``shift0`` (B, d) float32 (the previous
    time chunk's last input) before the first step."""
    first = shift0[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_log_decay(w0, lora):
    """Per-step log decay clip(-exp(clip(w0 + lora, -8, 8)), -1, -1e-6) in
    float32: >= -1 keeps e^{±64} (a 64-step chunk) inside float32."""
    logw = -torch.exp(torch.clamp(w0.float() + lora.float(), -8.0, 8.0))
    return torch.clamp(logw, -1.0, -1e-6)


def rwkv_group_norm(y, ln_x, h: int, hd: int):
    """Per-head RMS norm (eps 1e-6) times ``ln_x``, float32. y: (..., H, D)."""
    ln = ln_x.float().reshape(h, hd)
    return y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6) * ln


def rwkv_mix(x, w: Params, cfg: ModelConfig, state0, shift0):
    """RWKV6 time mix over one time chunk (prefill). x: (B, s, d) normed
    input; ``state0`` (B, H, D, D) and ``shift0`` (B, d) float32 continue
    the recurrence from the previous time chunk. Returns (out (B, s, d),
    final WKV state, last input (B, d) float32 for the next shift).

    The mixes are formed in the compute dtype; r, k, v and the log decay
    go to the WKV kernel in float32 with WKV chunks of min(64, s)."""
    dtype = x.dtype
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    mu = w.mu.to(dtype)
    xprev = _shifted(x, shift0)
    mix = lambda i: x + mu[i] * (xprev - x)
    r = mix(0) @ w.wr.to(dtype)
    k = mix(1) @ w.wk.to(dtype)
    v = mix(2) @ w.wv.to(dtype)
    g = mix(3) @ w.wg.to(dtype)
    lora = torch.tanh(mix(4) @ w.wa.to(dtype)) @ w.wb.to(dtype)
    logw = rwkv_log_decay(w.w0, lora)

    def heads(t):  # (B, s, d) → (B, H, s, D) float32
        return t.reshape(b, s, h, hd).transpose(1, 2).float().contiguous()

    y, state = rwkv_ops.rwkv6_scan(heads(r), heads(k), heads(v), heads(logw),
                                   w.u.float().contiguous(), state0,
                                   chunk=_WKV_CHUNK)
    # each WKV chunk's y passes through the compute dtype, as the
    # reference's scan stacks it (repro/models/layers.py:582)
    y = y.to(dtype).float().transpose(1, 2)  # (B, s, H, D)
    yn = rwkv_group_norm(y, w.ln_x, h, hd).reshape(b, s, d).to(dtype)
    out = (yn * F.silu(g)) @ w.wo.to(dtype)
    return out, state, x[:, -1].float()


def rwkv_channel_mix(x, w: Params, shift0):
    """sigmoid(xk·cm_r) · (relu(xk·cm_k)²·cm_v) with xk = ½(x + x_prev).
    Returns (out, last input (B, d) float32 for the next shift)."""
    dtype = x.dtype
    xk = 0.5 * (x + _shifted(x, shift0))
    r = torch.sigmoid(xk @ w.cm_r.to(dtype))
    hh = torch.square(torch.relu(xk @ w.cm_k.to(dtype)))
    return r * (hh @ w.cm_v.to(dtype)), x[:, -1].float()


def rwkv_block_chunked(x, blk, cfg: ModelConfig, capture: bool = False):
    """A whole RWKV block (norm → time mix → norm → channel mix) over time
    chunks of ``min(512, S)`` steps, halved until they divide S, with the
    WKV state and both token shifts carried from chunk to chunk (the
    reference's rule, which bounds the live activations to one chunk).
    Returns (x, cache): with ``capture`` the decode cache {state, shift_tm,
    shift_cm}, else {}."""
    dtype = x.dtype
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    chunk = min(RWKV_TIME_CHUNK, s)
    while s % chunk:
        chunk //= 2
    state = torch.zeros(b, h, hd, hd, dtype=torch.float32, device=x.device)
    sh_tm = torch.zeros(b, d, dtype=torch.float32, device=x.device)
    sh_cm = torch.zeros(b, d, dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, s, chunk):
        xc = x[:, t0:t0 + chunk]
        m, state, sh_tm = rwkv_mix(apply_norm(xc, blk.ln1, dtype), blk.mix,
                                   cfg, state, sh_tm)
        xc = xc + m
        cm, sh_cm = rwkv_channel_mix(apply_norm(xc, blk.ln2, dtype), blk.mix,
                                     sh_cm)
        ys.append(xc + cm)
    y = torch.cat(ys, dim=1)
    if capture:
        return y, {"state": state, "shift_tm": sh_tm, "shift_cm": sh_cm}
    return y, {}


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


# ---------------------------------------------------------------------------
# Cross-entropy — TP mode
# ---------------------------------------------------------------------------


def ce_loss_tp(x, labels, w: Params, cfg: ModelConfig):
    """TP-mode cross-entropy: x (B, S, d) final-norm hidden, labels (B, S).
    Returns (Σ per-token NLL (float32 scalar), token count), the
    reference's pair. One :func:`~repro_torch.kernels.fused_ce.ops.fused_ce`
    call over the flattened (B·S, d) hidden against the head cast to the
    compute dtype; its backward takes the reference's 256-token chunks. In
    bfloat16 the logits are rounded to bfloat16 before the softmax, as the
    reference's ``(xi @ head).astype(float32)`` of a bf16 dot does."""
    b, s, d = x.shape
    head = w.head.to(x.dtype)
    nll = ce_ops.fused_ce(x.reshape(b * s, d), head, labels.reshape(b * s),
                          round_logits=x.dtype == torch.bfloat16)
    return nll.sum(), b * s
