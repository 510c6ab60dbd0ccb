"""Model layers of the LM serving and training paths, single device.

The port's counterpart of :mod:`repro.models.layers`, with what every
family's path runs (recurrentgemma, rwkv6, the dense decoders, mixtral and
arctic, whisper, llava): norms (RMSNorm and the bias-free layernorm), RoPE,
the chunked (online-softmax) prefill attention, one attention sublayer
(with its optional QKV bias, or as a cross-attention) and one MLP (gelu or
swiglu) for both the sequence-parallel ("SP mode") and head-parallel ("TP
mode") stacks, the capacity-dispatched MoE, the RG-LRU mixer, the RWKV6
time and channel mixes and the embedding. Each function keeps the reference's name;
``w`` is the layer's :class:`~repro_torch.models.params.Params` module
where the reference takes a weight dict. On one device every gather, psum
and reduce-scatter of the reference is the identity and is left out, so SP
attention is the plain computation over the whole sequence.

Weights are cast to the compute ``dtype`` where the reference's
``gather_param`` casts them (a no-op when the model is stored in ``dtype``).
The RG-LRU scan goes through :mod:`repro_torch.kernels.rglru_scan`, a CUDA
kernel on the card; the reference's model path uses ``lax.associative_scan``
for the same recurrence. The RWKV6 WKV goes through
:mod:`repro_torch.kernels.rwkv6_scan`, a CUDA kernel on the card; the
reference's model path runs the same chunked closed form (``_wkv_chunk``)
under ``lax.scan``. The cross-entropy's logsumexp and target logit go
through :mod:`repro_torch.kernels.fused_ce`, a CUDA kernel on the card, in
both modes (``ce_loss_tp``, ``ce_loss_sp``); the reference's model path
computes them in jnp over token chunks.
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


def apply_norm(x, w: Params, dtype, kind: str = "rmsnorm"):
    """RMSNorm, or the bias-free layernorm (``kind="layernorm"``:
    stablelm), in float32, times the scale cast to ``dtype``."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mu).mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + 1e-6)
    else:
        raise ValueError(f"unknown norm {kind!r}")
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
# Attention sublayer — SP mode (the dense decoders) and TP mode
# (recurrentgemma local attention): one body on one device
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig, cross: bool = False) -> dict[str, WDef]:
    """Q, K, V and output projections, and with ``cfg.qkv_bias`` (qwen)
    zero-initialised Q, K and V biases; a cross-attention (``cross``,
    whisper's decoder) has none."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    defs = {"wq": WDef((d, qd)), "wk": WDef((d, kvd)), "wv": WDef((d, kvd)),
            "wo": WDef((qd, d))}
    if cfg.qkv_bias and not cross:
        defs.update(bq=WDef((qd,), init="zeros"), bk=WDef((kvd,), init="zeros"),
                    bv=WDef((kvd,), init="zeros"))
    return defs


def qkv_proj(x, w: Params, name: str):
    """``x @ w{name}`` (+ ``b{name}`` where the layer has biases), both in
    x's dtype, as the reference's ``proj``."""
    dtype = x.dtype
    y = x @ getattr(w, "w" + name).to(dtype)
    if "b" + name in w.defs:
        y = y + getattr(w, "b" + name).to(dtype)
    return y


def attn_tp(x, w: Params, cfg: ModelConfig, *, causal: bool = True,
            window: int | None = None, chunk: int = 1024,
            return_kv: bool = False, kv_source=None, use_rope: bool = True):
    """All heads over the whole sequence (on one device the reference's
    head split, or its K/V gather in SP mode, is the identity): GQA, the
    QKV bias where the layer has one, RoPE at absolute positions, KV chunks
    of ``chunk`` (the reference's TP mode takes 1,024, its SP mode 512).
    x: (B, S, d). ``kv_source`` (B, S_kv, d) is a cross-attention's key and
    value input (whisper's encoder output; with ``causal=False`` and
    ``use_rope=False``). With ``return_kv`` also returns the (roped) (k, v)
    for the decode cache."""
    dtype = x.dtype
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kv_in = x if kv_source is None else kv_source
    s_kv = kv_in.shape[1]
    q = qkv_proj(x, w, "q").reshape(b, s, cfg.n_heads, hd)
    k = qkv_proj(kv_in, w, "k").reshape(b, s_kv, cfg.n_kv_heads, hd)
    v = qkv_proj(kv_in, w, "v").reshape(b, s_kv, cfg.n_kv_heads, hd)
    q_pos = torch.arange(s, dtype=torch.int32, device=x.device)
    k_pos = torch.arange(s_kv, dtype=torch.int32, device=x.device)
    if use_rope:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, k_pos, cfg.rope_theta)
    out = chunked_attention(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, chunk=chunk)
    y = out.reshape(b, s, cfg.q_dim) @ w.wo.to(dtype)
    if return_kv:
        return y, (k, v)
    return y


attn_sp = functools.partial(attn_tp, chunk=512)  # the reference's SP name


# ---------------------------------------------------------------------------
# MLP — gelu or swiglu, either mode
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig) -> dict[str, WDef]:
    d, ff = cfg.d_model, cfg.d_ff
    defs = {"w1": WDef((d, ff)), "w2": WDef((ff, d))}
    if cfg.mlp == "swiglu":
        defs["w3"] = WDef((d, ff))
    return defs


def mlp_tp(x, w: Params, kind: str = "gelu"):
    """gelu(x·w1)·w2, or silu(x·w1)·(x·w3)·w2 (swiglu), in x's dtype: the
    MLP of either mode on one device (TP's psum, and SP's all-gather and
    reduce-scatter, are identities; SP's sequence chunks only bound the
    reference's transients, as rows are independent)."""
    dtype = x.dtype
    h = x @ w.w1.to(dtype)
    if kind == "swiglu":
        h = F.silu(h) * (x @ w.w3.to(dtype))
    else:
        h = _gelu(h)
    return h @ w.w2.to(dtype)


def mlp_sp(x, w: Params, cfg: ModelConfig):  # the reference's SP name
    return mlp_tp(x, w, cfg.mlp)


def _auto_chunk(b: int, s: int, d: int, budget: int = 1 << 27) -> int:
    """The reference's ``_auto_chunk`` on one device: the largest
    power-of-two halving of ``s`` (down to 16) whose (B, chunk, d) bf16
    tensor stays under ``budget`` bytes, halved again until it divides
    ``s``. The reference's MoE sees one such sequence chunk a call, so its
    capacity, and which pairs it drops, depend on it."""
    chunk = s
    while chunk > 16 and b * chunk * d * 2 > budget:
        chunk //= 2
    while s % chunk:
        chunk //= 2
    return max(chunk, 1)


# ---------------------------------------------------------------------------
# MoE — capacity-based sort dispatch over every expert
# ---------------------------------------------------------------------------


def moe_defs(cfg: ModelConfig) -> dict[str, WDef | dict]:
    """The router (d, E), the experts' swiglu matrices w1, w3 (E, d, ff)
    and w2 (E, ff, d), and with ``dense_residual`` (arctic) a dense FFN
    ``dense`` beside them."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    defs = {"router": WDef((d, e)), "w1": WDef((e, d, ff)),
            "w2": WDef((e, ff, d)), "w3": WDef((e, d, ff))}
    if cfg.moe.dense_residual:
        defs["dense"] = mlp_defs(cfg)
    return defs


def moe_route(tokens, router, cfg: ModelConfig):
    """Top-k routing of (T, d) tokens and each (token, expert) pair's slot.

    The router product in the tokens' dtype, then float32 softmax, top-k
    and renormalised gates; the T·k pairs (token-major) sorted stably by
    expert, a pair's position within its expert found by a left
    ``searchsorted``, and the pairs past the capacity dropped (an
    expert's capacity: cf·k·T/E rounded down, then up to a multiple of 8,
    at least 8). Returns a dict of ``probs`` (T, E), ``gate``/``expert``
    (T, k), ``order`` (the stable sort's permutation), ``ok`` (kept, in
    sorted order), ``slot`` (E·cap for a dropped pair) and ``cap``. Shapes
    depend on T alone: no host read, so a decode step never waits on the
    card."""
    t = tokens.shape[0]
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = int(cfg.moe.capacity_factor * k * t / e)
    cap = max(8, ((cap + 7) // 8) * 8)
    logits = (tokens @ router.to(tokens.dtype)).float()
    probs = torch.softmax(logits, -1)
    gate, expert = torch.topk(probs, k)
    gate = gate / gate.sum(-1, keepdim=True)
    sorted_e, order = torch.sort(expert.reshape(-1), stable=True)
    pos = (torch.arange(t * k, device=tokens.device)
           - torch.searchsorted(sorted_e, sorted_e, side="left"))
    ok = pos < cap
    slot = torch.where(ok, sorted_e * cap + pos, e * cap)
    return {"probs": probs, "gate": gate, "expert": expert, "order": order,
            "ok": ok, "slot": slot, "cap": cap}


def moe_tokens(tokens, w: Params, cfg: ModelConfig):
    """The reference's ``_moe_tokens``: (T, d) tokens through their top-k
    experts at a fixed capacity. Returns (y (T, d), aux {lb_loss,
    drop_frac}).

    The kept pairs are scattered into an (E·cap + 1, d) buffer whose last
    row takes the dropped ones and is discarded; every expert runs its
    swiglu over all cap rows (batched products over the E experts, as the
    reference computes them, empty rows included); the outputs are
    gathered back to the pairs (zero for a dropped one), put back in
    token-major order and summed over k with the gates, in the tokens'
    dtype. ``lb_loss`` is the Switch balance term E·Σ_e f_e·p̄_e / k,
    ``drop_frac`` the share of pairs dropped."""
    dtype = tokens.dtype
    t, d = tokens.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    r = moe_route(tokens, w.router, cfg)
    cap, order, ok, slot = r["cap"], r["order"], r["ok"], r["slot"]
    buf = torch.zeros(e * cap + 1, d, dtype=dtype, device=tokens.device)
    buf.index_copy_(0, slot, tokens.index_select(0, order // k))
    buf = buf[:e * cap].view(e, cap, d)
    h = F.silu(torch.bmm(buf, w.w1.to(dtype))) * torch.bmm(buf,
                                                            w.w3.to(dtype))
    yb = torch.bmm(h, w.w2.to(dtype)).view(e * cap, d)
    y_sorted = torch.where(ok[:, None],
                           yb.index_select(0, slot.clamp(max=e * cap - 1)), 0)
    y_assign = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    y = (y_assign.view(t, k, d) * r["gate"][..., None].to(dtype)).sum(1)
    onehot = r["expert"][..., None] == torch.arange(e, device=tokens.device)
    frac_tokens = onehot.float().sum(1).mean(0)
    aux = {"lb_loss": e * (frac_tokens * r["probs"].mean(0)).sum() / k,
           "drop_frac": 1.0 - ok.float().mean()}
    return y, aux


def moe_sp(x, w: Params, cfg: ModelConfig, chunk: int | None = None):
    """The reference's SP-mode MoE on one device: (B, S, d) in sequence
    chunks of ``chunk`` (default :func:`_auto_chunk`'s), each chunk's B·chunk
    tokens one :func:`moe_tokens` call, plus the dense residual FFN
    (swiglu) where the layer has one. Returns (y, aux), aux the mean over
    chunks."""
    b, s, d = x.shape
    chunk = chunk or _auto_chunk(b, s, d)
    assert s <= chunk or s % chunk == 0, (s, chunk)
    dense = getattr(w, "dense", None)
    ys, auxes = [], []
    for c0 in range(0, s, chunk):
        xc = x[:, c0:c0 + chunk]
        y, aux = moe_tokens(xc.reshape(-1, d), w, cfg)
        y = y.view(xc.shape)
        if dense is not None:
            y = y + mlp_tp(xc, dense, "swiglu")
        ys.append(y)
        auxes.append(aux)
    if len(ys) == 1:
        return ys[0], auxes[0]
    return torch.cat(ys, 1), {n: torch.stack([a[n] for a in auxes]).mean()
                              for n in auxes[0]}


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
        m, state, sh_tm = rwkv_mix(apply_norm(xc, blk.ln1, dtype, cfg.norm),
                                   blk.mix, cfg, state, sh_tm)
        xc = xc + m
        cm, sh_cm = rwkv_channel_mix(apply_norm(xc, blk.ln2, dtype, cfg.norm),
                                     blk.mix, sh_cm)
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
    casts the table first; the values are the same). One lookup for both
    modes: on one device the reference's vocab-parallel psum (TP) and
    reduce-scatter into sequence parallelism (SP) are identities.
    ``F.embedding``, not ``table[ids]``: the indexing's backward accumulates
    a repeated id's rows in an order that changes from run to run on the
    CPU, the embedding's backward in a fixed one."""
    return F.embedding(ids, w.table).to(dtype)


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


# ---------------------------------------------------------------------------
# Cross-entropy — SP mode
# ---------------------------------------------------------------------------


def ce_loss_sp(x, labels, w: Params, cfg: ModelConfig):
    """SP-mode cross-entropy on one device (the reference's ``ce_loss_sp``
    with its model axis of 1): x (B, S, d) final-norm hidden, labels
    (B, S). Returns (Σ per-token NLL (float32 scalar), token count).

    The reference scans over sequence chunks of c = min(S, 256) tokens
    (its default chunk, ``fused_ce``'s ``BWD_CHUNK``), halved until c
    divides S, each chunk's (B, c) rows one
    checkpointed step. Here the hidden is laid out as (S/c, B, c, d), so
    that chunk j's rows are consecutive, and goes through one
    :func:`~repro_torch.kernels.fused_ce.ops.fused_ce` call whose backward
    takes B·c rows a chunk: the reference's chunks, in its order. In
    bfloat16 the logits are rounded to bfloat16 before the softmax, as in
    :func:`ce_loss_tp`."""
    b, s, d = x.shape
    c = min(s, ce_ops.BWD_CHUNK)
    while s % c:
        c //= 2
    n = s // c
    rows = x.reshape(b, n, c, d).transpose(0, 1).reshape(n * b * c, d)
    lab = labels.reshape(b, n, c).transpose(0, 1).reshape(n * b * c)
    nll = ce_ops.fused_ce(rows, w.head.to(x.dtype), lab,
                          round_logits=x.dtype == torch.bfloat16,
                          chunk=b * c)
    return nll.sum(), b * s
