"""Serving: prefill + single-token greedy decode, single device.

The port's counterpart of :mod:`repro.models.serving` for every family:
the TP-mode block kinds (recurrentgemma's and rwkv6's) and the SP-mode
attention of the dense, MoE, encoder-decoder and VLM families:

  * Attention layers keep a ring KV cache of capacity W (the local or
    sliding window, or the whole context: a dense decoder's full causal
    ring). On one device the reference's sequence-sharded ring and its
    cross-shard softmax merge are the whole ring. A ``pos`` buffer holds the absolute
    position of each slot (-1 = empty): slot s holds position p ≡ s (mod W),
    so causal/window masking works under wraparound. Decode attends through
    :mod:`repro_torch.kernels.decode_attention` (a CUDA kernel on the card).
  * An encoder-decoder's (whisper's) layers also keep the cross-attention's
    K/V over the encoder's output (``ck``, ``cv``), written once by
    prefill; each decode step attends them through the same kernel, every
    encoder position valid (:data:`CROSS_T`, no window).
  * An MoE layer's decode step routes the batch's B tokens as one call of
    the capacity dispatch (:func:`~repro_torch.models.layers.moe_tokens`):
    fixed shapes, no host read.
  * RG-LRU layers keep the per-channel state (B, r) and the last three
    pre-conv inputs (B, 3, r), both float32.
  * RWKV6 layers keep the per-head WKV state (B, H, D, D) and the last
    normed inputs of the time mix and the channel mix (``shift_tm``,
    ``shift_cm``, (B, d)), all float32. Decode is plain tensor code, as in
    the reference: one step of the recurrence is an outer product.

The cache is ``{"t": int, "layers": [per-layer dict, ...]}`` in layer order;
``t`` is the absolute position of the next token, a host integer. Unlike the
reference, which returns new cache arrays, :func:`decode_step` writes the
ring slots and the recurrent state in place and returns the same dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, layer_kinds


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def attn_cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    if kind == "attn" and cfg.swa_window:
        return min(cfg.swa_window, seq_len)
    if kind == "attn" and cfg.local_attn_window:
        return min(cfg.local_attn_window, seq_len)
    return seq_len


def _slot_cache_shapes(cfg: ModelConfig, kind: str, b: int, seq_len: int,
                       kv_dtype=torch.bfloat16):
    hd = cfg.resolved_head_dim
    if kind == "attn":
        w = attn_cache_len(cfg, kind, seq_len)
        return {
            "k": ((b, w, cfg.n_kv_heads, hd), kv_dtype),
            "v": ((b, w, cfg.n_kv_heads, hd), kv_dtype),
            "pos": ((w,), torch.int32),
        }
    if kind == "rglru":
        r = cfg.rnn_dim
        return {"state": ((b, r), torch.float32),
                "conv": ((b, 3, r), torch.float32)}
    if kind == "rwkv":
        d = cfg.d_model
        return {"state": ((b, cfg.n_heads, hd, hd), torch.float32),
                "shift_tm": ((b, d), torch.float32),
                "shift_cm": ((b, d), torch.float32)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, b: int, seq_len: int,
               kv_dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero cache (pos = -1 ⇒ empty), one dict per layer; an
    encoder-decoder's layers also hold the cross-attention's K/V over the
    encoder's positions (``ck``, ``cv``: (B, S_enc, Hk, D)), which prefill
    computes once."""
    layers = []
    for kind in layer_kinds(cfg):
        shapes = _slot_cache_shapes(cfg, kind, b, seq_len, kv_dtype)
        if cfg.family == "encdec":
            cross = (b, cfg.encoder_seq, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            shapes.update(ck=(cross, kv_dtype), cv=(cross, kv_dtype))
        out = {}
        for name, (shape, dt) in shapes.items():
            fill = -1 if name == "pos" else 0
            out[name] = torch.full(shape, fill, dtype=dt, device=device)
        layers.append(out)
    return {"t": 0, "layers": layers}


# ---------------------------------------------------------------------------
# Decode-time sublayers
# ---------------------------------------------------------------------------


def _ring_write(buf, pos_buf, new, t: int, w_total: int):
    """Write ``new`` (B, 1, H, D) into the ring at absolute position t, in
    place: slot t mod W, and pos[slot] = t."""
    slot = t % w_total
    buf[:, slot] = new[:, 0].to(buf.dtype)
    pos_buf[slot].fill_(t)  # a kernel argument: no host-to-device copy


def _decode_attend(q, kbuf, vbuf, pos_buf, t: int, window):
    """Flash-decode of one token over the ring. q: (B, 1, H, D); kbuf/vbuf:
    (B, W, Hk, D); pos_buf: (W,). On one device the reference's
    cross-shard merge (pmax/psum of m, l, o) is the identity, so the
    normalised output of the kernel is the answer."""
    b, _, h, d = q.shape
    out, _, _ = attn_ops.decode_attention(
        q.float().reshape(b, h, d), kbuf, vbuf, pos_buf, t, window)
    return out.reshape(b, 1, h, d)


def _attn_decode(x, w, cache, cfg: ModelConfig, t: int, seq_len: int,
                 window):
    """x: (B, 1, d). GQA (Hk = ``cfg.n_kv_heads``) with the QKV bias where
    the layer has one. Returns y (B, 1, d); updates the ring in place."""
    dtype = x.dtype
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q = L.qkv_proj(x, w, "q").reshape(b, 1, cfg.n_heads, hd)
    k = L.qkv_proj(x, w, "k").reshape(b, 1, cfg.n_kv_heads, hd)
    v = L.qkv_proj(x, w, "v").reshape(b, 1, cfg.n_kv_heads, hd)
    pos = torch.full((1,), t, dtype=torch.int32, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    w_total = attn_cache_len(cfg, "attn", seq_len)
    _ring_write(cache["k"], cache["pos"], k, t, w_total)
    _ring_write(cache["v"], cache["pos"], v, t, w_total)
    out = _decode_attend(q, cache["k"], cache["v"], cache["pos"], t, window)
    out = out.to(dtype).reshape(b, 1, cfg.q_dim)
    return out @ w.wo.to(dtype)


# The query position a cross-attention's decode passes the kernel: past every
# encoder position, so the causal test keeps them all (the reference's).
CROSS_T = 10**9


def _cross_decode(x, w, cache, cfg: ModelConfig):
    """Whisper's cross-attention at decode: the token's query against the
    encoder's K/V that prefill stored (``ck``, ``cv``), at positions
    0..S_enc-1 with no window and no RoPE. x: (B, 1, d); returns y
    (B, 1, d)."""
    dtype = x.dtype
    b = x.shape[0]
    q = L.qkv_proj(x, w, "q").reshape(b, 1, cfg.n_heads,
                                      cfg.resolved_head_dim)
    ck, cv = cache["ck"], cache["cv"]
    pos = torch.arange(ck.shape[1], dtype=torch.int32, device=ck.device)
    out = _decode_attend(q, ck, cv, pos, CROSS_T, None)
    return out.to(dtype).reshape(b, 1, cfg.q_dim) @ w.wo.to(dtype)


def _moe_decode(h, w, cfg: ModelConfig):
    """The MoE of one decode step: the (B, d) tokens are one
    :func:`~repro_torch.models.layers.moe_tokens` call (T = B, so the
    capacity is the batch's), plus the dense residual FFN (swiglu) where
    the layer has one. h: (B, 1, d)."""
    b, _, d = h.shape
    y, _ = L.moe_tokens(h.reshape(b, d), w, cfg)
    y = y.reshape(b, 1, d)
    if hasattr(w, "dense"):
        y = y + L.mlp_tp(h, w.dense, "swiglu")
    return y


def _rglru_decode(x, w, cache, cfg: ModelConfig):
    """One RG-LRU step. x: (B, 1, d). Returns y (B, 1, d); updates the
    state and the conv history in place."""
    dtype = x.dtype
    xt = x[:, 0]
    bx = xt @ w.wx.to(dtype)  # (B, r)
    hist = cache["conv"]  # (B, 3, r) f32
    seq = torch.cat([hist, bx[:, None].float()], dim=1)  # (B, 4, r)
    bconv = torch.einsum("bkr,kr->br", seq, w.conv.to(dtype).float())
    log_a, beta, i_gate = L.rglru_gates(xt @ w.wa.to(dtype),
                                        xt @ w.wi.to(dtype), w.lam)
    h = torch.exp(log_a) * cache["state"] + beta * (i_gate * bconv)
    gate = L._gelu(xt @ w.wgate.to(dtype))
    y = ((h.to(dtype) * gate) @ w.wo.to(dtype))[:, None]
    cache["state"].copy_(h)
    cache["conv"].copy_(seq[:, 1:])
    return y


def _rwkv_decode(x, w, cache, cfg: ModelConfig):
    """One RWKV6 time-mix step. x: (B, 1, d) normed. The mixes are formed in
    float32 and cast to the compute dtype, as in the reference
    (repro/models/serving.py:342). Returns y
    (B, 1, d); updates the WKV state and ``shift_tm`` in place."""
    dtype = x.dtype
    b, _, d = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    xt = x[:, 0].float()
    mu = w.mu.float()
    xprev = cache["shift_tm"]
    mix = lambda i: (xt + mu[i] * (xprev - xt)).to(dtype)
    r = (mix(0) @ w.wr.to(dtype)).float().reshape(b, h, hd)
    k = (mix(1) @ w.wk.to(dtype)).float().reshape(b, h, hd)
    v = (mix(2) @ w.wv.to(dtype)).float().reshape(b, h, hd)
    gate = mix(3) @ w.wg.to(dtype)
    lora = torch.tanh(mix(4) @ w.wa.to(dtype)) @ w.wb.to(dtype)
    wdec = torch.exp(L.rwkv_log_decay(w.w0, lora)).reshape(b, h, hd)
    u = w.u.float()
    st = cache["state"]  # (B, H, D, D) f32, key × value
    y = (torch.einsum("bhd,bhde->bhe", r, st)
         + (r * u * k).sum(-1, keepdim=True) * v)
    st.mul_(wdec[..., None]).add_(k[..., :, None] * v[..., None, :])
    yn = L.rwkv_group_norm(y, w.ln_x, h, hd).reshape(b, 1, d).to(dtype)
    cache["shift_tm"].copy_(xt)
    return (yn * F.silu(gate[:, None])) @ w.wo.to(dtype)


def _rwkv_cm_decode(x, w, cache):
    """One channel-mix step; updates ``shift_cm`` in place."""
    dtype = x.dtype
    xt = x[:, 0].float()
    xk = (0.5 * (xt + cache["shift_cm"])).to(dtype)
    r = torch.sigmoid(xk @ w.cm_r.to(dtype))
    hh = torch.square(torch.relu(xk @ w.cm_k.to(dtype)))
    cache["shift_cm"].copy_(xt)
    return (r * (hh @ w.cm_v.to(dtype)))[:, None]


# ---------------------------------------------------------------------------
# Full decode step
# ---------------------------------------------------------------------------


def _decode_block(x, blk, cache, cfg: ModelConfig, t: int, seq_len: int):
    dtype = x.dtype
    h = L.apply_norm(x, blk.ln1, dtype, cfg.norm)
    if blk.kind == "rwkv":
        x = x + _rwkv_decode(h, blk.mix, cache, cfg)
        h = L.apply_norm(x, blk.ln2, dtype, cfg.norm)
        return x + _rwkv_cm_decode(h, blk.mix, cache)
    if blk.kind == "attn":
        win = cfg.swa_window or cfg.local_attn_window
        a = _attn_decode(h, blk.mix, cache, cfg, t, seq_len, win)
    elif blk.kind == "rglru":
        a = _rglru_decode(h, blk.mix, cache, cfg)
    else:
        raise ValueError(blk.kind)
    x = x + a
    if hasattr(blk, "cross"):
        h = L.apply_norm(x, blk.ln_cross, dtype, cfg.norm)
        x = x + _cross_decode(h, blk.cross, cache, cfg)
    h = L.apply_norm(x, blk.ln2, dtype, cfg.norm)
    if blk.kind == "attn" and cfg.moe is not None:
        return x + _moe_decode(h, blk.ffn, cfg)
    return x + L.mlp_tp(h, blk.ffn, cfg.mlp)  # one token: the MLP of either mode


def vocab_parallel_argmax(logits):
    """Greedy sampling: (B, 1, V) → (B, 1) int64, the first index on ties
    (as ``jnp.argmax``; on one device the vocab is not sharded)."""
    return torch.argmax(logits, dim=-1)


def decode_step(model: T.LM, cache: dict, token, seq_len: int,
                dtype=torch.bfloat16):
    """One serve step: token_t (B, 1) → (next_token (B, 1), logits (B, 1, V)
    f32, cache). ``cache['t']`` is the absolute position of ``token``; the
    cache is updated in place and ``t`` advanced."""
    cfg = model.cfg
    t = cache["t"]
    x = L.embed_tokens(token, model.embed, dtype)
    for blk, c in zip(model.blocks, cache["layers"]):
        x = _decode_block(x, blk, c, cfg, t, seq_len)
    x = L.apply_norm(x, model.final_norm, dtype, cfg.norm)
    logits = (x @ model.embed.head.to(dtype)).float()
    cache["t"] = t + 1
    return vocab_parallel_argmax(logits), logits, cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _ring_from_full(kf, vf, prompt_len: int, w_total: int):
    """Ring cache (k, v, pos) from full-sequence K/V (B, S, Hk, D): the last
    ``w_total`` positions, slot s holding absolute position p ≡ s (mod W),
    pos = -1 where no prompt position maps to the slot."""
    s = prompt_len
    slots = torch.arange(w_total, dtype=torch.int64, device=kf.device)
    # largest p ≤ s-1 with p ≡ slot (mod W)
    p = slots + torch.div(s - 1 - slots, w_total,
                          rounding_mode="floor") * w_total
    valid = (p >= 0) & (p < s) & (p > s - 1 - w_total)
    idx = torch.clamp(p, 0, s - 1)
    k = kf.index_select(1, idx)
    v = vf.index_select(1, idx)
    pos = torch.where(valid, p, -1).to(torch.int32)
    return k, v, pos


def prefill(model: T.LM, tokens, seq_len: int, dtype=torch.bfloat16,
            kv_dtype=torch.bfloat16, frames=None, patches=None,
            aux: bool = False):
    """Process a full prompt (B, S) (with whisper's ``frames`` or llava's
    ``patches``, the stub frontends' inputs); returns (cache, hidden
    (B, S, d)), and with ``aux`` also the MoE's {lb_loss, drop_frac}
    (means over layers).

    The forward is the prefill forward (chunked attention, the MoE's
    sequence chunks, the RG-LRU and WKV scan kernels); capture collects
    per-layer K/V (and a cross-attention's K/V over the encoder's output)
    and final recurrent states and this function lays them out into the
    decode cache."""
    cfg = model.cfg
    h, captured, moe_aux = T.forward_hidden(model, tokens, dtype, capture=True,
                                            frames=frames, patches=patches,
                                            aux=True)
    s_prompt = tokens.shape[1]
    layers = []
    for kind, cap in zip(layer_kinds(cfg), captured):
        if kind == "attn":
            kf, vf = cap["kv_full"]
            w_total = attn_cache_len(cfg, "attn", seq_len)
            k, v, pos = _ring_from_full(kf, vf, s_prompt, w_total)
            out = {"k": k.to(kv_dtype), "v": v.to(kv_dtype), "pos": pos}
            if "cross_kv_full" in cap:
                ckf, cvf = cap["cross_kv_full"]
                out.update(ck=ckf.to(kv_dtype), cv=cvf.to(kv_dtype))
            layers.append(out)
        elif kind in ("rglru", "rwkv"):
            layers.append(cap)
        else:
            raise ValueError(kind)
    cache = {"t": s_prompt, "layers": layers}
    return (cache, h, moe_aux) if aux else (cache, h)
