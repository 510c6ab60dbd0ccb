"""Serving: prefill + single-token greedy decode, single device.

The port's counterpart of :mod:`repro.models.serving` for the TP-mode
(recurrentgemma) block kinds:

  * Attention layers keep a ring KV cache of capacity W (the local window,
    or the whole context if shorter). A ``pos`` buffer holds the absolute
    position of each slot (-1 = empty): slot s holds position p ≡ s (mod W),
    so causal/window masking works under wraparound. Decode attends through
    :mod:`repro_torch.kernels.decode_attention` (a CUDA kernel on the card).
  * RG-LRU layers keep the per-channel state (B, r) and the last three
    pre-conv inputs (B, 3, r), both float32.

The cache is ``{"t": int, "layers": [per-layer dict, ...]}`` in layer order;
``t`` is the absolute position of the next token, a host integer. Unlike the
reference, which returns new cache arrays, :func:`decode_step` writes the
ring slots and the recurrent state in place and returns the same dict.
"""

from __future__ import annotations

import torch

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
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, b: int, seq_len: int,
               kv_dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero cache (pos = -1 ⇒ empty), one dict per layer."""
    layers = []
    for kind in layer_kinds(cfg):
        out = {}
        for name, (shape, dt) in _slot_cache_shapes(
                cfg, kind, b, seq_len, kv_dtype).items():
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
    pos_buf[slot] = t


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
    """x: (B, 1, d). Returns y (B, 1, d); updates the ring in place."""
    dtype = x.dtype
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q = (x @ w.wq.to(dtype)).reshape(b, 1, cfg.n_heads, hd)
    k = (x @ w.wk.to(dtype)).reshape(b, 1, cfg.n_kv_heads, hd)
    v = (x @ w.wv.to(dtype)).reshape(b, 1, cfg.n_kv_heads, hd)
    pos = torch.full((1,), t, dtype=torch.int32, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    w_total = attn_cache_len(cfg, "attn", seq_len)
    _ring_write(cache["k"], cache["pos"], k, t, w_total)
    _ring_write(cache["v"], cache["pos"], v, t, w_total)
    out = _decode_attend(q, cache["k"], cache["v"], cache["pos"], t, window)
    out = out.to(dtype).reshape(b, 1, cfg.q_dim)
    return out @ w.wo.to(dtype)


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


# ---------------------------------------------------------------------------
# Full decode step
# ---------------------------------------------------------------------------


def _decode_block(x, blk, cache, cfg: ModelConfig, t: int, seq_len: int):
    dtype = x.dtype
    h = L.apply_norm(x, blk.ln1, dtype)
    if blk.kind == "attn":
        win = cfg.swa_window or cfg.local_attn_window
        a = _attn_decode(h, blk.mix, cache, cfg, t, seq_len, win)
    elif blk.kind == "rglru":
        a = _rglru_decode(h, blk.mix, cache, cfg)
    else:
        raise ValueError(blk.kind)
    x = x + a
    h = L.apply_norm(x, blk.ln2, dtype)
    return x + L.mlp_tp(h, blk.ffn)


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
    x = L.apply_norm(x, model.final_norm, dtype)
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
            kv_dtype=torch.bfloat16):
    """Process a full prompt (B, S); returns (cache, hidden (B, S, d)).

    The forward is the prefill forward (chunked attention, the RG-LRU scan
    kernel); capture collects per-layer K/V and final recurrent states and
    this function lays them out into the decode cache."""
    cfg = model.cfg
    h, captured = T.forward_hidden(model, tokens, dtype, capture=True)
    s_prompt = tokens.shape[1]
    layers = []
    for kind, cap in zip(layer_kinds(cfg), captured):
        if kind == "attn":
            kf, vf = cap["kv_full"]
            w_total = attn_cache_len(cfg, "attn", seq_len)
            k, v, pos = _ring_from_full(kf, vf, s_prompt, w_total)
            layers.append({"k": k.to(kv_dtype), "v": v.to(kv_dtype),
                           "pos": pos})
        elif kind == "rglru":
            layers.append({"state": cap["state"], "conv": cap["conv"]})
        else:
            raise ValueError(kind)
    return {"t": s_prompt, "layers": layers}, h
