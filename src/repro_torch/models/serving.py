"""Serving: prefill + single-token greedy decode, on one device or a mesh.

The port's counterpart of :mod:`repro.models.serving` for every family:
the TP-mode block kinds (recurrentgemma's and rwkv6's) and the SP-mode
attention of the dense, MoE, encoder-decoder and VLM families:

  * Attention layers keep a ring KV cache of capacity W (the local or
    sliding window, or the whole context: a dense decoder's full causal
    ring). A ``pos`` buffer holds the absolute
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

On a mesh (a model built under ``par``) every rank holds its rows of the
batch (over the data axes) and, for an SP arch in the training layout
(``fsdp``), its block of W/mp ring slots over ``model`` where mp divides
W: :func:`_ring_write` writes a slot on its owner rank alone, and each
rank's decode-attention kernel attends its block, whose (out, m, l)
are merged over ``model`` (``decode_attention.ops.merge_across``). Else
every model rank holds the whole ring. In the serving-resident layout
(``model.serve_tp``) the attention heads are split over ``model`` and
each rank's ring holds its heads' K/V heads, whole. In both layouts
whisper's cross K/V hold this rank's S_enc/mp block of the encoder's
positions, attended by the kernel and merged over ``model`` as a
sequence-sharded ring is; an MoE step computes its partial output on the
rank's ff shard of every expert (and of arctic's dense residual) and
takes one psum over ``model``. A TP-mode arch (recurrentgemma, rwkv6)
splits its heads, RG-LRU channels and WKV heads over ``model`` in both
layouts: its rank holds the RG-LRU state and conv history of its r/mp
channels and the WKV state of its H/mp heads (the token shifts whole),
and its local attention's MQA ring whole (``fsdp``) or its K/V head
(``tp``); each mixer's row-parallel output takes one psum over
``model``. :func:`cache_pspecs` says which cache dimensions are split
over which axes. The token is replicated over
``model``; the head is vocab-parallel, so a step's logits are this rank's
vocabulary block and :func:`vocab_parallel_argmax` picks the global greedy
token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import par as P
from repro_torch.distributed.par import Par, PSpec
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, layer_kinds


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def serve_kv_heads(cfg: ModelConfig, mp: int) -> int:
    """K/V heads a rank's ring holds in the serving-resident layout:
    max(1, Hk/mp), the heads its H/mp query heads attend (ranks within a
    GQA group hold the same head)."""
    return max(1, (cfg.n_heads // mp) // (cfg.n_heads // cfg.n_kv_heads))


def attn_cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    if kind == "attn" and cfg.swa_window:
        return min(cfg.swa_window, seq_len)
    if kind == "attn" and cfg.local_attn_window:
        return min(cfg.local_attn_window, seq_len)
    return seq_len


def ring_sharded(cfg: ModelConfig, w_total: int, par: Par,
                 serve_tp: bool = False) -> bool:
    """Whether an attention layer's ring of ``w_total`` slots is split into
    W/mp blocks over ``model``: an SP arch in the training layout, mp
    dividing W (else each model rank holds the whole ring)."""
    return (par.mp is not None and cfg.parallel_mode == "sp"
            and not serve_tp and w_total % par.mp_size == 0)


def _slot_cache_shapes(cfg: ModelConfig, kind: str, b: int, seq_len: int,
                       kv_dtype=torch.bfloat16, par: Par = L.ONE,
                       serve_tp: bool = False):
    hd = cfg.resolved_head_dim
    if kind == "attn":
        w = attn_cache_len(cfg, kind, seq_len)
        w_loc = w // par.mp_size if ring_sharded(cfg, w, par, serve_tp) else w
        hk = (serve_kv_heads(cfg, par.mp_size) if serve_tp
              else cfg.n_kv_heads)
        return {
            "k": ((b, w_loc, hk, hd), kv_dtype),
            "v": ((b, w_loc, hk, hd), kv_dtype),
            "pos": ((w_loc,), torch.int32),
        }
    if kind == "rglru":
        r = cfg.rnn_dim // par.mp_size  # the rank's channels
        return {"state": ((b, r), torch.float32),
                "conv": ((b, 3, r), torch.float32)}
    if kind == "rwkv":
        d = cfg.d_model
        return {"state": ((b, cfg.n_heads // par.mp_size, hd, hd),
                          torch.float32),
                "shift_tm": ((b, d), torch.float32),
                "shift_cm": ((b, d), torch.float32)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, b: int, seq_len: int,
               kv_dtype=torch.bfloat16, device="cuda", par: Par = L.ONE,
               serve_tp: bool = False) -> dict:
    """Zero cache (pos = -1 ⇒ empty), one dict per layer; an
    encoder-decoder's layers also hold the cross-attention's K/V over the
    encoder's positions (``ck``, ``cv``: (B, S_enc, Hk, D)), which prefill
    computes once. On a mesh (``par``, ``serve_tp`` the layout) it is this
    rank's shard: ``b`` is its rows, each ring is its block of slots or
    its K/V heads, and ``ck``/``cv`` its S_enc/mp block of positions in
    either layout (:func:`cache_pspecs`)."""
    layers = []
    for kind in layer_kinds(cfg):
        shapes = _slot_cache_shapes(cfg, kind, b, seq_len, kv_dtype, par,
                                    serve_tp)
        if cfg.family == "encdec":
            cross = (b, cfg.encoder_seq // par.mp_size, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            shapes.update(ck=(cross, kv_dtype), cv=(cross, kv_dtype))
        out = {}
        for name, (shape, dt) in shapes.items():
            fill = -1 if name == "pos" else 0
            out[name] = torch.full(shape, fill, dtype=dt, device=device)
        layers.append(out)
    return {"t": 0, "layers": layers}


def cache_pspecs(cfg: ModelConfig, seq_len: int, par: Par,
                 serve_tp: bool = False) -> dict:
    """The placement of :func:`init_cache`'s shards on ``par``'s mesh (the
    reference's ``cache_pspecs``): ``{"t": None, "layers": [{leaf:
    PSpec}, ...]}``. An attention ring's K/V (B, W, Hk, D) is split over
    the data axes along B, and over ``model`` along W where the ring is
    sequence-sharded (:func:`ring_sharded`) or along Hk in the
    serving-resident layout (where the logical Hk is ``serve_kv_heads``
    times mp: heads a GQA group shares are held once a rank); ``pos``
    follows W. Whisper's ``ck``/``cv`` (B, S_enc, Hk, D) are split over
    the data axes along B and over ``model`` along S_enc, in both layouts.
    In either layout an RWKV layer's WKV state (B, H, D, D) is split over
    the data axes and ``model`` (its heads), its shifts over the data axes,
    and an RG-LRU layer's state (B, r) and conv history (B, 3, r) over the
    data axes and ``model`` (its channels, as its weights).
    A batch that does not split over the data ranks runs whole on each
    (``launch.steps.strip_dp``). On one device every leaf is whole."""
    mp = par.mp_axes
    layers = []
    for kind in layer_kinds(cfg):
        shapes = _slot_cache_shapes(cfg, kind, 1, seq_len, par=par,
                                    serve_tp=serve_tp)
        if not par.all_axes:
            spec = {n: PSpec(((),) * len(shape))
                    for n, (shape, _) in shapes.items()}
        elif kind == "rwkv":
            shift = PSpec((par.dp, ()))
            spec = {"state": PSpec((par.dp, mp, (), ())), "shift_tm": shift,
                    "shift_cm": shift}
        elif kind == "rglru":
            spec = {"state": PSpec((par.dp, mp)),
                    "conv": PSpec((par.dp, (), mp))}
        else:
            w = attn_cache_len(cfg, kind, seq_len)
            seq = mp if ring_sharded(cfg, w, par, serve_tp) else ()
            kv = PSpec((par.dp, seq, mp if serve_tp else (), ()))
            spec = {"k": kv, "v": kv, "pos": PSpec((seq,))}
        if cfg.family == "encdec":
            spec["ck"] = spec["cv"] = PSpec((par.dp, mp, (), ()))
        layers.append(spec)
    return {"t": None, "layers": layers}


# ---------------------------------------------------------------------------
# Decode-time sublayers
# ---------------------------------------------------------------------------


def _ring_write(buf, pos_buf, new, t: int, w_total: int, par: Par = L.ONE,
                seq_sharded: bool = False):
    """Write ``new`` (B, 1, H, D) into the ring at absolute position t, in
    place: slot t mod W, and pos[slot] = t. On a sequence-sharded ring
    (``buf`` holds W_loc = W/mp slots) only the slot's owner, model rank
    (t mod W) // W_loc, writes, at its local slot (t mod W) − owner·W_loc:
    ``t`` is a host int on every rank, so the test is on the host."""
    slot = t % w_total
    if seq_sharded:
        owner, slot = divmod(slot, buf.shape[1])
        if owner != P.axis_index(par.mp, par):
            return
    buf[:, slot] = new[:, 0].to(buf.dtype)
    pos_buf[slot].fill_(t)  # a kernel argument: no host-to-device copy


def _decode_attend(q, kbuf, vbuf, pos_buf, t: int, window,
                   par: Par = L.ONE, merge_axes: tuple[str, ...] = ()):
    """Flash-decode of one token over the ring. q: (B, 1, H, D); kbuf/vbuf:
    (B, W_loc, Hk, D); pos_buf: (W_loc,). Over ``merge_axes`` (the model
    ranks of a sequence-sharded ring) the kernel's (out, m, l) of each
    rank's block are merged (one pmax, two psums); with no merge axes, or
    one rank on them, the kernel's normalised output is the answer, bit
    for bit."""
    b, _, h, d = q.shape
    out, m, l = attn_ops.decode_attention(
        q.float().reshape(b, h, d), kbuf, vbuf, pos_buf, t, window)
    if merge_axes and par.mesh.size_of(merge_axes) > 1:
        out = attn_ops.merge_across(out, m, l, merge_axes, par)
    return out.reshape(b, 1, h, d)


def _attn_decode(x, w, cache, cfg: ModelConfig, t: int, seq_len: int,
                 window, par: Par = L.ONE, serve_tp: bool = False):
    """x: (B, 1, d), replicated over ``model``. GQA (Hk =
    ``cfg.n_kv_heads``) with the QKV bias where the layer has one. Returns
    y (B, 1, d); updates the ring in place.

    On a mesh, in the training layout, every model rank projects all the
    heads (the weights gathered over their fsdp axes) and attends its
    block of the sequence-sharded ring, merged over ``model``. In the
    serving-resident layout (``serve_tp``) Q and O are this rank's H/mp
    heads: its ring holds the K/V heads they attend, from
    (model index · H/mp) // G on, and a psum over ``model`` follows the
    row-parallel O."""
    dtype = x.dtype
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    tp_attn = cfg.parallel_mode == "tp" or serve_tp
    h_loc = cfg.n_heads // par.mp_size if tp_attn else cfg.n_heads
    q = L.qkv_proj(x, w, "q", par).reshape(b, 1, h_loc, hd)
    k = L.qkv_proj(x, w, "k", par).reshape(b, 1, cfg.n_kv_heads, hd)
    v = L.qkv_proj(x, w, "v", par).reshape(b, 1, cfg.n_kv_heads, hd)
    pos = torch.full((1,), t, dtype=torch.int32, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    if serve_tp and h_loc < cfg.n_heads:
        start = (P.axis_index(par.mp, par) * h_loc) // (cfg.n_heads
                                                        // cfg.n_kv_heads)
        n = serve_kv_heads(cfg, par.mp_size)
        k, v = k[:, :, start:start + n], v[:, :, start:start + n]
    w_total = attn_cache_len(cfg, "attn", seq_len)
    sharded = not tp_attn and ring_sharded(cfg, w_total, par)
    _ring_write(cache["k"], cache["pos"], k, t, w_total, par, sharded)
    _ring_write(cache["v"], cache["pos"], v, t, w_total, par, sharded)
    out = _decode_attend(q, cache["k"], cache["v"], cache["pos"], t, window,
                         par, par.mp_axes if sharded else ())
    out = out.to(dtype).reshape(b, 1, h_loc * hd)
    y = out @ P.gather_param(w.wo, w.specs["wo"], dtype, par)
    if tp_attn:
        y = P.psum(y, par.mp_axes, par)
    return y


# The query position a cross-attention's decode passes the kernel: past every
# encoder position, so the causal test keeps them all (the reference's).
CROSS_T = 10**9


def _cross_decode(x, w, cache, cfg: ModelConfig, par: Par = L.ONE):
    """Whisper's cross-attention at decode: the token's query against the
    encoder's K/V that prefill stored (``ck``, ``cv``), every position
    valid, no window and no RoPE. x: (B, 1, d), replicated over
    ``model``; returns y (B, 1, d). On a mesh (either layout) every model
    rank projects all the heads and attends its S_enc/mp block of
    ``ck``/``cv``, merged over ``model`` as a sequence-sharded ring is."""
    dtype = x.dtype
    b = x.shape[0]
    q = L.qkv_proj(x, w, "q", par).reshape(b, 1, cfg.n_heads,
                                           cfg.resolved_head_dim)
    ck, cv = cache["ck"], cache["cv"]
    pos = torch.arange(ck.shape[1], dtype=torch.int32, device=ck.device)
    out = _decode_attend(q, ck, cv, pos, CROSS_T, None, par, par.mp_axes)
    return out.to(dtype).reshape(b, 1, cfg.q_dim) @ P.gather_param(
        w.wo, w.specs["wo"], dtype, par)


def _moe_decode(h, w, cfg: ModelConfig, par: Par = L.ONE):
    """The MoE of one decode step: the (B, d) tokens are one
    :func:`~repro_torch.models.layers.moe_tokens` call (T = B, so the
    capacity is the batch's), plus the dense residual FFN (swiglu) where
    the layer has one. h: (B, 1, d), replicated over ``model``. On a mesh
    each rank's experts (and dense FFN) hold its ff shard, so both
    outputs are partial sums: one psum over ``model`` completes them."""
    b, _, d = h.shape
    y, _ = L.moe_tokens(h.reshape(b, d), L.moe_weights(w, h.dtype, par),
                        cfg)
    y = y.reshape(b, 1, d)
    if hasattr(w, "dense"):
        y = y + L._mlp_core(h, w.dense, "swiglu", par)
    return P.psum(y, par.mp_axes, par)


def _rglru_decode(x, w, cache, cfg: ModelConfig, par: Par = L.ONE):
    """One RG-LRU step. x: (B, 1, d), replicated over ``model``. Returns y
    (B, 1, d); updates the state and the conv history in place. On a mesh
    the rank's r/mp channels, then one psum over ``model`` after ``wo``."""
    dtype = x.dtype
    g = L.gathered(w, dtype, par)
    xt = x[:, 0]
    bx = xt @ g("wx")  # (B, r)
    hist = cache["conv"]  # (B, 3, r) f32
    seq = torch.cat([hist, bx[:, None].float()], dim=1)  # (B, 4, r)
    bconv = torch.einsum("bkr,kr->br", seq, g("conv").float())
    log_a, beta, i_gate = L.rglru_gates(
        xt @ g("wa"), xt @ g("wi"), L.gathered(w, torch.float32, par)("lam"))
    h = torch.exp(log_a) * cache["state"] + beta * (i_gate * bconv)
    gate = L._gelu(xt @ g("wgate"))
    y = ((h.to(dtype) * gate) @ g("wo"))[:, None]
    cache["state"].copy_(h)
    cache["conv"].copy_(seq[:, 1:])
    return P.psum(y, par.mp_axes, par)


def _rwkv_decode(x, w, cache, cfg: ModelConfig, par: Par = L.ONE):
    """One RWKV6 time-mix step. x: (B, 1, d) normed, replicated over
    ``model``. The mixes are formed in float32 and cast to the compute
    dtype, as in the reference (repro/models/serving.py:342). Returns y
    (B, 1, d); updates the WKV state and ``shift_tm`` in place. On a mesh
    the rank's H/mp heads, then one psum over ``model`` after ``wo``."""
    dtype = x.dtype
    b = x.shape[0]
    h, hd = cfg.n_heads // par.mp_size, cfg.resolved_head_dim
    g = L.gathered(w, dtype, par)
    f32 = L.gathered(w, torch.float32, par)
    xt = x[:, 0].float()
    mu = f32("mu")
    xprev = cache["shift_tm"]
    mix = lambda i: (xt + mu[i] * (xprev - xt)).to(dtype)
    r = (mix(0) @ g("wr")).float().reshape(b, h, hd)
    k = (mix(1) @ g("wk")).float().reshape(b, h, hd)
    v = (mix(2) @ g("wv")).float().reshape(b, h, hd)
    gate = mix(3) @ g("wg")
    lora = torch.tanh(mix(4) @ g("wa")) @ g("wb")
    wdec = torch.exp(L.rwkv_log_decay(f32("w0"), lora)).reshape(b, h, hd)
    u = f32("u")
    st = cache["state"]  # (B, H, D, D) f32, key × value
    y = (torch.einsum("bhd,bhde->bhe", r, st)
         + (r * u * k).sum(-1, keepdim=True) * v)
    st.mul_(wdec[..., None]).add_(k[..., :, None] * v[..., None, :])
    yn = L.rwkv_group_norm(y, f32("ln_x"), h, hd).reshape(b, 1, h * hd)
    cache["shift_tm"].copy_(xt)
    out = (yn.to(dtype) * F.silu(gate[:, None])) @ g("wo")
    return P.psum(out, par.mp_axes, par)


def _rwkv_cm_decode(x, w, cache, par: Par = L.ONE):
    """One channel-mix step; updates ``shift_cm`` in place. On a mesh the
    rank's d_ff/mp channels, psummed over ``model`` after ``cm_v``."""
    dtype = x.dtype
    g = L.gathered(w, dtype, par)
    xt = x[:, 0].float()
    xk = (0.5 * (xt + cache["shift_cm"])).to(dtype)
    r = torch.sigmoid(xk @ g("cm_r"))
    hh = torch.square(torch.relu(xk @ g("cm_k")))
    cache["shift_cm"].copy_(xt)
    return (r * P.psum(hh @ g("cm_v"), par.mp_axes, par))[:, None]


# ---------------------------------------------------------------------------
# Full decode step
# ---------------------------------------------------------------------------


def _decode_block(x, blk, cache, cfg: ModelConfig, t: int, seq_len: int,
                  par: Par = L.ONE, serve_tp: bool = False):
    """One layer's decode step; on a mesh (``par``) in the layout
    ``serve_tp`` names."""
    dtype = x.dtype
    h = L.apply_norm(x, blk.ln1, dtype, cfg.norm, par)
    if blk.kind == "rwkv":
        x = x + _rwkv_decode(h, blk.mix, cache, cfg, par)
        h = L.apply_norm(x, blk.ln2, dtype, cfg.norm, par)
        return x + _rwkv_cm_decode(h, blk.mix, cache, par)
    if blk.kind == "attn":
        win = cfg.swa_window or cfg.local_attn_window
        a = _attn_decode(h, blk.mix, cache, cfg, t, seq_len, win, par,
                         serve_tp)
    elif blk.kind == "rglru":
        a = _rglru_decode(h, blk.mix, cache, cfg, par)
    else:
        raise ValueError(blk.kind)
    x = x + a
    if hasattr(blk, "cross"):
        h = L.apply_norm(x, blk.ln_cross, dtype, cfg.norm, par)
        x = x + _cross_decode(h, blk.cross, cache, cfg, par)
    h = L.apply_norm(x, blk.ln2, dtype, cfg.norm, par)
    if blk.kind == "attn" and cfg.moe is not None:
        return x + _moe_decode(h, blk.ffn, cfg, par)
    # one token: the MLP of either mode, column/row parallel over `model`
    return x + L.mlp_tp(h, blk.ffn, cfg.mlp, par)


NO_WINNER = 2**30  # the reference's sentinel: above every vocabulary index


def vocab_parallel_argmax(logits, par: Par = L.ONE):
    """Greedy sampling: (B, 1, V_loc) → (B, 1) int64, the first index of
    the global maximum (as ``jnp.argmax``). On one device the vocabulary
    is whole. On a mesh ``logits`` is this rank's block of V/mp columns:
    each rank's max and its first index offset by shard·V_loc, the global
    max by one pmax over ``model``, and of the ranks that hold it the
    lowest index, by a second (a pmin as −pmax(−winner), the others
    offering ``NO_WINNER``)."""
    if par.mp is None:
        return torch.argmax(logits, dim=-1)
    v_loc = logits.shape[-1]
    local_max = logits.amax(-1)
    local_arg = (torch.argmax(logits, dim=-1)
                 + P.axis_index(par.mp, par) * v_loc)
    m = P.pmax(local_max, par.mp_axes, par)
    winner = torch.where(local_max >= m, local_arg,
                         torch.full_like(local_arg, NO_WINNER))
    return -P.pmax(-winner, par.mp_axes, par)


def decode_step(model: T.LM, cache: dict, token, seq_len: int,
                dtype=torch.bfloat16):
    """One serve step: token_t (B, 1) → (next_token (B, 1), logits (B, 1, V)
    f32, cache). ``cache['t']`` is the absolute position of ``token``; the
    cache is updated in place and ``t`` advanced.

    On a mesh (``model.par``) ``token`` is this rank's rows, replicated
    over ``model``, ``cache`` its shard (:func:`init_cache`, or a sharded
    :func:`prefill`'s) and the logits its vocabulary block (B, 1, V/mp);
    the next token is the global greedy one, the same on every model
    rank."""
    cfg, par = model.cfg, model.par
    t = cache["t"]
    x = L.embed_tokens(token, model.embed, dtype, par, sp=False)
    for blk, c in zip(model.blocks, cache["layers"]):
        x = _decode_block(x, blk, c, cfg, t, seq_len, par, model.serve_tp)
    x = L.apply_norm(x, model.final_norm, dtype, cfg.norm, par)
    head = P.gather_param(model.embed.head, model.embed.specs["head"], dtype,
                          par)
    logits = (x @ head).float()
    cache["t"] = t + 1
    return vocab_parallel_argmax(logits, par), logits, cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _ring_from_full(kf, vf, prompt_len: int, w_total: int, par: Par = L.ONE,
                    seq_sharded: bool = False):
    """Ring cache (k, v, pos) from full-sequence K/V (B, S, Hk, D): the last
    ``w_total`` positions, slot s holding absolute position p ≡ s (mod W),
    pos = -1 where no prompt position maps to the slot. On a
    sequence-sharded ring, this model rank's block of it: slots
    shard·W_loc + i, i < W_loc = W/mp (``kf``, ``vf`` are the whole
    sequence's, gathered over ``model``)."""
    s = prompt_len
    w_loc = w_total // par.mp_size if seq_sharded else w_total
    shard = P.axis_index(par.mp, par) if seq_sharded else 0
    slots = shard * w_loc + torch.arange(w_loc, dtype=torch.int64,
                                         device=kf.device)
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
    (means over layers). On a mesh (``model.par``) ``tokens`` and
    ``patches`` are this rank's rows, ``frames`` its rows' S_enc/mp block
    of positions, the hidden its sequence block (B, S/mp, d) (a TP-mode
    arch's: the whole (B, S, d), replicated over ``model``) and the cache
    its shard in the training layout (:func:`cache_pspecs`; the cross K/V
    this rank's block of the K/V gathered over ``model``).

    The forward is the prefill forward (chunked attention, the MoE's
    sequence chunks, the RG-LRU and WKV scan kernels); capture collects
    per-layer K/V (and a cross-attention's K/V over the encoder's output)
    and final recurrent states and this function lays them out into the
    decode cache."""
    cfg, par = model.cfg, model.par
    if model.serve_tp:
        raise ValueError("the serving-resident layout has no prefill (nor "
                         "has the reference's): start its cache from "
                         "init_cache")
    h, captured, moe_aux = T.forward_hidden(model, tokens, dtype, capture=True,
                                            frames=frames, patches=patches,
                                            aux=True)
    s_prompt = tokens.shape[1]
    layers = []
    for kind, cap in zip(layer_kinds(cfg), captured):
        if kind == "attn":
            kf, vf = cap["kv_full"]
            w_total = attn_cache_len(cfg, "attn", seq_len)
            k, v, pos = _ring_from_full(kf, vf, s_prompt, w_total, par,
                                        ring_sharded(cfg, w_total, par))
            out = {"k": k.to(kv_dtype), "v": v.to(kv_dtype), "pos": pos}
            if "cross_kv_full" in cap:
                ckf, cvf = cap["cross_kv_full"]
                loc = ckf.shape[1] // par.mp_size
                c0 = P.axis_index(par.mp, par) * loc
                out.update(ck=ckf[:, c0:c0 + loc].to(kv_dtype).contiguous(),
                           cv=cvf[:, c0:c0 + loc].to(kv_dtype).contiguous())
            layers.append(out)
        elif kind in ("rglru", "rwkv"):
            layers.append(cap)
        else:
            raise ValueError(kind)
    cache = {"t": s_prompt, "layers": layers}
    return (cache, h, moe_aux) if aux else (cache, h)
