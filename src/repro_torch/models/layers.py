"""Model layers of the LM serving and training paths.

The port's counterpart of :mod:`repro.models.layers`, with what every
family's path runs (recurrentgemma, rwkv6, the dense decoders, mixtral and
arctic, whisper, llava): norms (RMSNorm and the bias-free layernorm), RoPE,
the chunked (online-softmax) prefill attention, one attention sublayer
(with its optional QKV bias, or as a cross-attention) and one MLP (gelu or
swiglu) for both the sequence-parallel ("SP mode") and head-parallel ("TP
mode") stacks, the capacity-dispatched MoE, the RG-LRU mixer, the RWKV6
time and channel mixes and the embedding. Each function keeps the reference's name;
``w`` is the layer's :class:`~repro_torch.models.params.Params` module
where the reference takes a weight dict. On one device (the trivial
``Par()``, the default ``par``) every gather, psum and reduce-scatter of the
reference is the identity, so SP attention is the plain computation over
the whole sequence. The SP-mode path also runs on a mesh (``par``
from :func:`repro_torch.launch.mesh.make_par`): the residual stream is
(B/dp, S/mp, d), each weight is this rank's shard and is gathered over its
fsdp axes where it is used; ``embed_tokens`` is vocab-parallel with a
reduce-scatter into the sequence blocks, ``attn_tp`` (``attn_sp``)
all-gathers K and V over ``model`` (a cross-attention's, projected from
the rank's block of the encoder's positions, too), ``mlp_sp`` and
``moe_sp`` all-gather a sequence chunk for their column/row-parallel
products (the MoE's on each expert's ff shard) and reduce-scatter it
back, and ``ce_loss_sp`` is vocab-parallel over ``model``. A decode
step's token is replicated over ``model`` instead:
``embed_tokens(sp=False)`` psums the vocabulary blocks' rows and
``mlp_tp`` psums its column/row-parallel product.

The TP-mode path (recurrentgemma, rwkv6) runs on a mesh too: the residual
stream (B/dp, S, d) is replicated over ``model``, the embedding psums its
vocabulary blocks' rows, and each mixer and MLP splits its heads, RG-LRU
channels, WKV heads or ff columns over ``model``, one psum after its
row-parallel output (the reference's ``attn_tp``, ``rglru_mix``,
``rwkv_mix``, ``rwkv_channel_mix``, ``mlp_tp``); ``ce_loss_tp`` is
vocab-parallel. Each such branch takes its input through
:func:`~repro_torch.distributed.par.tp_entry`, whose backward sums the
ranks' parts of the input's cotangent, and a norm scale (and RWKV's
``cm_r``) through :func:`~repro_torch.distributed.par.replicated_grad`,
as every model rank computes its whole gradient: so each rank's gradient
is the single device's (the reference's is that times the device count,
ROADMAP queue 3 item 3).

Weights are cast to the compute ``dtype`` where the reference's
``gather_param`` casts them (a no-op when the model is stored in ``dtype``),
before their gather.
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
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import par as P
from repro_torch.distributed.par import Par
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Params, WDef

_NEG = -1e30
_I32_MAX = 2**31 - 1
ONE = Par()  # the trivial axis context: one device, every collective the identity


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


def apply_norm(x, w: Params, dtype, kind: str = "rmsnorm", par: Par = ONE,
               replicated: bool = False):
    """RMSNorm, or the bias-free layernorm (``kind="layernorm"``:
    stablelm), in float32, times the scale cast to ``dtype`` (gathered
    under ``par``). Rows are independent: no collective on activations.
    ``replicated``: ``x`` is the same on every model rank (TP mode), so
    each computes the scale's whole gradient
    (:func:`~repro_torch.distributed.par.replicated_grad`)."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mu).mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + 1e-6)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    scale = P.gather_param(w.scale, w.specs["scale"], dtype, par)
    if replicated:
        scale = P.replicated_grad(scale, par)
    return (xf * scale.float()).to(dtype)


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


def attn_defs(cfg: ModelConfig, cross: bool = False,
              serve_tp: bool = False) -> dict[str, WDef]:
    """Q, K, V and output projections, and with ``cfg.qkv_bias`` (qwen)
    zero-initialised Q, K and V biases; a cross-attention (``cross``,
    whisper's decoder) has none. Placement: the reference's ``attn_defs``
    in SP mode (every weight FSDP-sharded, K/V gathered in compute), its
    ``attn_tp_defs`` in TP mode (Q column- and O row-parallel heads).
    ``serve_tp`` (the serving-resident layout of an SP arch) takes
    ``attn_tp_defs`` too, which declares no bias: in that layout qwen's
    attention runs without its QKV bias, as the reference's does."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    both = (0, 1)
    if (cfg.parallel_mode == "tp" or serve_tp) and not cross:
        q = WDef((d, qd), tp_dim=1)
        o = WDef((qd, d), tp_dim=0, fsdp_pref=(1,))
    else:
        q, o = WDef((d, qd), fsdp_pref=both), WDef((qd, d), fsdp_pref=both)
    defs = {"wq": q, "wk": WDef((d, kvd), fsdp_pref=both),
            "wv": WDef((d, kvd), fsdp_pref=both), "wo": o}
    if cfg.qkv_bias and not cross and not serve_tp:
        defs.update(bq=WDef((qd,), init="zeros"), bk=WDef((kvd,), init="zeros"),
                    bv=WDef((kvd,), init="zeros"))
    return defs


def gathered(w: Params, dtype, par: Par = ONE):
    """``name → w.name`` cast to ``dtype`` and gathered over its fsdp axes
    (its ``model`` shard stays), as a function."""
    return lambda n: P.gather_param(getattr(w, n), w.specs[n], dtype, par)


def qkv_proj(x, w: Params, name: str, par: Par = ONE):
    """``x @ w{name}`` (+ ``b{name}`` where the layer has biases), both in
    x's dtype (gathered under ``par``), as the reference's ``proj``."""
    dtype = x.dtype
    g = lambda n: P.gather_param(getattr(w, n), w.specs[n], dtype, par)
    y = x @ g("w" + name)
    if "b" + name in w.defs:
        y = y + g("b" + name)
    return y


def attn_tp(x, w: Params, cfg: ModelConfig, *, causal: bool = True,
            window: int | None = None, chunk: int = 1024,
            return_kv: bool = False, kv_source=None, use_rope: bool = True,
            par: Par = ONE):
    """All heads over the whole sequence (on one device the reference's
    head split, or its K/V gather in SP mode, is the identity): GQA, the
    QKV bias where the layer has one, RoPE at absolute positions, KV chunks
    of ``chunk`` (the reference's TP mode takes 1,024, its SP mode 512).
    x: (B, S, d). ``kv_source`` (B, S_kv, d) is a cross-attention's key and
    value input (whisper's encoder output; with ``causal=False`` and
    ``use_rope=False``). With ``return_kv`` also returns the (roped) (k, v)
    for the decode cache.

    Under a sharded ``par`` in SP mode (the reference's ``attn_sp``) x is
    this rank's (B, S/mp, d) sequence block: its rows sit at positions
    shard·S_loc + i, and K and V, projected and roped on the local rows,
    are all-gathered over ``model`` (small for GQA), so every rank attends
    its queries to the whole sequence. In TP mode (the reference's
    ``attn_tp``) x is the whole (B, S, d), replicated over ``model``: Q and
    O are this rank's H/mp heads (``wq``'s column and ``wo``'s row shard),
    the MQA K and V are computed whole on every rank, and one psum over
    ``model`` follows O."""
    dtype = x.dtype
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    tp = cfg.parallel_mode == "tp"
    if tp:
        x = P.tp_entry(x, par)
    kv_in = x if kv_source is None else kv_source
    s_kv = kv_in.shape[1]
    h_loc = cfg.n_heads // par.mp_size if tp else cfg.n_heads
    q = qkv_proj(x, w, "q", par).reshape(b, s, h_loc, hd)
    k = qkv_proj(kv_in, w, "k", par).reshape(b, s_kv, cfg.n_kv_heads, hd)
    v = qkv_proj(kv_in, w, "v", par).reshape(b, s_kv, cfg.n_kv_heads, hd)
    shard = 0 if tp else P.axis_index(par.mp, par)
    q_pos = shard * s + torch.arange(s, dtype=torch.int32, device=x.device)
    k_pos = shard * s_kv + torch.arange(s_kv, dtype=torch.int32,
                                        device=x.device)
    if use_rope:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, k_pos, cfg.rope_theta)
    if par.mp and not tp:
        k = P.all_gather(k, par.mp_axes, 1, par)
        v = P.all_gather(v, par.mp_axes, 1, par)
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    out = chunked_attention(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, chunk=chunk)
    y = out.reshape(b, s, h_loc * hd) @ P.gather_param(w.wo, w.specs["wo"],
                                                       dtype, par)
    if tp:
        y = P.psum(y, par.mp_axes, par)
    if return_kv:
        return y, (k, v)
    return y


attn_sp = functools.partial(attn_tp, chunk=512)  # the reference's SP name


# ---------------------------------------------------------------------------
# MLP — gelu or swiglu, either mode
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig) -> dict[str, WDef]:
    d, ff = cfg.d_model, cfg.d_ff
    defs = {"w1": WDef((d, ff), tp_dim=1),
            "w2": WDef((ff, d), tp_dim=0, fsdp_pref=(1,))}
    if cfg.mlp == "swiglu":
        defs["w3"] = WDef((d, ff), tp_dim=1)
    return defs


def _mlp_core(x, w: Params, kind: str, par: Par = ONE):
    """gelu(x·w1)·w2, or silu(x·w1)·(x·w3)·w2 (swiglu), in x's dtype, on
    the weights gathered over their fsdp axes: under a sharded ``par`` w1
    and w3 stay column and w2 row shards of ``model``, so the result is
    this rank's partial sum."""
    dtype = x.dtype
    g = lambda n: P.gather_param(getattr(w, n), w.specs[n], dtype, par)
    h = x @ g("w1")
    if kind == "swiglu":
        h = F.silu(h) * (x @ g("w3"))
    else:
        h = _gelu(h)
    return h @ g("w2")


def mlp_tp(x, w: Params, kind: str = "gelu", par: Par = ONE):
    """The TP-mode MLP (the reference's ``mlp_tp``): x (B, S, d) replicated
    over ``model``, the column/row-parallel product, then a psum over
    ``model``. On one device it is the MLP of either mode (SP's all-gather
    and reduce-scatter are identities too; SP's sequence chunks only bound
    the reference's transients, as rows are independent). A decode step
    takes it in both serving layouts. Under autograd x's cotangent is
    summed over ``model`` (:func:`~repro_torch.distributed.par.tp_entry`)."""
    return P.psum(_mlp_core(P.tp_entry(x, par), w, kind, par), par.mp_axes,
                  par)


def mlp_sp(x, w: Params, cfg: ModelConfig, par: Par = ONE):
    """The reference's SP-mode MLP (Megatron-SP). One device: ``mlp_tp``.
    Under a sharded ``par``, x is (B, S_loc, d) sequence-sharded: each of
    :func:`_auto_chunk`'s sequence chunks is all-gathered over ``model``,
    runs through the column/row-parallel MLP (the ``d_ff / mp`` columns of
    this rank), and its partial output is reduce-scattered back over the
    sequence; several chunks each run under a checkpoint, so one chunk's
    gathered activations are live at a time."""
    if par.mesh is None:
        return mlp_tp(x, w, cfg.mlp)
    b, s_loc, d = x.shape
    chunk = _auto_chunk(b, s_loc, d, par.mp_size)

    def one_chunk(xc):
        xg = P.all_gather(xc, par.mp_axes, 1, par)
        return P.reduce_scatter(_mlp_core(xg, w, cfg.mlp, par), par.mp_axes,
                                1, par)

    if s_loc <= chunk:
        return one_chunk(x)
    return torch.cat([checkpoint(one_chunk, x[:, c0:c0 + chunk],
                                 use_reentrant=False)
                      for c0 in range(0, s_loc, chunk)], 1)


def _auto_chunk(b: int, s: int, d: int, mp: int = 1,
                budget: int = 1 << 27) -> int:
    """The reference's ``_auto_chunk``: the largest power-of-two halving of
    ``s`` (down to 16) whose (B, chunk·mp, d) bf16 tensor (a chunk
    gathered over ``mp`` model shards) stays under ``budget`` bytes,
    halved again until it divides ``s``. The reference's MoE sees one such
    sequence chunk a call, so its capacity, and which pairs it drops,
    depend on it."""
    chunk = s
    while chunk > 16 and b * chunk * mp * d * 2 > budget:
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
    defs = {"router": WDef((d, e)),
            "w1": WDef((e, d, ff), tp_dim=2, fsdp_pref=(1,)),
            "w2": WDef((e, ff, d), tp_dim=1, fsdp_pref=(2,)),
            "w3": WDef((e, d, ff), tp_dim=2, fsdp_pref=(1,))}
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


def moe_weights(w: Params, dtype, par: Par = ONE) -> tuple:
    """The MoE layer's (router, w1, w2, w3) cast to ``dtype`` and gathered
    over their fsdp axes (the reference's ``gathered``): on a mesh each
    expert's ff dimension stays this rank's ``model`` shard (w1, w3 on
    dimension 2, w2 on 1), so an expert's output is a partial sum over
    ``model``."""
    return tuple(P.gather_param(getattr(w, n), w.specs[n], dtype, par)
                 for n in ("router", "w1", "w2", "w3"))


def moe_tokens(tokens, weights: tuple, cfg: ModelConfig):
    """The reference's ``_moe_tokens``: (T, d) tokens through their top-k
    experts at a fixed capacity, on ``weights`` = (router, w1, w2, w3) in
    the tokens' dtype (:func:`moe_weights`). Returns (y (T, d), aux
    {lb_loss, drop_frac}).

    The kept pairs are scattered into an (E·cap + 1, d) buffer whose last
    row takes the dropped ones and is discarded; every expert runs its
    swiglu over all cap rows (batched products over the E experts, as the
    reference computes them, empty rows included); the outputs are
    gathered back to the pairs (zero for a dropped one), put back in
    token-major order and summed over k with the gates, in the tokens'
    dtype. ``lb_loss`` is the Switch balance term E·Σ_e f_e·p̄_e / k,
    ``drop_frac`` the share of pairs dropped. With ff-sharded experts y is
    this rank's partial sum; routing and aux are whole."""
    dtype = tokens.dtype
    t, d = tokens.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    router, w1, w2, w3 = weights
    r = moe_route(tokens, router, cfg)
    cap, order, ok, slot = r["cap"], r["order"], r["ok"], r["slot"]
    buf = torch.zeros(e * cap + 1, d, dtype=dtype, device=tokens.device)
    buf.index_copy_(0, slot, tokens.index_select(0, order // k))
    buf = buf[:e * cap].view(e, cap, d)
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    yb = torch.bmm(h, w2).view(e * cap, d)
    y_sorted = torch.where(ok[:, None],
                           yb.index_select(0, slot.clamp(max=e * cap - 1)), 0)
    y_assign = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    y = (y_assign.view(t, k, d) * r["gate"][..., None].to(dtype)).sum(1)
    onehot = r["expert"][..., None] == torch.arange(e, device=tokens.device)
    frac_tokens = onehot.float().sum(1).mean(0)
    aux = {"lb_loss": e * (frac_tokens * r["probs"].mean(0)).sum() / k,
           "drop_frac": 1.0 - ok.float().mean()}
    return y, aux


def moe_sp(x, w: Params, cfg: ModelConfig, chunk: int | None = None,
           par: Par = ONE):
    """The reference's SP-mode MoE: (B, S_loc, d) in sequence chunks of
    ``chunk`` local positions (default :func:`_auto_chunk`'s for the
    chunk gathered over ``model``), each chunk all-gathered over ``model``
    and its B·chunk·mp tokens one :func:`moe_tokens` call on the experts
    of :func:`moe_weights` (ff-sharded over ``model``), plus the dense
    residual FFN (swiglu, column/row-parallel) where the layer has one;
    the partial output is reduce-scattered back over the sequence. Returns
    (y, aux), aux the mean over chunks. Every model rank routes the same
    gathered tokens, so its aux is the same. On one device every
    collective is the identity. On a mesh several chunks each run under a
    checkpoint, as :func:`mlp_sp`'s do."""
    b, s, d = x.shape
    chunk = chunk or _auto_chunk(b, s, d, par.mp_size)
    assert s <= chunk or s % chunk == 0, (s, chunk)
    weights = moe_weights(w, x.dtype, par)
    dense = getattr(w, "dense", None)

    def one_chunk(xc):
        xg = P.all_gather(xc, par.mp_axes, 1, par)
        y, aux = moe_tokens(xg.reshape(-1, d), weights, cfg)
        y = y.view(xg.shape)
        if dense is not None:
            y = y + _mlp_core(xg, dense, "swiglu", par)
        return P.reduce_scatter(y, par.mp_axes, 1, par), aux

    if s <= chunk:
        return one_chunk(x)
    run = (one_chunk if par.mesh is None else
           functools.partial(checkpoint, one_chunk, use_reentrant=False))
    ys, auxes = zip(*(run(x[:, c0:c0 + chunk]) for c0 in range(0, s, chunk)))
    return torch.cat(ys, 1), {n: torch.stack([a[n] for a in auxes]).mean()
                              for n in auxes[0]}


# ---------------------------------------------------------------------------
# RG-LRU (Griffin) recurrence block
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_defs(cfg: ModelConfig) -> dict[str, WDef]:
    d, r = cfg.d_model, cfg.rnn_dim
    return {
        "wx": WDef((d, r), tp_dim=1),
        "wgate": WDef((d, r), tp_dim=1),  # gelu branch
        "wa": WDef((d, r), tp_dim=1),  # recurrence gate a_t
        "wi": WDef((d, r), tp_dim=1),  # input gate i_t
        "conv": WDef((4, r), init="scaled", init_scale=0.5, tp_dim=1),
        "lam": WDef((r,), init="ones", tp_dim=0),  # Λ (softplus-parameterized)
        "wo": WDef((r, d), tp_dim=0, fsdp_pref=(1,)),
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


def rglru_mix(x, w: Params, cfg: ModelConfig, return_state: bool = False,
              par: Par = ONE):
    """RG-LRU mixer over the whole sequence. x: (B, S, d). With
    ``return_state`` also returns (final h (B, r) f32, last 3 pre-conv
    inputs (B, 3, r) f32), the decode cache.

    Under a sharded ``par`` x is replicated over ``model`` and the r
    channels are split over it (the reference's ``rglru_mix``): the
    projections, the conv, Λ and the scan run on this rank's r/mp channels
    (so do the returned state and history), and one psum over ``model``
    follows ``wo``."""
    dtype = x.dtype
    x = P.tp_entry(x, par)
    g = gathered(w, dtype, par)
    bx_pre = x @ g("wx")
    bx = _depthwise_conv(bx_pre, g("conv"))
    log_a, beta, i_gate = rglru_gates(x @ g("wa"), x @ g("wi"),
                                      gathered(w, torch.float32, par)("lam"))
    bterm = beta * (i_gate * bx.float())
    h32, h_last = rglru_ops.rglru_scan(log_a, bterm)
    gate = _gelu(x @ g("wgate"))
    y = P.psum((h32.to(dtype) * gate) @ g("wo"), par.mp_axes, par)
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
        # r, k, v, g, w token shifts
        "mu": WDef((5, d), init="zeros", fsdp_pref=(1,)),
        "wr": WDef((d, d), tp_dim=1),
        "wk": WDef((d, d), tp_dim=1),
        "wv": WDef((d, d), tp_dim=1),
        "wg": WDef((d, d), tp_dim=1),
        # decay base: exp(w0) ≈ 0.05 per step (see the clip in rwkv_mix)
        "w0": WDef((d,), init="const", init_scale=-3.0, tp_dim=0),
        "wa": WDef((d, _RWKV_LORA)),  # decay LoRA
        "wb": WDef((_RWKV_LORA, d), init="zeros", tp_dim=1),
        "u": WDef((h, hd), init="zeros", tp_dim=0),  # per-head bonus
        "ln_x": WDef((d,), init="ones", tp_dim=0),  # per-head group norm
        "wo": WDef((d, d), tp_dim=0, fsdp_pref=(1,)),
        "cm_r": WDef((d, d), fsdp_pref=(0, 1)),
        "cm_k": WDef((d, ff), tp_dim=1),
        "cm_v": WDef((ff, d), tp_dim=0, fsdp_pref=(1,)),
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


_RWKV_COMPUTE = ("mu", "wr", "wk", "wv", "wg", "wa", "wb", "wo", "cm_r",
                 "cm_k", "cm_v")  # gathered in the compute dtype
_RWKV_F32 = ("w0", "u", "ln_x")  # gathered in float32


def rwkv_weights(w: Params, dtype, par: Par = ONE) -> dict:
    """An RWKV block's mix weights (``blk.mix``), each cast and gathered
    over its fsdp axes once a block, outside the time-chunk loop (the
    reference's ``_pre``: a gather a time chunk would repeat each FSDP
    gather S/512 times). Under a sharded ``par`` the r, k, v, g, decay and
    ``cm_k`` columns, ``w0``, ``u``, ``ln_x`` and the rows of ``wo`` and
    ``cm_v`` stay this rank's ``model`` shards (its H/mp heads and
    d_ff/mp channels); ``cm_r``, whose product every model rank computes
    whole, takes :func:`~repro_torch.distributed.par.replicated_grad`."""
    g, f32 = gathered(w, dtype, par), gathered(w, torch.float32, par)
    out = {n: g(n) for n in _RWKV_COMPUTE} | {n: f32(n) for n in _RWKV_F32}
    out["cm_r"] = P.replicated_grad(out["cm_r"], par)
    return out


def rwkv_mix(x, wts: dict, cfg: ModelConfig, state0, shift0,
             par: Par = ONE):
    """RWKV6 time mix over one time chunk (prefill or training). x: (B, s,
    d) normed input; ``wts`` the block's :func:`rwkv_weights`; ``state0``
    (B, H, D, D) and ``shift0`` (B, d) float32 continue the recurrence
    from the previous time chunk. Returns (out (B, s, d), final WKV state,
    last input (B, d) float32 for the next shift).

    The mixes are formed in the compute dtype; r, k, v and the log decay
    go to the WKV kernel in float32 with WKV chunks of min(64, s). Under
    autograd the final state is differentiable: its cotangent, from the
    next time chunk, enters the WKV backward (``RWKV6Scan``) with y's.
    Under a sharded ``par`` x is replicated over ``model`` and this rank
    runs its H/mp heads (state (B, H/mp, D, D)), with one psum over
    ``model`` after ``wo``; x enters through
    :func:`~repro_torch.distributed.par.tp_entry`, shift included."""
    dtype = x.dtype
    b, s, d = x.shape
    h, hd = cfg.n_heads // par.mp_size, cfg.resolved_head_dim
    x = P.tp_entry(x, par)
    mu = wts["mu"]
    xprev = _shifted(x, shift0)
    mix = lambda i: x + mu[i] * (xprev - x)
    r = mix(0) @ wts["wr"]
    k = mix(1) @ wts["wk"]
    v = mix(2) @ wts["wv"]
    g = mix(3) @ wts["wg"]
    lora = torch.tanh(mix(4) @ wts["wa"]) @ wts["wb"]
    logw = rwkv_log_decay(wts["w0"], lora)

    def heads(t):  # (B, s, H·D) → (B, H, s, D) float32
        return t.reshape(b, s, h, hd).transpose(1, 2).float().contiguous()

    y, state = rwkv_ops.rwkv6_scan(heads(r), heads(k), heads(v), heads(logw),
                                   wts["u"].contiguous(), state0,
                                   chunk=_WKV_CHUNK)
    # each WKV chunk's y passes through the compute dtype, as the
    # reference's scan stacks it (repro/models/layers.py:582)
    y = y.to(dtype).float().transpose(1, 2)  # (B, s, H, D)
    yn = rwkv_group_norm(y, wts["ln_x"], h, hd).reshape(b, s, h * hd)
    out = (yn.to(dtype) * F.silu(g)) @ wts["wo"]
    return P.psum(out, par.mp_axes, par), state, x[:, -1].float()


def rwkv_channel_mix(x, wts: dict, shift0, par: Par = ONE):
    """sigmoid(xk·cm_r) · (relu(xk·cm_k)²·cm_v) with xk = ½(x + x_prev), on
    the block's :func:`rwkv_weights`. Returns (out, last input (B, d)
    float32 for the next shift). Under a sharded ``par`` the r gate is
    whole on every model rank and the ff branch is this rank's d_ff/mp
    channels (only its input goes through
    :func:`~repro_torch.distributed.par.tp_entry`), psummed over
    ``model`` before the gate."""
    xk = 0.5 * (x + _shifted(x, shift0))
    r = torch.sigmoid(xk @ wts["cm_r"])
    hh = torch.square(torch.relu(P.tp_entry(xk, par) @ wts["cm_k"]))
    return r * P.psum(hh @ wts["cm_v"], par.mp_axes, par), x[:, -1].float()


def rwkv_block_chunked(x, blk, cfg: ModelConfig, capture: bool = False,
                       par: Par = ONE):
    """A whole RWKV block (norm → time mix → norm → channel mix) over time
    chunks of ``min(512, S)`` steps, halved until they divide S, with the
    WKV state and both token shifts carried from chunk to chunk (the
    reference's rule, which bounds the live activations to one chunk).
    The mix weights are gathered once, before the first chunk
    (:func:`rwkv_weights`). Returns (x, cache): with ``capture`` the
    decode cache {state, shift_tm, shift_cm}, else {}. Under a sharded
    ``par`` x (B, S, d) is replicated over ``model`` and the state is this
    rank's H/mp heads.

    Under autograd the state and shifts carry gradients back from each time
    chunk to the one before. The reference also checkpoints each time
    chunk's body (``jax.checkpoint`` in its scan); the port does not: under
    ``remat`` the layer group's checkpoint already keeps only the block's
    input through the forward, and its recompute holds one layer's time
    chunks' activations, where a checkpoint a time chunk would run each
    WKV forward a third time. The values and gradients are the same either
    way."""
    dtype = x.dtype
    b, s, d = x.shape
    h, hd = cfg.n_heads // par.mp_size, cfg.resolved_head_dim
    chunk = min(RWKV_TIME_CHUNK, s)
    while s % chunk:
        chunk //= 2
    wts = rwkv_weights(blk.mix, dtype, par)
    norm = functools.partial(apply_norm, dtype=dtype, kind=cfg.norm, par=par,
                             replicated=True)
    state = torch.zeros(b, h, hd, hd, dtype=torch.float32, device=x.device)
    sh_tm = torch.zeros(b, d, dtype=torch.float32, device=x.device)
    sh_cm = torch.zeros(b, d, dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, s, chunk):
        xc = x[:, t0:t0 + chunk]
        m, state, sh_tm = rwkv_mix(norm(xc, blk.ln1), wts, cfg, state, sh_tm,
                                   par)
        xc = xc + m
        cm, sh_cm = rwkv_channel_mix(norm(xc, blk.ln2), wts, sh_cm, par)
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
    return {"table": WDef((vp, d), init_scale=1.0, tp_dim=0,
                          fsdp_pref=(1,)),
            "head": WDef((d, vp), tp_dim=1)}


def embed_tokens(ids, w: Params, dtype, par: Par = ONE, sp: bool = True):
    """ids: (B, S) → (B, S, d). Rows are gathered, then cast (the reference
    casts the table first; the values are the same). One lookup for both
    modes: on one device the reference's vocab-parallel psum (TP) and
    reduce-scatter into sequence parallelism (SP) are identities.
    ``F.embedding``, not ``table[ids]``: the indexing's backward accumulates
    a repeated id's rows in an order that changes from run to run on the
    CPU, the embedding's backward in a fixed one.

    Under a sharded ``par`` (SP mode): ids are replicated over ``model``;
    each rank looks its ids up in its vocabulary block of the table
    (gathered over the fsdp axes in the table's own dtype, so that the rows
    are cast after the lookup as on one device), zeroes the ids outside
    the block, and a reduce-scatter over the sequence sums the blocks'
    rows and enters sequence parallelism: (B, S/mp, d). With ``sp=False``
    (a decode step's token, or the TP-mode stream) a psum over ``model``
    sums them instead, and every model rank holds the whole (B, S, d)."""
    if par.mesh is None:
        return F.embedding(ids, w.table).to(dtype)
    table = P.gather_param(w.table, w.specs["table"], w.table.dtype, par)
    v_loc = table.shape[0]
    local = ids - P.axis_index(par.mp, par) * v_loc
    hit = (local >= 0) & (local < v_loc)
    rows = F.embedding(local.clamp(0, v_loc - 1), table).to(dtype)
    partial = torch.where(hit[..., None], rows, torch.zeros((), dtype=dtype,
                                                            device=ids.device))
    if not sp:
        return P.psum(partial, par.mp_axes, par)
    return P.reduce_scatter(partial, par.mp_axes, 1, par)


# ---------------------------------------------------------------------------
# Cross-entropy — TP mode
# ---------------------------------------------------------------------------


def ce_loss_tp(x, labels, w: Params, cfg: ModelConfig, par: Par = ONE):
    """TP-mode cross-entropy: x (B, S, d) final-norm hidden, labels (B, S).
    Returns (Σ per-token NLL (float32 scalar), token count), the
    reference's pair. One :func:`~repro_torch.kernels.fused_ce.ops.fused_ce`
    call over the flattened (B·S, d) hidden against the head cast to the
    compute dtype; its backward takes the reference's 256-token chunks. In
    bfloat16 the logits are rounded to bfloat16 before the softmax, as the
    reference's ``(xi @ head).astype(float32)`` of a bf16 dot does.

    Under a sharded ``par`` with mp > 1 model shards x is replicated over
    ``model`` (no gather: the reference's ``ce_loss_tp``) and the head is
    this rank's (d, V/mp) vocabulary block: the rows laid out in the
    reference's chunks of c = min(S, 256) positions (chunk j: every batch
    row's c tokens), then one
    :func:`~repro_torch.kernels.fused_ce.ops.fused_ce_shard` call, whose
    (lse, target) are merged over ``model`` and whose backward takes one
    chunk's B·c rows at a time; x enters through
    :func:`~repro_torch.distributed.par.tp_entry`. With one model shard it
    is the single-device loss on the head gathered over its fsdp axes."""
    b, s, d = x.shape
    head = (w.head.to(x.dtype) if par.mesh is None
            else P.gather_param(w.head, w.specs["head"], x.dtype, par))
    round_logits = x.dtype == torch.bfloat16
    if par.mp_size == 1:
        nll = ce_ops.fused_ce(x.reshape(b * s, d), head, labels.reshape(b * s),
                              round_logits=round_logits)
        return nll.sum(), b * s
    c = min(s, ce_ops.BWD_CHUNK)
    while s % c:
        c //= 2
    n = s // c
    rows = (P.tp_entry(x, par).reshape(b, n, c, d).transpose(0, 1)
            .reshape(n * b * c, d))
    lab = labels.reshape(b, n, c).transpose(0, 1).reshape(n * b * c)
    v0 = P.axis_index(par.mp, par) * head.shape[1]
    nll = ce_ops.fused_ce_shard(rows, head, lab - v0,
                                par.mesh.group(par.mp_axes),
                                round_logits=round_logits, chunk=b * c)
    return nll.sum(), b * s


# ---------------------------------------------------------------------------
# Cross-entropy — SP mode
# ---------------------------------------------------------------------------


def ce_loss_sp(x, labels, w: Params, cfg: ModelConfig, par: Par = ONE):
    """SP-mode cross-entropy (the reference's ``ce_loss_sp``): x (B, S_loc,
    d) final-norm hidden, labels (B, S). Returns (Σ per-token NLL (float32
    scalar), token count), both replicated over ``model``.

    With one model shard (one device, or a mesh whose ``model`` axis is 1)
    this is the single-device loss below, on the head gathered over its
    fsdp axes. With several it is :func:`_ce_loss_vocab_parallel`.

    The reference scans over sequence chunks of c = min(S, 256) tokens
    (its default chunk, ``fused_ce``'s ``BWD_CHUNK``), halved until c
    divides S, each chunk's (B, c) rows one
    checkpointed step. Here the hidden is laid out as (S/c, B, c, d), so
    that chunk j's rows are consecutive, and goes through one
    :func:`~repro_torch.kernels.fused_ce.ops.fused_ce` call whose backward
    takes B·c rows a chunk: the reference's chunks, in its order. In
    bfloat16 the logits are rounded to bfloat16 before the softmax, as in
    :func:`ce_loss_tp`."""
    if par.mp_size > 1:
        return _ce_loss_vocab_parallel(x, labels, w, par)
    b, s, d = x.shape
    c = min(s, ce_ops.BWD_CHUNK)
    while s % c:
        c //= 2
    n = s // c
    rows = x.reshape(b, n, c, d).transpose(0, 1).reshape(n * b * c, d)
    lab = labels.reshape(b, n, c).transpose(0, 1).reshape(n * b * c)
    head = P.gather_param(w.head, w.specs["head"], x.dtype, par)
    nll = ce_ops.fused_ce(rows, head, lab,
                          round_logits=x.dtype == torch.bfloat16,
                          chunk=b * c)
    return nll.sum(), b * s


def _ce_loss_vocab_parallel(x, labels, w: Params, par: Par):
    """The reference's ``ce_loss_sp`` over mp > 1 model shards: x (B,
    S_loc, d) is this rank's sequence block, the head (d, V/mp) its
    vocabulary block (gathered over its fsdp axes).

    The hidden is all-gathered over ``model`` (the SP exit; its backward
    reduce-scatters dx back over the sequence) and laid out in the
    reference's chunks: chunk j of c = 256/mp local tokens (halved until it
    divides S_loc) holds, for each batch row, every shard's c tokens, so
    that each backward chunk is the reference's gathered chunk. Then one
    :func:`~repro_torch.kernels.fused_ce.ops.fused_ce_shard` call: the
    kernel's (lse, target) of these rows against this vocabulary block,
    merged over ``model`` into the whole vocabulary's, and the backward
    on this block's columns."""
    b, s_loc, d = x.shape
    mp = par.mp_size
    c = max(1, min(s_loc, ce_ops.BWD_CHUNK // mp))
    while s_loc % c:
        c //= 2
    n = s_loc // c
    head = P.gather_param(w.head, w.specs["head"], x.dtype, par)
    xg = P.all_gather(x, par.mp_axes, 1, par)  # (B, mp·S_loc, d)
    rows = (xg.reshape(b, mp, n, c, d).permute(2, 0, 1, 3, 4)
            .reshape(n * b * mp * c, d))
    lab = labels.reshape(b, mp, n, c).permute(2, 0, 1, 3).reshape(-1)
    v0 = P.axis_index(par.mp, par) * head.shape[1]
    nll = ce_ops.fused_ce_shard(rows, head, lab - v0,
                                par.mesh.group(par.mp_axes),
                                round_logits=x.dtype == torch.bfloat16,
                                chunk=b * mp * c)
    return nll.sum(), b * s_loc * mp
