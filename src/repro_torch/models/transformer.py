"""Transformer assembly for the LM paths: modules, init, forward, and the
training step (loss, global gradient norm, clip, AdamW).

The port's counterpart of :mod:`repro.models.transformer` on one device
for every family: the TP-mode (recurrence) archs, recurrentgemma and rwkv6,
and the SP-mode ones, the dense decoders (llama3.2, qwen2, stablelm,
qwen1.5), the MoE (mixtral, arctic), the encoder-decoder (whisper) and the
VLM (llava). A model is an :class:`LM` module: the embedding (table and
untied head), one :class:`Block` per layer in layer order, the final norm,
and for whisper the encoder's blocks and norm. The reference
stacks each pattern slot's weights over layer groups and scans over the
groups, unrolling the remainder (recurrentgemma's 38 = 12×3 + 2); here the
group loop is a plain Python loop over ``LM.blocks``, whose layer ``i`` is
group ``i // P``, slot ``i % P`` for the first ``P·n_groups`` layers and
``extra{i - P·n_groups}`` after them (:func:`repro_torch.convert.per_layer`
maps the reference's tree onto it).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import (
    ModelConfig,
    check_supported,
    check_trainable,
    layer_kinds,
)
from repro_torch.models.params import Params, init_params
from repro_torch.optim import AdamWState, adamw_init, adamw_update, warmup_cosine


def _slot_defs(cfg: ModelConfig, kind: str,
               cross: bool = False) -> dict[str, dict]:
    """Weight declarations of one block, by sublayer (the reference's
    ``_slot_defs`` for the ``attn`` (SP or TP mode), ``rglru`` and ``rwkv``
    kinds). An RWKV block has no ``ffn``: its channel mix is in ``mix``. An
    attention block's ``ffn`` is the MoE where ``cfg.moe`` is set; with
    ``cross`` (whisper's decoder) it also has ``ln_cross`` and ``cross``."""
    d = cfg.d_model
    if kind == "rwkv":
        return {"ln1": L.norm_defs(d), "ln2": L.norm_defs(d),
                "mix": L.rwkv_defs(cfg)}
    if kind == "attn":
        defs = {"ln1": L.norm_defs(d), "mix": L.attn_defs(cfg),
                "ln2": L.norm_defs(d),
                "ffn": L.moe_defs(cfg) if cfg.moe else L.mlp_defs(cfg)}
        if cross:
            defs.update(ln_cross=L.norm_defs(d),
                        cross=L.attn_defs(cfg, cross=True))
        return defs
    if kind == "rglru":
        return {"ln1": L.norm_defs(d), "mix": L.rglru_defs(cfg),
                "ln2": L.norm_defs(d), "ffn": L.mlp_defs(cfg)}
    raise ValueError(kind)


class Block(nn.Module):
    """One layer: norm → mixer (attention or RG-LRU) → [norm →
    cross-attention] → norm → MLP or MoE, or an RWKV block (norm → time mix
    → norm → channel mix). The attention mixer is named ``mix`` here; the
    reference calls it ``attn``."""

    def __init__(self, cfg: ModelConfig, kind: str, device, dtype,
                 cross: bool = False):
        super().__init__()
        self.kind = kind
        for name, defs in _slot_defs(cfg, kind, cross).items():
            self.add_module(name, Params(defs, device, dtype))


class LM(nn.Module):
    """An LM of any family: TP-mode blocks (recurrentgemma's and rwkv6's
    kinds) or SP-mode attention blocks (dense, MoE, VLM), and for the
    encoder-decoder family (whisper) the decoder's blocks with
    cross-attention, ``enc_blocks`` (``encoder_layers`` attention blocks
    with a dense MLP) and ``enc_norm``."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        cross = cfg.family == "encdec"
        self.embed = Params(L.embed_defs(cfg), dev, dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, dev, dtype, cross) for kind in layer_kinds(cfg))
        self.final_norm = Params(L.norm_defs(cfg.d_model), dev, dtype)
        if cross:
            enc_cfg = dataclasses.replace(cfg, moe=None)
            self.enc_blocks = nn.ModuleList(
                Block(enc_cfg, "attn", dev, dtype)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = Params(L.norm_defs(cfg.d_model), dev, dtype)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               dtype=torch.float32) -> LM:
    """An :class:`LM` with weights drawn by the reference's init rule from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (normals in
    float32, then cast to ``dtype``: a bfloat16 model is the float32 model
    of the same seed, rounded)."""
    dev = resolve_device(device)
    model = LM(cfg, dev, dtype)
    init_params(model, torch.Generator(device=dev).manual_seed(seed))
    return model


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


def _block_fwd(x, blk: Block, cfg: ModelConfig, capture: bool = False,
               enc=None, aux: list | None = None):
    """One block. x: (B, S, d); ``enc`` the encoder's output that a
    cross-attention block attends. Returns (x, cache): the layer's
    contribution to the serving cache when ``capture`` (prefill), else {}.
    An MoE block appends its {lb_loss, drop_frac} to ``aux``, a list the
    caller makes afresh for each run (see :func:`_group_fwd`)."""
    if blk.kind == "rwkv":
        # Time-chunked whole block; the state and shifts carry across chunks.
        return L.rwkv_block_chunked(x, blk, cfg, capture=capture)
    dtype = x.dtype
    cache = {}
    h = L.apply_norm(x, blk.ln1, dtype, cfg.norm)
    if blk.kind == "attn":
        a = L.attn_tp(h, blk.mix, cfg,
                      window=cfg.swa_window or cfg.local_attn_window,
                      chunk=512 if cfg.parallel_mode == "sp" else 1024,
                      return_kv=capture)
        if capture:
            a, cache["kv_full"] = a
    elif blk.kind == "rglru":
        a = L.rglru_mix(h, blk.mix, cfg, return_state=capture)
        if capture:
            a, (cache["state"], cache["conv"]) = a
    else:
        raise ValueError(blk.kind)
    x = x + a
    if hasattr(blk, "cross") and enc is not None:
        h = L.apply_norm(x, blk.ln_cross, dtype, cfg.norm)
        c = L.attn_sp(h, blk.cross, cfg, causal=False, kv_source=enc,
                      use_rope=False, return_kv=capture)
        if capture:
            c, cache["cross_kv_full"] = c
        x = x + c
    h = L.apply_norm(x, blk.ln2, dtype, cfg.norm)
    if blk.kind == "attn" and cfg.moe is not None:
        y, moe_aux = L.moe_sp(h, blk.ffn, cfg)
        if aux is not None:
            aux.append(moe_aux)
    else:
        y = L.mlp_tp(h, blk.ffn, cfg.mlp)
    return x + y, cache


def _encoder_block_fwd(x, blk: Block, cfg: ModelConfig):
    """One encoder block (whisper): non-causal self-attention with RoPE,
    then the dense MLP."""
    dtype = x.dtype
    h = L.apply_norm(x, blk.ln1, dtype, cfg.norm)
    x = x + L.attn_sp(h, blk.mix, cfg, causal=False)
    h = L.apply_norm(x, blk.ln2, dtype, cfg.norm)
    return x + L.mlp_sp(h, blk.ffn, cfg)


def _checkpoint(fn, *args):
    """``fn(*args)`` under activation checkpointing (the reference's
    ``jax.checkpoint``): the forward keeps only ``args``, and the backward
    runs ``fn`` again. Non-reentrant, so checkpoints nest and the backward
    graph is the one the first run recorded: the same values and the same
    gradients, accumulated in the same order."""
    return checkpoint(fn, *args, use_reentrant=False)


def encode(model: LM, frames, dtype=torch.bfloat16, remat: bool = False):
    """The encoder over stub frame embeddings (B, S_enc, d): its blocks
    (with ``remat``, each under its own checkpoint), then ``enc_norm``."""
    cfg = model.cfg
    enc = frames.to(dtype)
    for blk in model.enc_blocks:
        if remat:
            enc = _checkpoint(_encoder_block_fwd, enc, blk, cfg)
        else:
            enc = _encoder_block_fwd(enc, blk, cfg)
    return L.apply_norm(enc, model.enc_norm, dtype, cfg.norm)


def _group_fwd(x, blocks, cfg: ModelConfig, enc, capture: bool = False):
    """One layer group (``len(cfg.block_pattern)`` blocks). Returns (x, the
    group's MoE {lb_loss, drop_frac}, each the mean over its MoE blocks, or
    None; the blocks' cache contributions). The aux is returned, not
    appended to a caller's list: under a checkpoint the backward runs this
    again, and an append would count the group twice."""
    auxes, caches = [], []
    for blk in blocks:
        x, cache = _block_fwd(x, blk, cfg, capture=capture, enc=enc,
                              aux=auxes)
        caches.append(cache)
    aux = ({n: torch.stack([a[n] for a in auxes]).mean() for n in auxes[0]}
           if auxes else None)
    return x, aux, caches


def _groups_fwd(x, groups, cfg: ModelConfig, enc, remat: bool,
                capture: bool = False):
    """``groups`` in order, each under its own checkpoint with ``remat``.
    Returns (x, the groups' aux in order, the blocks' cache
    contributions in layer order)."""
    auxes, caches = [], []
    for blocks in groups:
        if remat:
            x, aux, cache = _checkpoint(_group_fwd, x, blocks, cfg, enc)
        else:
            x, aux, cache = _group_fwd(x, blocks, cfg, enc, capture)
        auxes.append(aux)
        caches += cache
    return x, auxes, caches


def _inner_groups(n_groups: int) -> int:
    """Groups an outer checkpoint holds in the reference's two-level (√L)
    remat: the largest divisor of ``n_groups`` in [2, √n_groups] from 8
    groups up, else 1 (one level)."""
    if n_groups < 8:
        return 1
    return max((f for f in range(2, math.isqrt(n_groups) + 1)
                if n_groups % f == 0), default=1)


def forward_hidden(model: LM, tokens, dtype=torch.bfloat16,
                   capture: bool = False, frames=None, patches=None,
                   aux: bool = False, remat: bool = False):
    """Token ids (B, S) (+ the stub frontends' inputs) → final-norm hidden
    states (B, S, d); with ``capture`` also the per-layer cache
    contributions, in layer order; with ``aux`` then also the MoE's
    {lb_loss, drop_frac}: as the reference, each group's mean over its
    blocks, then the mean over groups (zeros without MoE; the remainder
    layers' are not counted).

    VLM (llava): ``patches`` (B, P, d) overwrite the token embeddings at
    positions [0, P) (``cfg.patch_positions``). Encoder-decoder (whisper):
    ``frames`` (B, S_enc, d) run through the encoder, and every decoder
    block cross-attends to its output.

    ``remat`` (training only): the reference's activation checkpointing.
    Each group of ``len(cfg.block_pattern)`` blocks runs under a
    checkpoint, the remainder layers (``extra*``) outside any; from 8
    groups up the groups are nested in outer checkpoints of
    :func:`_inner_groups` groups each (llama3.2-3b's 28: 7 × 4), so that
    only the outer boundaries' inputs stay live through the forward; each
    encoder block has its own. The values and gradients are those without
    it."""
    cfg = model.cfg
    if remat and capture:
        raise ValueError("remat is for training; a prefill captures its "
                         "cache without it")
    x = L.embed_tokens(tokens, model.embed, dtype)
    if cfg.family == "vlm":
        n = min(cfg.patch_positions, x.shape[1])
        x = torch.cat([patches[:, :n].to(dtype), x[:, n:]], 1)
    enc = (encode(model, frames, dtype, remat)
           if cfg.family == "encdec" else None)
    p = len(cfg.block_pattern)
    n_groups = cfg.n_layers // p
    blocks = list(model.blocks)
    groups = [blocks[g * p:(g + 1) * p] for g in range(n_groups)]
    inner = _inner_groups(n_groups) if remat else 1
    if inner > 1:
        auxes, captured = [], []
        for o in range(0, n_groups, inner):
            x, outs, _ = _checkpoint(_groups_fwd, x, groups[o:o + inner],
                                     cfg, enc, True)
            auxes += outs
    else:
        x, auxes, captured = _groups_fwd(x, groups, cfg, enc, remat, capture)
    for blk in blocks[n_groups * p:]:
        x, cap = _block_fwd(x, blk, cfg, capture=capture, enc=enc)
        captured.append(cap)
    x = L.apply_norm(x, model.final_norm, dtype, cfg.norm)
    out = (x, captured) if capture else (x,)
    if aux:
        auxes = [a for a in auxes if a is not None]
        zero = torch.zeros((), device=x.device)
        out += ({n: torch.stack([a[n] for a in auxes]).mean() if auxes
                 else zero for n in ("lb_loss", "drop_frac")},)
    return out if len(out) > 1 else x


# ---------------------------------------------------------------------------
# Loss and train step
# ---------------------------------------------------------------------------


LB_COEF = 0.01  # the MoE balance term's weight: the reference's default


def loss_fn(model: LM, batch, dtype=torch.bfloat16, remat: bool = False):
    """The reference's ``loss_fn`` on one device: the mean next-token NLL
    over ``batch`` ({"tokens", "labels"}, each (B, S) int, and whisper's
    "frames" (B, S_enc, d) or llava's "patches" (B, P, d)), through
    :func:`~repro_torch.models.layers.ce_loss_sp` in SP mode and
    :func:`~repro_torch.models.layers.ce_loss_tp` in TP mode, plus
    ``LB_COEF``·lb_loss where the config has an MoE. Returns (loss,
    metrics {"loss", "nll", "lb_loss", "drop_frac"}); ``remat`` as in
    :func:`forward_hidden`. The head is untied."""
    cfg = model.cfg
    h, aux = forward_hidden(model, batch["tokens"], dtype,
                            frames=batch.get("frames"),
                            patches=batch.get("patches"), aux=True,
                            remat=remat)
    ce = L.ce_loss_sp if cfg.parallel_mode == "sp" else L.ce_loss_tp
    nll_sum, count = ce(h, batch["labels"], model.embed, cfg)
    nll = nll_sum / count
    loss = nll + LB_COEF * aux["lb_loss"] if cfg.moe is not None else nll
    return loss, {"loss": loss, "nll": nll, **aux}


def global_grad_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over every gradient of Σ g²), float32 (on one device no leaf
    is replicated, so the reference's replica divisor is 1)."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in grads.values()]
    return torch.stack(sq).sum().sqrt()


def init_opt(model: LM) -> AdamWState:
    """Zero AdamW moments in the config's ``opt_dtype`` for every parameter
    of ``model``."""
    return adamw_init(dict(model.named_parameters()),
                      getattr(torch, model.cfg.opt_dtype))


def make_train_step(cfg: ModelConfig, dtype=torch.bfloat16,
                    clip_norm: float = 1.0, peak_lr: float = 3e-4,
                    warmup_steps: int = 200, remat: bool = False):
    """``train_step(model, opt, batch) → metrics``: the reference's step on
    one device. Gradients of :func:`loss_fn` in ``dtype`` (master weights
    stay in the model's dtype), the global norm clipped to ``clip_norm``
    (fused into AdamW as a gradient scale), the learning rate from
    :func:`~repro_torch.optim.warmup_cosine` at the optimizer's step, then
    AdamW in place on the model and ``opt``. ``remat``: activation
    checkpointing as in :func:`forward_hidden` (the reference's default;
    the same numbers, less memory, one more forward). Metrics: loss, nll,
    lb_loss, drop_frac, grad_norm and lr, as tensors. The model's
    parameters must require gradients (``model.requires_grad_(True)``)."""
    check_supported(cfg)

    def train_step(model: LM, opt: AdamWState, batch) -> dict:
        check_trainable(cfg, model.final_norm.scale.device)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch, dtype, remat)
            loss.backward()
        grads = {}
        for name, p in params.items():
            if p.grad is None:
                raise ValueError(f"parameter {name} got no gradient: call "
                                 "model.requires_grad_(True) first")
            grads[name] = p.grad
        gnorm = global_grad_norm(grads)
        scale = torch.clamp(clip_norm / (gnorm + 1e-6), max=1.0)
        lr = warmup_cosine(opt.step, peak_lr=peak_lr,
                           warmup_steps=warmup_steps)
        adamw_update(params, grads, opt, lr, grad_scale=scale)
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return {**metrics, "grad_norm": gnorm, "lr": lr}

    return train_step
