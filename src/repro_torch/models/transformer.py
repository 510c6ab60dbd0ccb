"""Transformer assembly for the LM paths: modules, init, forward, and the
training step (loss, global gradient norm, clip, AdamW).

The port's counterpart of :mod:`repro.models.transformer` on one device
for the TP-mode (recurrence) archs, recurrentgemma and rwkv6, and the
SP-mode dense decoders, llama3.2, qwen2, stablelm and qwen1.5. A model is an
:class:`LM` module: the embedding (table and untied head), one
:class:`Block` per layer in layer order, and the final norm. The reference
stacks each pattern slot's weights over layer groups and scans over the
groups, unrolling the remainder (recurrentgemma's 38 = 12×3 + 2); here the
group loop is a plain Python loop over ``LM.blocks``, whose layer ``i`` is
group ``i // P``, slot ``i % P`` for the first ``P·n_groups`` layers and
``extra{i - P·n_groups}`` after them (:func:`repro_torch.convert.per_layer`
maps the reference's tree onto it).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import (
    _MISSING,
    ModelConfig,
    check_supported,
    check_trainable,
    layer_kinds,
)
from repro_torch.models.params import Params, init_params
from repro_torch.optim import AdamWState, adamw_init, adamw_update, warmup_cosine


def _slot_defs(cfg: ModelConfig, kind: str) -> dict[str, dict]:
    """Weight declarations of one block, by sublayer (the reference's
    ``_slot_defs`` for the ``attn`` (SP or TP mode), ``rglru`` and ``rwkv``
    kinds). An RWKV block has no ``ffn``: its channel mix is in ``mix``."""
    d = cfg.d_model
    if kind == "rwkv":
        return {"ln1": L.norm_defs(d), "ln2": L.norm_defs(d),
                "mix": L.rwkv_defs(cfg)}
    if kind == "attn":
        mix = L.attn_defs(cfg)
    elif kind == "rglru":
        mix = L.rglru_defs(cfg)
    else:
        raise ValueError(kind)
    return {"ln1": L.norm_defs(d), "mix": mix, "ln2": L.norm_defs(d),
            "ffn": L.mlp_defs(cfg)}


class Block(nn.Module):
    """One layer: norm → mixer (local attention or RG-LRU) → norm → MLP, or
    an RWKV block (norm → time mix → norm → channel mix). The attention
    mixer is named ``mix`` here; the reference calls it ``attn``."""

    def __init__(self, cfg: ModelConfig, kind: str, device, dtype):
        super().__init__()
        self.kind = kind
        for name, defs in _slot_defs(cfg, kind).items():
            self.add_module(name, Params(defs, device, dtype))


class LM(nn.Module):
    """A decoder-only LM: TP-mode blocks (recurrentgemma's and rwkv6's
    kinds) or SP-mode dense attention blocks."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = Params(L.embed_defs(cfg), dev, dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, dev, dtype) for kind in layer_kinds(cfg))
        self.final_norm = Params(L.norm_defs(cfg.d_model), dev, dtype)


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


def _block_fwd(x, blk: Block, cfg: ModelConfig, capture: bool = False):
    """One block. x: (B, S, d). Returns (x, cache): the layer's contribution
    to the serving cache when ``capture`` (prefill), else {}."""
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
    h = L.apply_norm(x, blk.ln2, dtype, cfg.norm)
    return x + L.mlp_tp(h, blk.ffn, cfg.mlp), cache


def forward_hidden(model: LM, tokens, dtype=torch.bfloat16,
                   capture: bool = False):
    """Token ids (B, S) → final-norm hidden states (B, S, d); with
    ``capture`` also the per-layer cache contributions, in layer order."""
    cfg = model.cfg
    x = L.embed_tokens(tokens, model.embed, dtype)
    captured = []
    for blk in model.blocks:
        x, cap = _block_fwd(x, blk, cfg, capture=capture)
        captured.append(cap)
    x = L.apply_norm(x, model.final_norm, dtype, cfg.norm)
    if capture:
        return x, captured
    return x


# ---------------------------------------------------------------------------
# Loss and train step
# ---------------------------------------------------------------------------


def loss_fn(model: LM, batch, dtype=torch.bfloat16):
    """Mean next-token NLL over ``batch`` ({"tokens", "labels"}, each (B, S)
    int) and its metrics {"loss", "nll"}: the reference's ``loss_fn`` on one
    device with ``remat=False`` (untied head, no MoE balance term)."""
    h = forward_hidden(model, batch["tokens"], dtype)
    nll_sum, count = L.ce_loss_tp(h, batch["labels"], model.embed, model.cfg)
    loss = nll_sum / count
    return loss, {"loss": loss, "nll": loss}


def global_grad_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over every gradient of Σ g²), float32 (on one device no leaf
    is replicated, so the reference's replica divisor is 1)."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in grads.values()]
    return torch.stack(sq).sum().sqrt()


def init_opt(model: LM) -> AdamWState:
    """Zero float32 AdamW moments for every parameter of ``model``."""
    return adamw_init(dict(model.named_parameters()))


def make_train_step(cfg: ModelConfig, dtype=torch.bfloat16,
                    clip_norm: float = 1.0, peak_lr: float = 3e-4,
                    warmup_steps: int = 200, remat: bool = False):
    """``train_step(model, opt, batch) → metrics``: the reference's step on
    one device. Gradients of :func:`loss_fn` in ``dtype`` (master weights
    stay in the model's dtype), the global norm clipped to ``clip_norm``
    (fused into AdamW as a gradient scale), the learning rate from
    :func:`~repro_torch.optim.warmup_cosine` at the optimizer's step, then
    AdamW in place on the model and ``opt``. Metrics: loss, nll, grad_norm
    and lr, as tensors. The model's parameters must require gradients
    (``model.requires_grad_(True)``)."""
    if remat:
        raise NotImplementedError(f"{cfg.name}: {_MISSING['remat']}")
    check_supported(cfg)

    def train_step(model: LM, opt: AdamWState, batch) -> dict:
        check_trainable(cfg, model.final_norm.scale.device)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch, dtype)
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
