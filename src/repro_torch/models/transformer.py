"""Transformer assembly for the LM serving path: modules, init, forward.

The port's counterpart of :mod:`repro.models.transformer` for TP-mode
(recurrence) archs on one device. A model is an :class:`LM` module: the
embedding (table and untied head), one :class:`Block` per layer in layer
order, and the final norm. The reference stacks each pattern slot's weights
over layer groups and scans over the groups, unrolling the remainder
(recurrentgemma's 38 = 12×3 + 2); here the group loop is a plain Python loop
over ``LM.blocks``, whose layer ``i`` is group ``i // P``, slot ``i % P``
for the first ``P·n_groups`` layers and ``extra{i - P·n_groups}`` after them
(:func:`repro_torch.convert.per_layer` maps the reference's tree onto it).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported, layer_kinds
from repro_torch.models.params import Params, init_params


def _slot_defs(cfg: ModelConfig, kind: str) -> dict[str, dict]:
    """Weight declarations of one block, by sublayer (the reference's
    ``_slot_defs`` for the ``attn``-in-TP-mode and ``rglru`` kinds)."""
    d = cfg.d_model
    if kind == "attn":
        mix = L.attn_tp_defs(cfg)
    elif kind == "rglru":
        mix = L.rglru_defs(cfg)
    else:
        raise ValueError(kind)
    return {"ln1": L.norm_defs(d), "mix": mix, "ln2": L.norm_defs(d),
            "ffn": L.mlp_defs(cfg)}


class Block(nn.Module):
    """One layer: norm → mixer (local attention or RG-LRU) → norm → MLP.
    The attention mixer is named ``mix`` here; the reference calls it
    ``attn``."""

    def __init__(self, cfg: ModelConfig, kind: str, device, dtype):
        super().__init__()
        self.kind = kind
        for name, defs in _slot_defs(cfg, kind).items():
            self.add_module(name, Params(defs, device, dtype))


class LM(nn.Module):
    """A decoder-only LM of TP-mode blocks (recurrentgemma's kinds)."""

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
    dtype = x.dtype
    cache = {}
    h = L.apply_norm(x, blk.ln1, dtype)
    if blk.kind == "attn":
        a = L.attn_tp(h, blk.mix, cfg, window=cfg.local_attn_window,
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
    h = L.apply_norm(x, blk.ln2, dtype)
    return x + L.mlp_tp(h, blk.ffn), cache


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
    x = L.apply_norm(x, model.final_norm, dtype)
    if capture:
        return x, captured
    return x
