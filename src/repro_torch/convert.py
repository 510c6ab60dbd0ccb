"""Carry state from the JAX package into the port, as plain numpy arrays.

The caller hands over numpy arrays (``jax.device_get`` of the reference's
arrays, and ``jax.random.key_data`` of its keys); nothing here touches a jax
object. Every FlyMC function here adds the port's leading chain axis unless
the arrays already carry one (``batched=True``). :func:`lm_params` turns the
reference's LM parameter tree into the port's modules. The parity tests use
these to start both packages from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bounds import CollapsedStats, GLMData
from repro_torch.core.brightness import BrightState
from repro_torch.core.flymc import FlyMCState
from repro_torch.core.numerics import M32
from repro_torch.core.samplers import SamplerState
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Params
from repro_torch.models.transformer import LM


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def glm_data(x, t, xi, device="cuda") -> GLMData:
    """GLMData from numpy; integer labels (softmax class ids) become int64."""
    dev = resolve_device(device)
    t = np.asarray(t)
    t_dtype = torch.int64 if np.issubdtype(t.dtype, np.integer) else torch.float32
    return GLMData(_t(x, dev, torch.float32), _t(t, dev, t_dtype),
                   _t(xi, dev, torch.float32))


def collapsed_stats(q_mat, q, c, device="cuda") -> CollapsedStats:
    dev = resolve_device(device)
    return CollapsedStats(*(_t(a, dev, torch.float32) for a in (q_mat, q, c)))


def theta(th, device="cuda", batched: bool = False) -> torch.Tensor:
    a = _t(th, resolve_device(device), torch.float32)
    return a if batched else a[None]


def key_words(words, device="cuda", batched: bool = False) -> torch.Tensor:
    """Raw key words (uint32 or int32 bit patterns, last axis 2) → a key."""
    w = np.asarray(words).astype(np.int64) & M32
    k = _t(w, resolve_device(device), torch.int64)
    return k if batched else k[None]


def flymc_state(*, theta, lp, grad, aux, arr, tab, num, delta_full, log_step,
                rng, iteration, device="cuda", batched: bool = False) -> FlyMCState:
    """A whole FlyMCState from the reference state's numpy leaves.

    ``rng`` is the key's raw words (``jax.random.key_data``). Without
    ``batched``, each leaf is one chain's and gains a leading axis of 1.
    """
    dev = resolve_device(device)
    add = (lambda a: a) if batched else (lambda a: a[None])
    f32 = lambda a: add(_t(a, dev, torch.float32))
    i32 = lambda a: add(_t(a, dev, torch.int32))
    i64 = lambda a: add(_t(a, dev, torch.int64))
    return FlyMCState(
        sampler=SamplerState(f32(theta), f32(lp), f32(grad), f32(aux)),
        bright=BrightState(i32(arr), i32(tab), i64(num)),
        delta_full=f32(delta_full),
        log_step=f32(log_step),
        rng=key_words(rng, dev, batched),
        iteration=i64(iteration),
    )


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def per_layer(tree: dict, cfg: ModelConfig) -> list[dict]:
    """The reference's per-layer subtrees in layer order.

    The reference stacks each pattern slot's leaves over layer groups
    (``tree["blocks"]["slot{s}"]``, leading axis = group) and keeps the
    remainder layers as ``tree["extra{j}"]``; layer ``i < P·n_groups`` is
    group ``i // P`` of slot ``i % P``. Works for parameter and cache trees.
    """
    p = len(cfg.block_pattern)
    n_groups, rem = divmod(cfg.n_layers, p)
    layers = []
    for i in range(n_groups * p):
        g, s = divmod(i, p)
        layers.append(_tree_map(lambda a: a[g], tree["blocks"][f"slot{s}"]))
    layers.extend(tree[f"extra{j}"] for j in range(rem))
    return layers


@torch.no_grad()
def _load(mod: Params, leaves: dict) -> None:
    if set(leaves) != set(mod.defs):
        raise ValueError(f"weights {sorted(leaves)} != {sorted(mod.defs)}")
    for name in mod.defs:
        a = np.asarray(leaves[name])
        p = getattr(mod, name)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


def lm_params(params_np: dict, cfg: ModelConfig, device="cuda",
              dtype=torch.float32) -> LM:
    """The reference's ``init_model`` parameter tree (numpy leaves) as the
    port's :class:`~repro_torch.models.transformer.LM`. The reference's
    attention sublayer ``attn`` is the block's ``mix`` here."""
    model = LM(cfg, device, dtype)
    _load(model.embed, params_np["embed"])
    _load(model.final_norm, params_np["final_norm"])
    for blk, tree in zip(model.blocks, per_layer(params_np, cfg)):
        mix = "attn" if blk.kind == "attn" else "mix"
        for name, src in (("ln1", "ln1"), ("mix", mix), ("ln2", "ln2"),
                          ("ffn", "ffn")):
            _load(getattr(blk, name), tree[src])
    return model
