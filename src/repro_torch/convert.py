"""Carry state from the JAX package into the port, as plain numpy arrays.

The caller hands over numpy arrays (``jax.device_get`` of the reference's
arrays, and ``jax.random.key_data`` of its keys); nothing here touches a jax
object. Every FlyMC function here adds the port's leading chain axis unless
the arrays already carry one (``batched=True``). :func:`lm_params` turns the
reference's LM parameter tree into the port's modules (a gradient tree has
the same structure, so it converts the same way), and :func:`adamw_state`
its AdamW state into the port's, and :func:`lm_cache` its serving cache
(gathered from a sharded run) into a rank's cache shard. The parity tests
use these to start both packages from the same state. :func:`glm_shard`
and :func:`glm_lanes` carry a dataset into a rank's shard and datasets
into a lane stack.
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
from repro_torch.distributed.par import Par, local_slice
from repro_torch.launch.mesh import make_par
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Params
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamWState


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def glm_data(x, t, xi, device="cuda") -> GLMData:
    """GLMData from numpy; integer labels (softmax class ids) become int64."""
    dev = resolve_device(device)
    t = np.asarray(t)
    t_dtype = torch.int64 if np.issubdtype(t.dtype, np.integer) else torch.float32
    return GLMData(_t(x, dev, torch.float32), _t(t, dev, t_dtype),
                   _t(xi, dev, torch.float32))


def glm_shard(x, t, xi, world: int, rank: int, device="cuda") -> GLMData:
    """Rank ``rank``'s shard of a whole dataset given as numpy (a JAX
    ``GLMData``'s arrays, with its tuned ξ): rows ``[r·N/W, (r+1)·N/W)``,
    as :func:`repro_torch.distributed.flymc_dist.shard_data` cuts them and
    as the reference's data-sharded mesh places them."""
    from repro_torch.distributed.flymc_dist import shard_rows

    rows = shard_rows(np.shape(x)[0], world, rank)
    return glm_data(np.asarray(x)[rows], np.asarray(t)[rows],
                    np.asarray(xi)[rows], device=device)


def glm_lanes(datasets, device="cuda") -> GLMData:
    """A lane stack of datasets (leaves ``(L, N, ...)``), each an ``(x, t,
    xi)`` of numpy arrays of one shape: the ``data`` a ``"vmap"`` group
    steps its lanes on."""
    lanes = [glm_data(x, t, xi, device=device) for x, t, xi in datasets]
    return GLMData(*(torch.stack(leaves) for leaves in zip(*lanes)))


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
def _load(mod: Params, leaves: dict, par) -> None:
    groups = {n for n, _ in mod.named_children()}  # nested Params
    if set(leaves) != set(mod.defs) | groups:
        raise ValueError(f"weights {sorted(leaves)} != "
                         f"{sorted(set(mod.defs) | groups)}")
    for name in groups:
        _load(getattr(mod, name), leaves[name], par)
    for name in mod.defs:
        a = np.asarray(leaves[name])
        spec = mod.specs[name]
        if a.shape == spec.shape and spec.local_shape != spec.shape:
            a = local_slice(a, spec, par)  # this rank's shard
        p = getattr(mod, name)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


def lm_params(params_np: dict, cfg: ModelConfig, device="cuda",
              dtype=torch.float32, mesh=None,
              exclude_fsdp: tuple[str, ...] = (),
              serve_tp: bool = False) -> LM:
    """The reference's ``init_model`` parameter tree (numpy leaves) as the
    port's :class:`~repro_torch.models.transformer.LM`. The reference's
    attention sublayer ``attn`` is the block's ``mix`` here; an RWKV block
    has ``ln1``, ``ln2`` and ``mix`` (with the channel mix's ``cm_*``) and
    no ``ffn``. The dense decoders' leaves load by the same names: the
    QKV biases ``bq``/``bk``/``bv`` (qwen), swiglu's third matrix ``w3``,
    and each norm's ``scale`` (RMSNorm or layernorm alike); so do an MoE
    ``ffn``'s ``router``, ``w1``..``w3`` and ``dense`` group (arctic), a
    decoder block's ``ln_cross`` and ``cross`` (whisper), and the
    encoder's ``enc_blocks`` (stacked over ``encoder_layers``, each layer
    one of ``model.enc_blocks``) and ``enc_norm``.

    With ``mesh`` (this rank's bound mesh) the model is this rank's shards
    (placed as :func:`repro_torch.models.transformer.build_specs` places
    them, with ``exclude_fsdp``): each global leaf is cut to its slice (an
    expert matrix to its ff shard over ``model`` and its fsdp block, an
    encoder block's weights as a decoder block's).
    ``serve_tp``: the serving-resident layout (``exclude_fsdp`` then the
    mesh's data axes), whose attention has no QKV bias: the tree's
    ``bq``/``bk``/``bv`` are left out, as the reference's layout leaves
    them."""
    return _lm_params(params_np, cfg, device, dtype,
                      None if mesh is None else make_par(mesh), exclude_fsdp,
                      serve_tp)


_BIASES = ("bq", "bk", "bv")


def _lm_params(params_np, cfg, device, dtype, par, exclude_fsdp,
               serve_tp: bool = False) -> LM:
    model = LM(cfg, device, dtype, par, exclude_fsdp, serve_tp)
    _load(model.embed, params_np["embed"], model.par)
    _load(model.final_norm, params_np["final_norm"], model.par)
    blocks = list(zip(model.blocks, per_layer(params_np, cfg)))
    if cfg.family == "encdec":
        _load(model.enc_norm, params_np["enc_norm"], model.par)
        enc = params_np["enc_blocks"]  # stacked over encoder_layers
        blocks += [(blk, _tree_map(lambda a: a[i], enc))
                   for i, blk in enumerate(model.enc_blocks)]
    for blk, tree in blocks:
        src = {("attn" if (blk.kind, n) == ("attn", "mix") else n): n
               for n, _ in blk.named_children()}
        if set(tree) != set(src):
            raise ValueError(f"{blk.kind} block: sublayers {sorted(tree)} "
                             f"!= {sorted(src)}")
        for ref_name, name in src.items():
            leaves = tree[ref_name]
            if serve_tp and name == "mix":
                leaves = {k: v for k, v in leaves.items()
                          if k not in _BIASES}
            _load(getattr(blk, name), leaves, model.par)
    return model


def lm_cache(cache_np: dict, cfg: ModelConfig, seq_len: int, device="cuda",
             mesh=None, serve_tp: bool = False, batch_whole: bool = False,
             dtype=None) -> dict:
    """The reference's serving cache (numpy leaves: ``t``, each slot's
    rings, and whisper's cross K/V ``ck``/``cv``, stacked over layer
    groups, ``extra{j}``; a sharded run's outputs gathered to their
    logical arrays) as the port's cache: ``{"t": int, "layers": [...]}``
    in layer order. With ``mesh`` (this rank's bound mesh) each leaf is
    cut to the rank's shard (``ck``/``cv``: its rows and its S_enc/mp
    positions) as
    :func:`~repro_torch.models.serving.cache_pspecs` places it for
    ``seq_len`` and ``serve_tp`` (``batch_whole``: a batch that runs whole
    on every data rank). ``dtype``: the K/V dtype (default the leaves'
    own; bfloat16 leaves come as float32 arrays, exact); the recurrent
    states (RG-LRU, WKV) and shifts keep their own, float32.
    A TP-mode arch's RG-LRU state and history are cut to the rank's r/mp
    channels and its WKV state to its H/mp heads."""
    from repro_torch.launch.steps import strip_dp
    from repro_torch.models.serving import cache_pspecs

    dev = resolve_device(device)
    par = Par() if mesh is None else make_par(mesh)
    specs = cache_pspecs(cfg, seq_len, par, serve_tp)
    if batch_whole:
        specs = strip_dp(specs, par)
    layers = []
    for tree, spec in zip(per_layer(cache_np, cfg), specs["layers"]):
        out = {}
        for name, a in tree.items():
            a = np.asarray(a)
            if par.mesh is not None:
                a = local_slice(a, spec[name], par)
            dt = (torch.int32 if name == "pos"
                  else dtype if name in ("k", "v", "ck", "cv") else None)
            out[name] = _t(a, dev, dt)
        layers.append(out)
    return {"t": int(np.asarray(cache_np["t"])), "layers": layers}


def adamw_state(opt_np, model: LM) -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves: ``step``, and ``m`` and
    ``v`` trees shaped like the parameters) as the port's state for
    ``model``: moments keyed by ``model.named_parameters()`` names, on the
    model's device, in the config's ``opt_dtype`` as the reference keeps
    them (bfloat16 moments are exact in the float32 twin they pass
    through); a sharded model's moments are its shards of them."""
    dev = model.final_norm.scale.device
    dtype = getattr(torch, model.cfg.opt_dtype)

    def moments(tree):
        twin = _lm_params(tree, model.cfg, dev, torch.float32, model.par,
                          model.exclude_fsdp)
        return {n: p.detach().to(dtype) for n, p in twin.named_parameters()}

    m, v = moments(opt_np.m), moments(opt_np.v)
    if set(m) != {n for n, _ in model.named_parameters()}:
        raise ValueError("AdamW moments do not match the model's parameters")
    return AdamWState(_t(opt_np.step, dev, torch.int32), m, v)
