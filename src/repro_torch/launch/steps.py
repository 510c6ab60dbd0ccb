"""The sharded LM train, prefill and decode steps on a mesh of
``torch.distributed`` ranks.

Port of :mod:`repro.launch.steps`. The reference wraps each step in
``shard_map`` over a device mesh; here every rank is a process that runs
the same step on its shards (:mod:`repro_torch.distributed.par`) and its
part of the global batch, under the axis context of
:func:`repro_torch.launch.mesh.make_par`. :func:`batch_slice` is the rule
that cuts a global batch to a rank (the reference's ``batch_pspecs``:
rows over the data axes; tokens, labels and llava's patches whole over
``model``, where the embedding is vocab-parallel and the blocks
sequence-parallel; whisper's frames split over ``model`` along the
encoder's positions). Each function below returns the step, the rank's
specs and a function that builds the rank's model (and its optimizer
state or serving cache):

  * :func:`make_sharded_train_step`;
  * :func:`make_sharded_prefill`: the prompt's forward in the training
    layout, the rank's cache shard and its sequence block of the hidden;
  * :func:`make_sharded_decode`: one greedy step in the training layout
    (``fsdp``: ZeRO-3 gathers a step, the ring sequence-sharded over
    ``model``) or the serving-resident one (``tp``: bf16 weights split
    over ``model`` and replicated over the data axes, head-parallel
    attention over whole rings).

Every arch is sharded: the SP-mode ones (the dense decoders llama3.2,
qwen2, stablelm and qwen1.5, the MoE mixtral and arctic, the
encoder-decoder whisper, the VLM llava), whose blocks run on a sequence
block over ``model``, and the TP-mode ones (recurrentgemma, rwkv6), whose
stream is replicated over ``model`` and whose heads, RG-LRU channels, WKV
heads and ff columns are split over it. Tokens are whole over ``model``
in both modes.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.par import Par, PSpec
from repro_torch.launch.mesh import Mesh, make_par
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig


def batch_sharded(global_batch: int, par: Par) -> bool:
    """Whether a global batch splits over the data ranks (the reference's
    rule). One that does not (``long_500k``'s B = 1) runs whole on every
    data rank: :func:`strip_dp`."""
    return global_batch % max(par.dp_size, 1) == 0


def _block(v, dim: int, axes, par: Par):
    """This rank's block of ``v`` along ``dim`` over ``axes``."""
    n = v.shape[dim] // par.mesh.size_of(axes)
    return v.narrow(dim, par.mesh.index(axes) * n, n)


def batch_slice(batch: dict, par: Par, whole_if_unsplit: bool = False) -> dict:
    """This rank's part of a global batch ({"tokens", "labels"}, (B, S)
    each, whisper's "frames" (B, S_enc, d) or llava's "patches" (B, P, d),
    or a prompt's or a decode step's inputs), as the reference's
    ``batch_pspecs`` places it: the B / dp_size rows of its index over the
    data axes, every leaf whole over ``model`` but the frames, which are
    split there along the encoder's positions (S_enc/mp each: the encoder
    runs sequence-parallel). With ``whole_if_unsplit`` (the serving steps)
    a batch whose rows do not split over the data ranks is every rank's
    whole; the train step refuses it."""
    out = {}
    for k, v in batch.items():
        if par.dp and v.shape[0] % par.dp_size:
            if not whole_if_unsplit:
                raise ValueError(f"batch {k}: {v.shape[0]} rows do not "
                                 f"split over {par.dp_size} data ranks")
        elif par.dp:
            v = _block(v, 0, par.dp, par)
        if k == "frames" and par.mp:
            if v.shape[1] % par.mp_size:
                raise ValueError(f"frames: {v.shape[1]} positions do not "
                                 f"split over {par.mp_size} model ranks")
            v = _block(v, 1, par.mp_axes, par)
        out[k] = v
    return out


def strip_dp(specs, par: Par):
    """``specs`` (a tree of :class:`~repro_torch.distributed.par.PSpec`)
    with the data axes left whole: the placement of a batch that runs
    whole on every data rank (the reference's ``_strip_dp``)."""
    if isinstance(specs, PSpec):
        return specs.without(par.dp)
    if isinstance(specs, dict):
        return {k: strip_dp(v, par) for k, v in specs.items()}
    if isinstance(specs, list):
        return [strip_dp(v, par) for v in specs]
    return specs


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig,
                            dtype=torch.bfloat16, remat: bool = True,
                            compress_axes: tuple[str, ...] = (), **kw):
    """(step, specs, build) for ``cfg`` on ``mesh`` (bound: one process a
    rank). ``step(model, opt, batch[, err]) → metrics`` takes the GLOBAL
    batch (every rank the same; with whisper's frames or llava's patches)
    and runs the rank's part (:func:`batch_slice`); ``specs`` is
    name → WSpec of the rank's weights; ``build(seed=0, device="cuda",
    param_dtype=torch.float32)`` → (model, opt): the rank's shards of
    ``init_model(cfg, seed)`` with gradients on, and zero AdamW moments in
    the config's ``opt_dtype``. ``kw`` goes to
    :func:`~repro_torch.models.transformer.make_train_step` (``peak_lr``,
    ``warmup_steps``, ``clip_norm``)."""
    if shape.kind != "train":
        raise ValueError(f"{shape.name}: a {shape.kind} shape; its step is "
                         "make_sharded_prefill or make_sharded_decode")
    par = make_par(mesh)
    if not batch_sharded(shape.global_batch, par):
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {par.dp_size} data ranks")
    compress_axes = tuple(compress_axes)
    step = T.make_train_step(cfg, dtype, remat=remat,
                             compress_axes=compress_axes, **kw)
    specs = T.LM(cfg, "meta", par=par, exclude_fsdp=compress_axes).specs

    def sharded_step(model, opt, batch, err=None):
        return step(model, opt, batch_slice(batch, par), err)

    def build(seed: int = 0, device="cuda", param_dtype=torch.float32):
        model = T.init_model(cfg, seed, device, param_dtype, par=par,
                             exclude_fsdp=compress_axes)
        model.requires_grad_(True)
        return model, T.init_opt(model)

    return sharded_step, specs, build


def _serve_specs(cfg, par, shape, model_specs, serve_tp: bool) -> dict:
    """The rank's specs of a serving step: ``params`` (name → WSpec),
    ``cache`` (:func:`~repro_torch.models.serving.cache_pspecs`, the data
    axes stripped for a batch that does not split), ``tokens`` and the
    step's ``out`` (prefill: the hidden (B, S, d), sequence-sharded over
    ``model`` in SP mode, whole over it in TP mode; decode: the logits
    (B, 1, V), vocab-parallel), as PSpecs."""
    dp = par.dp if batch_sharded(shape.global_batch, par) else ()
    cache = SV.cache_pspecs(cfg, shape.seq_len, par, serve_tp)
    if not dp:
        cache = strip_dp(cache, par)
    seq = par.mp_axes if cfg.parallel_mode == "sp" else ()
    out = PSpec((dp, seq, ()) if shape.kind == "prefill"
                else (dp, (), par.mp_axes))
    return {"params": model_specs, "cache": cache,
            "tokens": PSpec((dp, ())), "out": out}


def make_sharded_prefill(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig,
                         dtype=torch.bfloat16):
    """(step, specs, build) of the prompt's prefill for ``cfg`` on
    ``mesh`` (bound: one process a rank), in the training layout: the
    reference's ``make_sharded_prefill``. ``step(model, tokens,
    frames=None, patches=None) → (cache, hidden)`` takes the GLOBAL prompt
    (B, S) (every rank the same; S divisible by the model ranks) and
    whisper's frames (B, S_enc, d) or llava's patches (B, P, d), and runs
    the rank's part (:func:`batch_slice`): the cache is the rank's shard
    for a ``shape.seq_len`` ring (a sequence-sharded ring holds this model
    rank's slots, whisper's cross K/V its S_enc/mp positions, a TP-mode
    arch's recurrent states its channels or heads; bf16 rings, as the
    reference's), the hidden its block (B_loc, S/mp, d) in SP mode and
    its rows' whole (B_loc, S, d) in TP mode.
    ``specs``: :func:`_serve_specs`. ``build(seed=0, device="cuda",
    param_dtype=torch.float32)`` → the rank's shards of
    ``init_model(cfg, seed)``."""
    par = make_par(mesh)
    specs = _serve_specs(cfg, par, shape, T.LM(cfg, "meta", par=par).specs,
                         False)

    def step(model, tokens, frames=None, patches=None):
        batch = {k: v for k, v in (("tokens", tokens), ("frames", frames),
                                   ("patches", patches)) if v is not None}
        mine = batch_slice(batch, par, True)
        return SV.prefill(model, mine["tokens"], shape.seq_len, dtype,
                          frames=mine.get("frames"),
                          patches=mine.get("patches"))

    def build(seed: int = 0, device="cuda", param_dtype=torch.float32):
        return T.init_model(cfg, seed, device, param_dtype, par=par)

    return step, specs, build


def make_sharded_decode(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig,
                        dtype=torch.bfloat16, layout: str = "fsdp"):
    """(step, specs, build) of one greedy decode step for ``cfg`` on
    ``mesh`` (bound), the reference's ``make_sharded_decode``:

      * ``layout="fsdp"``: the training layout (ZeRO-3 gathers of each
        weight a step), the ring sequence-sharded over ``model`` where
        mp divides ``shape.seq_len``, the decode-attention partials merged
        over ``model``;
      * ``layout="tp"``: the serving-resident layout (exclude_fsdp = the
        data axes, so the weights are replicated over them and never
        gathered there; Q and O head-parallel over ``model``, the MLP
        column/row parallel, the head vocab-parallel), each ring whole
        with this rank's K/V heads. No QKV bias (the reference's
        ``attn_tp_defs`` has none). Needs n_heads divisible by the model
        ranks.

    ``step(model, cache, token) → (next_token, logits, cache)`` takes the
    GLOBAL token (B, 1) (every rank the same) and runs the rank's rows:
    the next token of those rows (B_loc, 1), replicated over ``model``,
    and their logits' vocabulary block (B_loc, 1, V/mp); the cache is
    updated in place. ``specs``: :func:`_serve_specs`. ``build(seed=0,
    device="cuda", param_dtype=None)`` → (model, cache): the rank's shards
    of ``init_model(cfg, seed)`` in the layout (``param_dtype`` by default
    float32 for ``fsdp``, bfloat16 for ``tp``: serving weights live in
    bf16 there) and its empty cache shard (:func:`~repro_torch.models.
    serving.init_cache`, bf16 rings)."""
    if layout not in ("fsdp", "tp"):
        raise ValueError(f"layout {layout!r}: 'fsdp' or 'tp'")
    par = make_par(mesh)
    serve_tp = layout == "tp"
    if serve_tp and cfg.n_heads % par.mp_size:
        raise ValueError(f"{cfg.name}: the tp layout needs n_heads "
                         f"({cfg.n_heads}) divisible by the model ranks "
                         f"({par.mp_size})")
    exclude = par.dp if serve_tp else ()
    specs = _serve_specs(cfg, par, shape,
                         T.LM(cfg, "meta", par=par, exclude_fsdp=exclude,
                              serve_tp=serve_tp).specs, serve_tp)
    b_local = (shape.global_batch // par.dp_size
               if batch_sharded(shape.global_batch, par)
               else shape.global_batch)

    def step(model, cache, token):
        rows = batch_slice({"tokens": token}, par, True)["tokens"]
        return SV.decode_step(model, cache, rows, shape.seq_len, dtype)

    def build(seed: int = 0, device="cuda", param_dtype=None):
        if param_dtype is None:
            param_dtype = torch.bfloat16 if serve_tp else torch.float32
        model = T.init_model(cfg, seed, device, param_dtype, par=par,
                             exclude_fsdp=exclude, serve_tp=serve_tp)
        return model, SV.init_cache(cfg, b_local, shape.seq_len,
                                    torch.bfloat16, device, par, serve_tp)

    return step, specs, build
