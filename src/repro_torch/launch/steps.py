"""The sharded LM train step on a mesh of ``torch.distributed`` ranks.

Port of :mod:`repro.launch.steps`'s training half. The reference wraps its
step in ``shard_map`` over a device mesh; here every rank is a process
that runs the same step on its shards (:mod:`repro_torch.distributed.par`)
and its rows of the global batch, under the axis context of
:func:`repro_torch.launch.mesh.make_par`. :func:`batch_slice` is the rule
that cuts a global batch to a rank (rows over the data axes; tokens and
labels whole over ``model``, where the embedding is vocab-parallel and
the blocks sequence-parallel), and :func:`make_sharded_train_step`
returns the step, the local specs and a function that builds the rank's
model and optimizer state.

Only the SP-mode dense decoders (llama3.2, qwen2, stablelm, qwen1.5) are
sharded; another config raises ``NotImplementedError`` naming the ROADMAP
step that brings it. The sharded prefill and decode are ROADMAP queue 1
item 9f, step 1.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.par import Par
from repro_torch.launch.mesh import Mesh, make_par
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig


def batch_slice(batch: dict, par: Par) -> dict:
    """This rank's rows of a global batch ({"tokens", "labels"}, (B, S)
    each): the B / dp_size rows of its index over the data axes (the
    reference's ``batch_pspecs``: rows over dp, whole over ``model``)."""
    if not par.dp:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % par.dp_size:
            raise ValueError(f"batch {k}: {v.shape[0]} rows do not split "
                             f"over {par.dp_size} data ranks")
        n = v.shape[0] // par.dp_size
        i = par.mesh.index(par.dp)
        out[k] = v[i * n:(i + 1) * n]
    return out


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig,
                            dtype=torch.bfloat16, remat: bool = True,
                            compress_axes: tuple[str, ...] = (), **kw):
    """(step, specs, build) for ``cfg`` on ``mesh`` (bound: one process a
    rank). ``step(model, opt, batch[, err]) → metrics`` takes the GLOBAL
    batch (every rank the same) and runs the rank's rows; ``specs`` is
    name → WSpec of the rank's weights; ``build(seed=0, device="cuda",
    param_dtype=torch.float32)`` → (model, opt): the rank's shards of
    ``init_model(cfg, seed)`` with gradients on, and zero AdamW moments in
    the config's ``opt_dtype``. ``kw`` goes to
    :func:`~repro_torch.models.transformer.make_train_step` (``peak_lr``,
    ``warmup_steps``, ``clip_norm``)."""
    T.check_shardable(cfg)
    if shape.kind != "train":
        raise ValueError(f"{shape.name}: a {shape.kind} shape; the sharded "
                         "prefill and decode are ROADMAP queue 1 item 9f, "
                         "step 1")
    par = make_par(mesh)
    if shape.global_batch % max(par.dp_size, 1):
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
