"""Rank bodies for the sharded prefill and decode's tests (imports no JAX).

Each function runs on every rank of a group started by
:func:`repro_torch.distributed.launch.run_ranks` (or on the one rank of
:func:`~repro_torch.distributed.launch.single_rank`) and returns host
values. ``tests/test_torch_serve_sharded*.py`` run them with gloo on the
CPU, ``tests/test_torch_cuda.py`` on the card. A job is a dict:

  * ``arch`` (a reduced config's id) or ``cfg`` (a ModelConfig), ``device``;
  * ``mesh``: (shape, axis names); ``layout``: "fsdp" (default) or "tp";
  * ``seq_len``, ``batch`` (the global B);
  * ``params``: the reference's global numpy tree (else ``seed``);
  * ``prompt``: (B, S) numpy token ids to prefill (fsdp), with whisper's
    ``frames`` (B, S_enc, d) or llava's ``patches`` (B, P, d), or
    ``cache``: a reference cache tree (numpy, logical) to start from,
    else the empty cache of ``init_cache``;
  * ``feed``: the global (B, 1) tokens of the decode steps, in order.

Compute is float32; the rings are bfloat16, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.distributed import comm
from repro_torch.distributed import par as P
from repro_torch.distributed.par import PSpec
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.launch.mesh import make_mesh, make_par
from repro_torch.launch.steps import (
    batch_sharded,
    make_sharded_decode,
    make_sharded_prefill,
)
from repro_torch.models import serving as SV
from repro_torch.models.config import ShapeConfig


def gathered(t: torch.Tensor, spec: PSpec, par) -> np.ndarray:
    """The logical array of the shards ``t`` (every rank calls it)."""
    return P.gather_logical(t, spec, par).float().cpu().numpy()


def gathered_cache(cache: dict, specs: dict, par) -> dict:
    return {"t": cache["t"],
            "layers": [{n: gathered(c[n], s[n], par) for n in c}
                       for c, s in zip(cache["layers"], specs["layers"])]}


def serve(group, job):
    """A sharded prefill (``job["prompt"]``) and the decode steps of
    ``job["feed"]`` on mesh ``job["mesh"]``. Returns (every rank) the
    logical hidden and cache after the prefill, each step's logical
    logits and next tokens, the final logical cache, the decode-attention
    kernel's launches a step, the collectives of the last step by kind
    (this rank's), the rank's cache shapes (its first layer's, and every
    layer's) and the least routing margin of its MoE calls
    (``margin``)."""
    from _torch_lm_ranks import _route_margins

    margins = []
    undo = _route_margins(margins)
    try:
        out = _serve(job)
    finally:
        undo()
    return out | {"margin": min(margins, default=None)}


def _serve(job):
    cfg = job.get("cfg") or get_reduced(job["arch"])
    dev = job["device"]
    if torch.device(dev).type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(*job["mesh"])
    par = make_par(mesh)
    seq, b = job["seq_len"], job["batch"]
    f32, kv = torch.float32, torch.bfloat16
    tp = job.get("layout", "fsdp") == "tp"
    step, specs, build = make_sharded_decode(
        cfg, mesh, ShapeConfig("decode", seq, b, "decode"), f32,
        job.get("layout", "fsdp"))
    whole = not batch_sharded(b, par)
    if job.get("params") is None:
        model, cache = build(job.get("seed", 0), dev, f32)
    else:
        model = convert.lm_params(job["params"], cfg, dev, f32,
                                  mesh=mesh, exclude_fsdp=par.dp if tp else (),
                                  serve_tp=tp)
        cache = SV.init_cache(cfg, b if whole else b // par.dp_size, seq, kv,
                              dev, par, tp)
    out = {}
    if job.get("prompt") is not None:
        pstep, pspecs, _ = make_sharded_prefill(
            cfg, mesh, ShapeConfig("prefill", seq, b, "prefill"), f32)
        extra = {k: torch.as_tensor(job[k], device=dev)
                 for k in ("frames", "patches") if job.get(k) is not None}
        cache, h = pstep(model, torch.as_tensor(job["prompt"], device=dev),
                         **extra)
        out["hidden"] = gathered(h, pspecs["out"], par)
        out["prefill_cache"] = gathered_cache(cache, pspecs["cache"], par)
    elif job.get("cache") is not None:
        cache = convert.lm_cache(job["cache"], cfg, seq, dev, mesh, tp, whole,
                                 kv)
    out.update(logits=[], tokens=[], launches=[])
    for tok in job.get("feed", []):
        comm.reset_counts()
        before = attn_ops.launch_count
        nxt, logits, cache = step(model, cache,
                                  torch.as_tensor(tok, device=dev))
        out["launches"].append(attn_ops.launch_count - before)
        out["tally"] = comm.tally()
        out["logits"].append(gathered(logits, specs["out"], par))
        out["tokens"].append(
            P.gather_logical(nxt, specs["tokens"], par).cpu().numpy())
    out["cache"] = gathered_cache(cache, specs["cache"], par)
    out["ring_local"] = next((tuple(c["k"].shape) for c in cache["layers"]
                              if "k" in c), None)  # the first ring's
    out["shapes_local"] = {n: tuple(v.shape)
                           for n, v in cache["layers"][0].items()}
    out["layer_shapes"] = [{n: tuple(v.shape) for n, v in c.items()}
                           for c in cache["layers"]]
    return out


def argmax_tie(group, job):
    """``vocab_parallel_argmax`` on mesh ``job["mesh"]`` over the global
    logits ``job["logits"]`` (B, 1, V) cut into the model ranks' blocks:
    the (B, 1) tokens on every rank."""
    mesh = make_mesh(*job["mesh"])
    par = make_par(mesh)
    full = torch.as_tensor(job["logits"])
    mine = P.local_slice(full, PSpec(((), (), par.mp_axes)), par)
    return SV.vocab_parallel_argmax(mine.contiguous(), par).numpy()


def many(group, jobs):
    """Each ``(function name, job)`` of ``jobs`` in turn, on one start of
    the ranks: their results in order."""
    return [globals()[name](group, job) for name, job in jobs]
