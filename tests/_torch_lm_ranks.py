"""Rank bodies for the sharded LM train step's tests (imports no JAX).

Each function runs on every rank of a group started by
:func:`repro_torch.distributed.launch.run_ranks` (or on the one rank of
:func:`~repro_torch.distributed.launch.single_rank`) and returns host
values. ``tests/test_torch_train_sharded*.py`` and ``tests/test_torch_par.py``
run them with gloo on the CPU, ``tests/test_torch_cuda.py`` on the card.
A job is a dict: ``arch`` (a reduced config's id) or ``cfg`` (a
ModelConfig), ``device``, ``batch`` ({"tokens", "labels"}: (B, S) numpy,
and whisper's "frames" or llava's "patches"), ``steps``, and per function
its mesh and options.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.distributed import comm
from repro_torch.distributed import par as P
from repro_torch.launch.mesh import make_mesh, make_par
from repro_torch.launch.steps import make_sharded_train_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWState
from repro_torch.optim.compression import init_error_state

SHAPE = ShapeConfig("train_tiny", 64, 8, "train")


def batch_of(job):
    return {k: torch.as_tensor(np.asarray(v), device=job["device"])
            for k, v in job["batch"].items()}


def metrics_of(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def logical(model, tensors: dict | None = None) -> dict | None:
    """The logical tensor of each of ``model``'s weights (or of
    ``tensors``, shards keyed and placed as its weights: AdamW moments) as
    numpy on mesh rank 0; None on the other ranks, which must call it
    too."""
    par, out = model.par, {}
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    for n, t in tensors.items():
        full = P.gather_logical(t, model.specs[n], par)
        if par.mesh.rank == 0:
            out[n] = full.float().cpu().numpy()
    return out if par.mesh.rank == 0 else None


def state(model, opt):
    return {"params": dict(model.named_parameters()), "opt": opt}


def shardings(model):
    return {"params": model.specs,
            "opt": AdamWState(None, model.specs, model.specs)}


def load_state(model, restored) -> AdamWState:
    """Copy a restored state's parameters into ``model``; its AdamW
    state."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(restored["params"][n])
    return restored["opt"]


def _setup(job, mesh, **kw):
    cfg = job.get("cfg") or get_reduced(job["arch"])
    step, _, build = make_sharded_train_step(
        cfg, mesh, SHAPE, job.get("dtype", torch.float32),
        remat=job.get("remat", False), **kw)
    if job.get("params") is None:
        model, opt = build(job.get("seed", 0), job["device"])
    else:
        model = convert.lm_params(job["params"], cfg, job["device"],
                                  torch.float32, mesh=mesh,
                                  exclude_fsdp=kw.get("compress_axes", ()))
        model.requires_grad_(True)
        opt = T.init_opt(model)
    return step, model, opt


def _route_margins(margins: list):
    """Wrap ``layers.moe_route`` so that each call appends its least gap
    between a token's k-th and (k+1)-th router probability to
    ``margins``; returns the function that undoes the wrap."""
    from repro_torch.models import layers as L

    route = L.moe_route

    def held(tokens, router, cfg):
        r = route(tokens, router, cfg)
        p = r["probs"].detach().sort(-1, descending=True).values
        k = cfg.moe.top_k
        margins.append(float((p[:, k - 1] - p[:, k]).min()))
        return r

    L.moe_route = held
    return lambda: setattr(L, "moe_route", route)


def train(group, job):
    """``job["steps"]`` sharded steps on mesh ``job["mesh"]`` (shape,
    axes) from ``job["params"]`` (the reference's global numpy tree) or
    the seed: each step's metrics, the collectives of the last step by
    kind (calls, bytes), the least routing margin of every MoE call
    (``margin``, None without one) and, on rank 0, the logical weights
    after each step in ``job["keep"]`` (default: the last) by step and the
    final ones. A rank past the mesh returns None."""
    mesh = make_mesh(*job["mesh"])
    if mesh.rank is None:
        return None
    margins = []
    undo = _route_margins(margins)
    try:
        step, model, opt = _setup(job, mesh, **job.get("kw", {}))
        batch, out, kept = batch_of(job), [], {}
        for i in range(job["steps"]):
            comm.reset_counts()
            out.append(metrics_of(step(model, opt, batch)))
            if i + 1 in job.get("keep", ()):
                kept[i + 1] = logical(model)
        tally = comm.tally()
    finally:
        undo()
    return {"metrics": out, "tally": tally, "params": logical(model),
            "kept": kept, "margin": min(margins, default=None)}


def grads(group, job):
    """One forward and backward of ``transformer.loss_fn`` on mesh
    ``job["mesh"]`` from ``job["params"]`` (float32, ``job["remat"]``),
    then ``par.sync_grads``: the loss and, on mesh rank 0, the logical
    gradient of every weight (None on the other ranks). A rank past the
    mesh returns None."""
    from repro_torch.launch.steps import batch_slice

    mesh = make_mesh(*job["mesh"])
    if mesh.rank is None:
        return None
    _, model, _ = _setup(job, mesh)
    with torch.enable_grad():
        loss, _ = T.loss_fn(model, batch_slice(batch_of(job), model.par),
                            torch.float32, job.get("remat", False))
        loss.backward()
    g = P.sync_grads({n: p.grad for n, p in model.named_parameters()},
                     model.specs, model.par)
    return {"loss": float(loss), "grads": logical(model, g)}


def resume(group, job):
    """On mesh (2, 2): 4 steps from the seed with the state saved after
    step 2 (``job["ckpt"]``); a model of another seed restored from that
    save and stepped twice; then the save restored onto mesh (1, 2) by
    ranks 0 and 1. Returns (rank 0) the metrics of both runs, the logical
    weights and first moments saved and at the end of both, and the
    (1, 2) restore's logical weights, moments and step."""
    mesh = make_mesh((2, 2), ("data", "model"))
    step, model, opt = _setup(job, mesh)
    ck = Checkpointer(job["ckpt"])
    batch, whole, out = batch_of(job), [], {}
    for i in range(4):
        whole.append(metrics_of(step(model, opt, batch)))
        if i == 1:
            ck.save(2, state(model, opt), shardings=shardings(model),
                    mesh=mesh, blocking=True)
            out["saved_params"] = logical(model)
            out["saved_m"] = logical(model, opt.m)
    out.update(whole=whole, whole_params=logical(model),
               whole_m=logical(model, opt.m))
    step, model, opt = _setup(dict(job, seed=job.get("seed", 0) + 1), mesh)
    restored, manifest = ck.restore(state(model, opt), step=2,
                                    shardings=shardings(model), mesh=mesh)
    opt = load_state(model, restored)
    out["resumed"] = [metrics_of(step(model, opt, batch)) for _ in range(2)]
    out["resumed_params"] = logical(model)
    out["resumed_m"] = logical(model, opt.m)
    half = make_mesh((1, 2), ("data", "model"))
    if half.rank is not None:
        m2 = T.LM(get_reduced(job["arch"]), job["device"], torch.float32,
                  make_par(half))
        opt2 = T.init_opt(m2)
        restored, _ = ck.restore(state(m2, opt2), step=2,
                                 shardings=shardings(m2), mesh=half)
        opt2 = load_state(m2, restored)
        out["half_params"] = logical(m2)
        out["half_m"], out["half_v"] = logical(m2, opt2.m), logical(m2, opt2.v)
        out["half_step"] = int(opt2.step)
    return out


def compressed(group, job):
    """4 steps on mesh ``job["mesh"]`` (with a ``pod`` axis) exact, then
    with ``compress_axes=("pod",)`` from the same start: both runs'
    losses."""
    mesh = make_mesh(*job["mesh"])
    batch, out = batch_of(job), {}
    for comp in ((), ("pod",)):
        step, model, opt = _setup(job, mesh, compress_axes=comp,
                                  **job.get("kw", {}))
        err = (init_error_state(dict(model.named_parameters()))
               if comp else None)
        out[comp] = [metrics_of(step(model, opt, batch, err))["loss"]
                     for _ in range(job["steps"])]
    return out


def many(group, jobs):
    """Each ``(function name, job)`` of ``jobs`` in turn, on one start of
    the ranks: their results in order."""
    return [globals()[name](group, job) for name, job in jobs]


def collective_grads(group, job):
    """The gradients of each collective of ``distributed.par`` on mesh
    (data=2, model=2), from ``job``'s numpy inputs: ``x`` (8, 6), ``c``
    (4, 8, 6) one weight a rank, ``rows`` (T, D), ``w`` (D, V), ``labels``
    (T,). Each case's loss is a psum of the ranks' terms (or replicated),
    so that every rank's gradient is that of one global function; the
    test holds them to autograd through the plain function."""
    from repro_torch.kernels.fused_ce import ops as ce_ops

    mesh = make_mesh((2, 2), ("data", "model"))
    par, r, axes = make_par(mesh), mesh.rank, ("data", "model")
    x, c = torch.as_tensor(job["x"]), torch.as_tensor(job["c"])
    out = {}

    xs = x[2 * r:2 * r + 2].clone().requires_grad_(True)
    y = P.all_gather(xs, axes, 0, par)
    P.psum((c[r] * y).sum(), axes, par).backward()
    out["all_gather"] = xs.grad.numpy()

    xr = (x * (r + 1)).requires_grad_(True)
    z = P.reduce_scatter(xr, axes, 0, par)
    P.psum((c[r, 2 * r:2 * r + 2] * z).sum(), axes, par).backward()
    out["reduce_scatter"] = xr.grad.numpy()

    v = x[r].clone().requires_grad_(True)
    (P.psum(v, axes, par) ** 2).sum().backward()
    out["psum"] = v.grad.numpy()

    m = P.pmax(v * (r + 1), axes, par)
    out["pmax"] = (m.numpy(), m.requires_grad)

    rows = torch.as_tensor(job["rows"]).requires_grad_(True)
    vb = job["w"].shape[1] // 2  # this rank's vocabulary block
    i = mesh.index(("model",))
    w = torch.as_tensor(job["w"][:, i * vb:(i + 1) * vb]).requires_grad_(True)
    nll = ce_ops.fused_ce_shard(rows, w, torch.as_tensor(job["labels"]) - i * vb,
                                mesh.group(("model",)), chunk=8)
    nll.sum().backward()
    out["ce"] = (nll.detach().numpy(), rows.grad.numpy(), w.grad.numpy())
    return out


def compress_rounds(group, job):
    """``compressed_pmean`` over a (pod=2) mesh for each round of
    ``job["g"]`` (rounds, 2, n), the error state carried: per round this
    rank's int8 code, the shared scale, g_hat and the error state."""
    from repro_torch.optim.compression import compressed_pmean, quantize

    mesh = make_mesh((2,), ("pod",))
    par, r = make_par(mesh), mesh.rank
    err = torch.zeros(job["g"].shape[-1])
    out = []
    for g in torch.as_tensor(job["g"]):
        q, scale, _ = quantize(g[r], err, ("pod",), par)
        g_hat, err = compressed_pmean(g[r], err, ("pod",), par)
        out.append((q.numpy(), float(scale), g_hat.numpy(), err.numpy()))
    return out


def sharded_save(group, job):
    """A sharded save on a (data=n) mesh of ``job["ranks"]`` ranks into
    ``job["dir"]``: a bfloat16 (4, 6) leaf split over ``data`` along dim 1
    (a file page holds every rank's columns), and a (3,) leaf replicated
    over ``data`` holding each rank's index (the save keeps the first
    replica's). Returns this rank's restore of the save onto the mesh,
    its own columns ("mine") and the gathers it made. ``job["late"]``: a
    rank that makes its Checkpointer (whose constructor sweeps stale
    tmps from the directory) a second after the others."""
    import time

    from repro_torch.distributed.par import WSpec, local_slice

    n, dev = job["ranks"], job["device"]
    mesh = make_mesh((n,), ("data",))
    cols = WSpec((4, 6), fsdp_dim=1, fsdp_axes=("data",),
                 local_shape=(4, 6 // n))
    rep = WSpec((3,), sync=("data",), local_shape=(3,), replicas=n)
    specs = {"cols": cols, "rep": rep, "step": None}
    full = (torch.arange(24, dtype=torch.float32, device=dev).reshape(4, 6)
            / 7).to(torch.bfloat16)
    tree = {"cols": local_slice(full, cols, make_par(mesh)).clone(),
            "rep": torch.full((3,), float(mesh.rank), device=dev),
            "step": torch.tensor(5, device=dev)}
    comm.reset_counts()
    if job.get("late") == mesh.rank:
        time.sleep(1.0)
    Checkpointer(job["dir"]).save(1, tree, shardings=specs, mesh=mesh,
                                  blocking=True)
    gathers = comm.shard_counts["gather"]
    back, _ = Checkpointer(job["dir"]).restore(
        {k: torch.zeros_like(v) for k, v in tree.items()}, step=1,
        shardings=specs, mesh=mesh)
    back["mine"] = tree["cols"]
    return {k: v.float().cpu().numpy() for k, v in back.items()} | {
        "gathers": gathers}
