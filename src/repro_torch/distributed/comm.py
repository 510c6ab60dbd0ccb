"""The collectives of the sharded paths, counted.

Port of the ``jax.lax.psum``/``pmax`` calls that ``spec.axis_names`` turns
on in :mod:`repro.core.flymc`, and of the all-gathers and reduce-scatters
of the LM stack's :mod:`repro_torch.distributed.par`, on
``torch.distributed``. Every collective goes through one of these
wrappers, each of which counts one call where it calls the collective and
nowhere else: SUM and MAX all-reduces in :data:`counts` (so the per-step
budget of :mod:`repro_torch.distributed.flymc_dist`, at most 4 SUM and 1
MAX all-reduces a RWMH step, none in the z-phase, is counted, not
inferred), all-gathers, reduce-scatters and gathers to one rank in
:data:`shard_counts`, and each kind's bytes in :data:`nbytes` (the
collective's whole tensor: the all-reduced tensor, the gathered result,
the tensor before its scatter).

The implementation is chosen by the group's backend, explicitly: NCCL
runs ``all_gather_into_tensor`` and ``reduce_scatter_tensor``; gloo (the
CPU, and several ranks sharing one card over CUDA tensors) runs the list
``all_gather`` and a reduce-scatter as a SUM all-reduce followed by this
rank's block, counted as the all-reduce it is. :func:`gather` moves
CUDA tensors over NCCL and host copies over gloo.

``all_reduce`` leaves every rank with the same reduced bits, so decisions
taken on a reduced value are the same on every rank.

Gradients (MALA, HMC): with θ replicated and the bright sum split over
ranks, ∇θ Σ_r s_r(θ) = Σ_r ∇θ s_r(θ). :func:`sum_across` is the forward
SUM with an identity backward, and :func:`grad_sum_across` the identity
with a SUM of the gradient in the backward; a density wraps θ in the
second before the shard-local rows and their sum in the first, so every
rank's gradient is the whole one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

counts = {"sum": 0, "max": 0}  # all_reduce calls through this module
shard_counts = {"all_gather": 0, "reduce_scatter": 0, "gather": 0}
nbytes = {"sum": 0, "max": 0, "all_gather": 0, "reduce_scatter": 0,
          "gather": 0}


def reset_counts() -> None:
    for d in (counts, shard_counts, nbytes):
        for k in d:
            d[k] = 0


def tally() -> dict[str, dict[str, int]]:
    """{kind: {"calls", "bytes"}} of every collective since the last
    :func:`reset_counts`."""
    calls = {**counts, **shard_counts}
    return {k: {"calls": calls[k], "bytes": nbytes[k]} for k in nbytes}


def _count(kind: str, t: torch.Tensor, copies: int = 1) -> None:
    """One call of ``kind`` over ``copies`` times ``t``'s bytes."""
    (counts if kind in counts else shard_counts)[kind] += 1
    nbytes[kind] += copies * t.numel() * t.element_size()


def rank(group) -> int:
    """This process's rank in ``group``."""
    return dist.get_rank(group)


def world_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks of ``t``, a new tensor (``t`` untouched)."""
    out = t.clone()
    _count("sum", out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group's ranks of ``t``, a new tensor."""
    out = t.clone()
    _count("max", out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def any_across(flag: torch.Tensor, group) -> torch.Tensor:
    """A bool ``flag`` ORed over the ranks (one MAX all-reduce)."""
    return all_reduce_max(flag.to(torch.int32), group).to(torch.bool)


def _nccl(group) -> bool:
    return dist.get_backend(group) == dist.Backend.NCCL


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (every
    rank's ``t`` has one shape)."""
    w = world_size(group)
    t = t.contiguous()
    if _nccl(group):
        out = torch.empty((w,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        _count("all_gather", t, w)
        dist.all_gather_into_tensor(out, t, group=group)
        parts = out.unbind(0)
    else:
        parts = [torch.empty_like(t) for _ in range(w)]
        _count("all_gather", t, w)
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` (the group's size blocks, in rank
    order) of Σ over the ranks of ``t``."""
    w = world_size(group)
    if t.shape[dim] % w:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split over {w} ranks")
    if not _nccl(group):  # gloo has no reduce-scatter of CUDA tensors
        return all_reduce_sum(t, group).chunk(w, dim)[rank(group)].contiguous()
    # (w, ...) in the standard layout: NCCL reads and writes flat buffers,
    # and ``stack``/``empty_like`` keep a cotangent's permuted strides
    blocks = torch.stack(t.chunk(w, dim)).contiguous()
    out = torch.empty(blocks.shape[1:], dtype=t.dtype, device=t.device)
    _count("reduce_scatter", blocks)
    dist.reduce_scatter_tensor(out, blocks, group=group)
    return out


def gather(t: torch.Tensor, group) -> list[torch.Tensor] | None:
    """Every rank's ``t`` (one shape and dtype on every rank), in rank
    order, on the group's rank 0; None on the others. NCCL gathers the
    tensors where they are; gloo gathers host tensors, so a CUDA ``t`` is
    copied to the host first. The tensors move as bytes."""
    w = world_size(group)
    t = t.detach()
    if not _nccl(group):
        t = t.cpu()
    flat = t.contiguous().view(-1).view(torch.uint8)
    parts = ([torch.empty_like(flat) for _ in range(w)]
             if rank(group) == 0 else None)
    _count("gather", flat, w)
    dist.gather(flat, parts, dst=dist.get_global_rank(group, 0), group=group)
    if parts is None:
        return None
    return [p.view(t.dtype).view(t.shape) for p in parts]


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def sum_across(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks; under autograd the gradient passes through as it
    is (each rank's shard-local term gets the replicated cotangent)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumAcross.apply(t, group)
    return all_reduce_sum(t, group)


def grad_sum_across(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; under autograd its gradient is summed over the ranks.
    A no-op (no collective) when no gradient is taken."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GradSumAcross.apply(t, group)
    return t
