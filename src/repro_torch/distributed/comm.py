"""The collectives of a data-sharded FlyMC step, counted.

Port of the ``jax.lax.psum``/``pmax`` calls that ``spec.axis_names`` turns
on in :mod:`repro.core.flymc`, on ``torch.distributed``. Every collective
the step makes goes through one of these wrappers, each of which adds one
to :data:`counts` where it calls ``all_reduce`` and nowhere else, so the
per-step budget of :mod:`repro_torch.distributed.flymc_dist` (at most 4
SUM and 1 MAX all-reduces a RWMH step, none in the z-phase) is counted,
not inferred.

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


def reset_counts() -> None:
    counts["sum"] = counts["max"] = 0


def rank(group) -> int:
    """This process's rank in ``group``."""
    return dist.get_rank(group)


def world_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks of ``t``, a new tensor (``t`` untouched)."""
    out = t.clone()
    counts["sum"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def any_across(flag: torch.Tensor, group) -> torch.Tensor:
    """A bool ``flag`` ORed over the ranks (one MAX all-reduce)."""
    out = flag.to(torch.int32)
    counts["max"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.to(torch.bool)


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
