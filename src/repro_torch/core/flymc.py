"""Firefly Monte Carlo (paper §2–§3): exact MCMC with subsets of data.

Port of :mod:`repro.core.flymc`, chain-batched: every state tensor carries a
leading ``(K, ...)`` chain axis, and each step makes one launch of each
kernel for all K chains. This slice ports the kernelized engines, which are
the defaults here:

* ``backend="pallas"`` — the θ-update's bright buffer and the z-update's
  candidates go through the fused bright-GLM kernel
  (:func:`repro_torch.kernels.bright_glm.ops.bright_glm`); the name is the
  reference's, the kernel is ``csrc/bright_glm.cu``;
* ``z_backend="fused"`` — the streamed candidate kernel
  (:func:`repro_torch.kernels.z_update.ops.z_candidates`) with per-datum
  counter uniforms and O(changed) partition updates.

The plain θ-engine (``backend="jnp"``), the plain implicit z-engine
(``z_backend="jnp"``) and explicit mode raise ``NotImplementedError`` until a
later slice ports them (ROADMAP queue 1, item 7).

Exactness: uniforms are keyed on datum indices, the bright-GLM total is
summed in a fixed block order and every other float reduction is a
``tree_sum``, so the realized chain is bitwise independent of buffer
capacities and of how many chains run together. Capacity overflow is
flagged per step; the driver re-runs the chunk at doubled capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.core import brightness, samplers
from repro_torch.core.bounds import CollapsedStats, GLMData, fused_family_of
from repro_torch.core.numerics import (
    DRAW_BRIGHT,
    DRAW_DARKEN,
    counter_uniform,
    key_words_of,
    log_expm1,
    tree_sum,
)
from repro_torch.kernels.bright_glm.ops import bright_glm
from repro_torch.kernels.z_update.ops import z_candidates

_NOT_PORTED = "is not ported to repro_torch yet (ROADMAP queue 1, item 7)"


@dataclasses.dataclass(frozen=True)
class FlyMCSpec:
    """Static configuration of a FlyMC chain."""

    bound: Any
    log_prior: Callable[[torch.Tensor], torch.Tensor]
    kernel: str = "rwmh"  # θ-operator: rwmh | mala
    capacity: int = 1024  # bright-buffer capacity C
    cand_capacity: int = 1024  # dark→bright candidate buffer capacity
    q_db: float = 0.01  # dark→bright proposal probability (Alg. 2)
    mode: str = "implicit"  # z-kernel: implicit (Alg. 2)
    kernel_kwargs: tuple = ()
    adapt_target: float | None = None
    backend: str = "pallas"  # θ-update engine: the fused bright-GLM kernel
    z_backend: str = "fused"  # z-update engine: the streamed candidate kernel
    num_warmup: int = 1000

    def __post_init__(self):
        # Only the kernel engines are ported; the others must not run silently.
        if self.mode != "implicit":
            raise NotImplementedError(f"mode={self.mode!r} (Algorithm 1) {_NOT_PORTED}")
        if self.backend != "pallas":
            raise NotImplementedError(f"backend={self.backend!r} {_NOT_PORTED}")
        if self.z_backend != "fused":
            raise NotImplementedError(f"z_backend={self.z_backend!r} {_NOT_PORTED}")

    def needs_grad(self) -> bool:
        return samplers.get_kernel(self.kernel).needs_grad


class FlyMCState(NamedTuple):
    sampler: samplers.SamplerState  # θ (K, ...), lp (K,), grad, aux (K, C)
    bright: brightness.BrightState  # arr, tab (K, N) int32; num (K,)
    delta_full: torch.Tensor  # (K, N) δ at current θ (bright & just-evaluated)
    log_step: torch.Tensor  # (K,) log step size
    rng: torch.Tensor  # (K, 2) key words
    iteration: torch.Tensor  # (K,) int64


class StepStats(NamedTuple):
    n_bright: torch.Tensor  # (K,) bright count after the step
    lik_queries: torch.Tensor  # (K,) per-datum likelihood evaluations
    accept_prob: torch.Tensor  # (K,)
    overflow: torch.Tensor  # (K,) bool — re-run at larger capacity
    joint_lp: torch.Tensor  # (K,)


def _clamped(idx, n: int):
    """Gather indices clamped into [0, n), as jax's ``take`` clamps: a step
    that overflowed its buffers may leave sentinels in ``arr``; the driver
    discards it, but it must not fault before the overflow flag is read."""
    return idx.to(torch.int64).clamp(0, n - 1)


def _family(spec: FlyMCSpec) -> str:
    fam = fused_family_of(spec.bound)
    if fam is None:
        raise ValueError(
            f"backend='pallas' needs a FusedBound, but "
            f"{type(spec.bound).__name__} has no usable fused_family hook"
        )
    return fam


def make_joint_logpost(spec, data: GLMData, stats: CollapsedStats,
                       bright_idx, n_bright) -> samplers.LogDensityFn:
    """f(θ) -> (joint log posterior (K,), δ on the bright buffer (K, C)).

    ``bright_idx`` (K, C) int32 slots with the first ``n_bright[k]`` valid
    (a prefix, as :func:`brightness.bright_buffer` produces); the fused
    kernel evaluates only those rows plus the O(D²) collapsed product.
    """
    fam = _family(spec)
    kw = spec.bound.fused_kernel_kwargs()

    def f(theta):
        delta, s = bright_glm(data.x, data.t, data.xi, bright_idx, n_bright,
                              theta, family=fam, **kw)
        lp = spec.log_prior(theta) + spec.bound.collapsed(theta, stats) + s
        return lp, delta

    return f


def _refresh_sampler(spec, data, stats, theta, bright, delta_full):
    """Rebuild SamplerState after a z-move; gradient kernels re-evaluate
    (and pay for it). Returns (state, extra_queries (K,))."""
    idx, mask = brightness.bright_buffer(bright, spec.capacity)
    if spec.needs_grad():
        f = make_joint_logpost(spec, data, stats, idx, bright.num)
        lp, aux, grad = samplers.value_and_grad(f, theta)
        return samplers.SamplerState(theta, lp, grad, aux), bright.num
    delta = delta_full.gather(1, _clamped(idx, delta_full.shape[1]))
    s = tree_sum(torch.where(mask, log_expm1(delta), torch.zeros_like(delta)))
    lp = spec.log_prior(theta) + spec.bound.collapsed(theta, stats) + s
    return (samplers.SamplerState(theta, lp, torch.zeros_like(theta), delta),
            torch.zeros_like(bright.num))


def _candidate_delta(spec, data, theta, cand_idx, n_cand):
    """δ on the compacted candidate buffer, through the same fused kernel."""
    delta, _ = bright_glm(data.x, data.t, data.xi, cand_idx, n_cand, theta,
                          family=_family(spec), **spec.bound.fused_kernel_kwargs())
    return delta


def _fused_z_update(spec, data, key, theta, bright, delta_full, delta_bright):
    """Algorithm 2 via the fused z-engine. Returns
    (bright_new, delta_full, queries (K,), overflow (K,))."""
    n = data.x.shape[0]
    kw = key_words_of(key)
    # torch.full, not torch.tensor: a host scalar copied to the card would
    # make the step wait on the stream.
    log_q = torch.log(torch.full((), spec.q_db, dtype=delta_full.dtype,
                                 device=delta_full.device))

    # --- bright → dark (free: cached δ + O(C) counter uniforms) ------------
    idx_b, mask_b = brightness.bright_buffer(bright, spec.capacity)
    u1 = counter_uniform(kw, DRAW_DARKEN, idx_b)
    darken = mask_b & (torch.log(u1) + log_expm1(delta_bright) < log_q)

    # --- dark → bright (streamed selection, then O(cand) work) -------------
    cap = spec.cand_capacity
    cand_idx, n_cand = z_candidates(bright.arr, bright.num, kw, spec.q_db, cap)
    overflow_c = n_cand > cap
    slots = torch.arange(cap, device=cand_idx.device)[None]
    mask_c = slots < n_cand[:, None]
    nb = torch.clamp(n_cand, max=cap).to(torch.int64)
    delta_c = _candidate_delta(spec, data, theta, cand_idx, nb)
    cand_cl = _clamped(cand_idx, n)
    u3 = counter_uniform(kw, DRAW_BRIGHT, cand_cl)
    brighten = mask_c & (torch.log(u3) + log_q < log_expm1(delta_c))
    old = delta_full.gather(1, cand_cl)
    delta_full = brightness.scatter_drop(
        delta_full, cand_idx, torch.where(mask_c, delta_c, old)
    )
    bright_new = brightness.apply_flips(bright, darken, cand_idx, brighten)
    return bright_new, delta_full, n_cand.to(torch.int64), overflow_c


def flymc_step(spec, data: GLMData, stats: CollapsedStats,
               state: FlyMCState) -> tuple[FlyMCState, StepStats]:
    """θ-update followed by z-update (paper §2 alternation), K chains."""
    ks = jr.split(state.rng, 3)
    key_theta, key_z, key_next = ks[:, 0], ks[:, 1], ks[:, 2]

    # ---- θ | z -------------------------------------------------------------
    idx, mask = brightness.bright_buffer(state.bright, spec.capacity)
    f = make_joint_logpost(spec, data, stats, idx, state.bright.num)
    kernel = samplers.bind(spec.kernel, f, spec.kernel_kwargs)
    new_sampler, info = kernel(key_theta, state.sampler, torch.exp(state.log_step))
    queries_theta = info.n_evals * state.bright.num
    old = state.delta_full.gather(1, _clamped(idx, state.delta_full.shape[1]))
    delta_full = brightness.scatter_drop(
        state.delta_full, idx, torch.where(mask, new_sampler.aux, old)
    )

    # ---- z | θ -------------------------------------------------------------
    bright_new, delta_full, queries_z, overflow_c = _fused_z_update(
        spec, data, key_z, new_sampler.theta, state.bright, delta_full,
        new_sampler.aux,
    )
    overflow = overflow_c | (bright_new.num > spec.capacity)
    refreshed, extra_q = _refresh_sampler(
        spec, data, stats, new_sampler.theta, bright_new, delta_full
    )

    log_step = state.log_step
    if spec.adapt_target is not None:
        # Warmup-only: after num_warmup iterations the kernel is fixed.
        adapted = samplers.adapt_step_size(
            log_step, info.accept_prob, spec.adapt_target, state.iteration
        )
        log_step = torch.where(state.iteration < spec.num_warmup, adapted,
                               log_step)

    new_state = FlyMCState(
        sampler=refreshed,
        bright=bright_new,
        delta_full=delta_full,
        log_step=log_step,
        rng=key_next,
        iteration=state.iteration + 1,
    )
    stats_out = StepStats(
        n_bright=bright_new.num,
        lik_queries=queries_theta + queries_z + extra_q,
        accept_prob=info.accept_prob,
        overflow=overflow,
        joint_lp=refreshed.lp,
    )
    return new_state, stats_out


def init_chain_state(spec, data: GLMData, stats: CollapsedStats, theta0,
                     key, z0=None, step_size: float = 0.1) -> FlyMCState:
    """Chain initialization for K chains: ``theta0`` (K, ...), ``key``
    (K, 2). No host syncs and no growth: if a chain's initial bright set
    exceeds ``spec.capacity`` the δ buffer is truncated, and the caller
    rebuilds at a grown capacity from the same keys."""
    n = data.x.shape[0]
    ks = jr.split(key)
    k_z, k_chain = ks[:, 0], ks[:, 1]
    if z0 is None:
        z0 = jr.bernoulli(k_z, min(2.0 * spec.q_db, 1.0), (n,))
    bright = brightness.from_z(z0)
    idx, mask = brightness.bright_buffer(bright, spec.capacity)
    f = make_joint_logpost(spec, data, stats, idx, bright.num)
    sampler = samplers.init_state(f, theta0, with_grad=spec.needs_grad())
    k = theta0.shape[0]
    delta_full = torch.zeros(k, n, dtype=sampler.lp.dtype,
                             device=theta0.device).scatter(
        1, idx.to(torch.int64),
        torch.where(mask, sampler.aux, torch.zeros_like(sampler.aux)),
    )
    log_step = torch.log(torch.full((k,), step_size, dtype=sampler.lp.dtype,
                                    device=theta0.device))
    return FlyMCState(
        sampler=sampler,
        bright=bright,
        delta_full=delta_full,
        log_step=log_step,
        rng=k_chain,
        iteration=torch.zeros(k, dtype=torch.int64, device=theta0.device),
    )


def _grow(spec: FlyMCSpec, n: int) -> FlyMCSpec:
    return dataclasses.replace(
        spec,
        capacity=min(2 * spec.capacity, n),
        cand_capacity=min(2 * spec.cand_capacity, n),
    )


def resize_state(spec: FlyMCSpec, state: FlyMCState) -> FlyMCState:
    """Re-gather the capacity-shaped δ buffer after a capacity change: zero
    likelihood queries, bitwise-identical chain."""
    idx, _ = brightness.bright_buffer(state.bright, spec.capacity)
    aux = state.delta_full.gather(1, _clamped(idx, state.delta_full.shape[1]))
    return state._replace(sampler=state.sampler._replace(aux=aux))
