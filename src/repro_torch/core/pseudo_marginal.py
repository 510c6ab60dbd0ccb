"""Pseudo-marginal MCMC as a FlyMC special case (paper §5), chain-batched.

Port of :mod:`repro.core.pseudo_marginal`. With every z_n drawn as a
Bernoulli(½), the joint density is an unbiased estimator of the posterior
over θ up to normalization, and a joint (θ, z) Metropolis–Hastings update is
pseudo-marginal MCMC. The z proposal is independent of the current state,
so the MH ratio is the plain joint-density ratio. This is a validity harness
(its θ-marginal must be the full-data posterior), not a performance path:
it evaluates every datum densely, with no kernel.

State tensors carry a leading ``(K, ...)`` chain axis; keys are ``(K, 2)``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.core.bounds import CollapsedStats, GLMData
from repro_torch.core.numerics import log_expm1, tree_sum


class PMState(NamedTuple):
    theta: torch.Tensor  # (K, ...)
    z: torch.Tensor  # (K, N) bool
    lp: torch.Tensor  # (K,)
    rng: torch.Tensor  # (K, 2) key words


def joint_log_density(bound: Any, log_prior: Callable, data: GLMData,
                      stats: CollapsedStats, theta: torch.Tensor,
                      z: torch.Tensor) -> torch.Tensor:
    """(K,) log p̃(θ) + Σ_{z=1} log L̃_n, evaluated densely."""
    delta = bound.log_lik(theta, data) - bound.log_bound(theta, data)
    s = tree_sum(torch.where(z, log_expm1(delta), torch.zeros_like(delta)))
    return log_prior(theta) + bound.collapsed(theta, stats) + s


def init(bound, log_prior, data: GLMData, stats: CollapsedStats,
         theta0: torch.Tensor, key: torch.Tensor) -> PMState:
    ks = jr.split(key)
    k_z, k_chain = ks[:, 0], ks[:, 1]
    z0 = jr.bernoulli(k_z, 0.5, (data.x.shape[0],))
    lp0 = joint_log_density(bound, log_prior, data, stats, theta0, z0)
    return PMState(theta0, z0, lp0, k_chain)


def step(bound, log_prior, data: GLMData, stats: CollapsedStats,
         state: PMState, step_size: float) -> tuple[PMState, torch.Tensor]:
    """One joint (θ, z) MH update with z' ~ Bernoulli(½)^N for K chains.
    Returns (state, accepted (K,))."""
    ks = jr.split(state.rng, 4)
    k_theta, k_z, k_acc, k_next = (ks[:, i] for i in range(4))
    th = state.theta
    theta_p = th + step_size * jr.normal(k_theta, th.shape[1:])
    z_p = jr.bernoulli(k_z, 0.5, state.z.shape[1:])
    lp_p = joint_log_density(bound, log_prior, data, stats, theta_p, z_p)
    log_ratio = lp_p - state.lp  # symmetric θ proposal; z proposal cancels
    accepted = torch.log(jr.uniform(k_acc, ())) < log_ratio
    acc_th = accepted.reshape(accepted.shape + (1,) * (th.dim() - 1))
    new = PMState(
        theta=torch.where(acc_th, theta_p, th),
        z=torch.where(accepted[:, None], z_p, state.z),
        lp=torch.where(accepted, lp_p, state.lp),
        rng=k_next,
    )
    return new, accepted
