"""Parameter-update kernels for the θ | z conditional (paper §2, §4).

Port of :mod:`repro.core.samplers`, chain-batched: the target is
``f(θ (K, ...)) -> (lp (K,), aux)``, keys are ``(K, 2)`` and every chain
makes its own accept decision. Gradients come from ``torch.autograd``
(MALA). Random-walk Metropolis–Hastings and MALA are ported; slice sampling
and HMC are registered so specs resolve, and raise until a later slice
ports them (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as jr
from repro_torch.core.numerics import flat_tree_sum

LogDensityFn = Callable[[torch.Tensor], tuple[torch.Tensor, Any]]


class SamplerState(NamedTuple):
    theta: torch.Tensor  # (K, ...)
    lp: torch.Tensor  # (K,) cached log-density at theta
    grad: torch.Tensor  # (K, ...) cached gradient (zeros for gradient-free)
    aux: Any  # (K, C) cached aux from the last evaluation at theta


class StepInfo(NamedTuple):
    accept_prob: torch.Tensor  # (K,)
    accepted: torch.Tensor  # (K,) bool
    n_evals: int  # density evaluations this step (same for every chain)


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-chain ``where`` over a leading chain axis."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _chain(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (K,) per-chain scalar against (K, ...)."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def value_and_grad(f: LogDensityFn, theta: torch.Tensor):
    """(lp, aux, ∇θ lp) for every chain at once (chains are independent)."""
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        lp, aux = f(th)
        (grad,) = torch.autograd.grad(lp.sum(), th)
    return lp.detach(), aux.detach(), grad


def init_state(f: LogDensityFn, theta, with_grad: bool = False) -> SamplerState:
    if with_grad:
        lp, aux, grad = value_and_grad(f, theta)
    else:
        lp, aux = f(theta)
        grad = torch.zeros_like(theta)
    return SamplerState(theta, lp, grad, aux)


def _accept(state, proposed: SamplerState, log_ratio, k_acc):
    accept_prob = torch.clamp(torch.exp(torch.clamp(log_ratio, max=0.0)), max=1.0)
    accepted = torch.log(jr.uniform(k_acc, ())) < log_ratio
    new = SamplerState(*(_select(accepted, a, b) for a, b in zip(proposed, state)))
    return new, StepInfo(accept_prob, accepted, 1)


def rwmh_step(f: LogDensityFn, key, state: SamplerState, step_size):
    """Random-walk Metropolis–Hastings (§4.1)."""
    ks = jr.split(key)
    k_prop, k_acc = ks[:, 0], ks[:, 1]
    th = state.theta
    eta = _chain(step_size, th) * jr.normal(k_prop, th.shape[1:])
    theta_p = th + eta
    lp_p, aux_p = f(theta_p)
    log_ratio = lp_p - state.lp
    return _accept(state, SamplerState(theta_p, lp_p, state.grad, aux_p),
                   log_ratio, k_acc)


def mala_step(f: LogDensityFn, key, state: SamplerState, step_size):
    """Metropolis-adjusted Langevin (§4.2); gradients through autograd."""
    ks = jr.split(key)
    k_prop, k_acc = ks[:, 0], ks[:, 1]
    th = state.theta
    eps = _chain(step_size, th)
    eps2 = eps * eps
    mean_fwd = th + 0.5 * eps2 * state.grad
    theta_p = mean_fwd + eps * jr.normal(k_prop, th.shape[1:])
    lp_p, aux_p, grad_p = value_and_grad(f, theta_p)
    mean_rev = theta_p + 0.5 * eps2 * grad_p
    two_eps2 = 2.0 * (step_size * step_size)
    log_q_fwd = -flat_tree_sum(torch.square(theta_p - mean_fwd)) / two_eps2
    log_q_rev = -flat_tree_sum(torch.square(th - mean_rev)) / two_eps2
    log_ratio = (lp_p - state.lp) + (log_q_rev - log_q_fwd)
    return _accept(state, SamplerState(theta_p, lp_p, grad_p, aux_p),
                   log_ratio, k_acc)


def _not_ported(name: str):
    def step(*args, **kwargs):
        raise NotImplementedError(
            f"the {name} θ-kernel is not ported to repro_torch yet "
            "(ROADMAP queue 1, item 6)"
        )

    return step


slice_step = _not_ported("slice")
hmc_step = _not_ported("hmc")


def adapt_step_size(log_step, accept_prob, target: float, iteration,
                    gain: float = 0.05):
    """Robbins–Monro update of log step size toward a target accept rate."""
    lr = gain / torch.sqrt(1.0 + iteration.to(log_step.dtype))
    return log_step + lr * (accept_prob - target)


# ---------------------------------------------------------------------------
# Kernel registry
# ---------------------------------------------------------------------------


class KernelSpec(NamedTuple):
    step_fn: Callable
    needs_grad: bool
    target_accept: float
    scale_param: str = "step_size"


KERNEL_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(name: str, step_fn: Callable, *, needs_grad: bool,
                    target_accept: float, scale_param: str = "step_size"):
    """Register a θ-kernel under ``name`` for use by specs and the api."""
    KERNEL_REGISTRY[name] = KernelSpec(step_fn, needs_grad, target_accept,
                                       scale_param)


def get_kernel(name: str) -> KernelSpec:
    try:
        return KERNEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown θ-kernel {name!r}; registered: {sorted(KERNEL_REGISTRY)}"
        ) from None


def bind(name: str, f: LogDensityFn, static_kwargs=()) -> Callable:
    """Uniform ``(key, state, scale) -> (state, info)`` for a registered kernel."""
    ks = get_kernel(name)
    kw = dict(static_kwargs)

    def kernel(key, state: SamplerState, scale):
        return ks.step_fn(f, key, state, **{ks.scale_param: scale}, **kw)

    return kernel


register_kernel("rwmh", rwmh_step, needs_grad=False, target_accept=0.234)
register_kernel("mala", mala_step, needs_grad=True, target_accept=0.574)
register_kernel("slice", slice_step, needs_grad=False, target_accept=1.0,
                scale_param="width")
register_kernel("hmc", hmc_step, needs_grad=True, target_accept=0.8)
