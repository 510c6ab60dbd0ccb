"""Parameter-update kernels for the θ | z conditional (paper §2, §4).

Port of :mod:`repro.core.samplers`, chain-batched: the target is
``f(θ (K, ...)) -> (lp (K,), aux)``, keys are ``(K, 2)`` and every chain
makes its own decisions. Gradients come from ``torch.autograd`` (MALA, HMC).
All four of the reference's kernels are here: random-walk
Metropolis–Hastings, MALA, slice sampling and HMC.

Slice sampling's loops run as the reference's do under ``vmap``: every chain
is evaluated on every trip, and a chain whose loop has ended keeps its carry.
Each trip's "has every chain ended?" is read on the host, so a slice step
waits on the card once a trip; the other kernels never wait.
"""

from __future__ import annotations

from functools import partial
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
    # density evaluations this step: an int where every chain makes the
    # same number, else (K,) int32 (slice sampling)
    n_evals: Any


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


def _accept(state, proposed: SamplerState, log_ratio, k_acc, n_evals=1):
    accept_prob = torch.clamp(torch.exp(torch.clamp(log_ratio, max=0.0)), max=1.0)
    accepted = torch.log(jr.uniform(k_acc, ())) < log_ratio
    new = SamplerState(*(_select(accepted, a, b) for a, b in zip(proposed, state)))
    return new, StepInfo(accept_prob, accepted, n_evals)


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


waits = 0  # host waits of slice steps, one a loop check (= evaluations)


def _any(mask: torch.Tensor) -> bool:
    """Whether any chain is still in its loop: one wait on the card."""
    global waits
    waits += 1
    return bool(mask.any())


def slice_step(f: LogDensityFn, key, state: SamplerState, width,
               max_step_out: int = 8, max_shrink: int = 32):
    """Slice sampling (Neal 2003, §4) along a uniformly random direction.

    Stepping out, then shrinkage, each loop capped as in the reference; at
    the shrinkage cap a chain keeps its current point. ``n_evals`` is each
    chain's own count, as the reference's loops give it, and a chain's
    shrinkage key is folded with its own trip count.
    """
    ks = jr.split(key, 4)
    k_dir, k_h, k_u, k_shrink = (ks[:, i] for i in range(4))
    th = state.theta
    d = jr.normal(k_dir, th.shape[1:])
    d = d / _chain(torch.sqrt(flat_tree_sum(torch.square(d))), d)
    log_y = state.lp + torch.log(jr.uniform(k_h, ()))

    def f_at(s):
        return f(th + _chain(s, th) * d)

    # --- stepping out ------------------------------------------------------
    u = jr.uniform(k_u, ())
    lo0, hi0 = -width * u, width * (1.0 - u)

    def expand(b, sign):
        lp_b, _ = f_at(b)
        i = torch.zeros_like(b, dtype=torch.int32)
        while True:
            active = (lp_b > log_y) & (i < max_step_out)
            if not _any(active):
                return b, i + 1  # +1 for the first edge evaluation
            b2 = b + sign * width
            lp2, _ = f_at(b2)
            b = torch.where(active, b2, b)
            lp_b = torch.where(active, lp2, lp_b)
            i = i + active.to(torch.int32)

    lo, n_lo = expand(lo0, -1.0)
    hi, n_hi = expand(hi0, +1.0)

    # --- shrinkage ---------------------------------------------------------
    s = torch.zeros_like(state.lp)
    lp_s, aux_s = state.lp, state.aux
    done = torch.zeros_like(state.lp, dtype=torch.bool)
    i = torch.zeros_like(n_lo)
    active = ~done  # every chain makes the first trip
    for _ in range(max_shrink):
        k = jr.fold_in(k_shrink, i)
        s2 = lo + (hi - lo) * jr.uniform(k, ())
        lp2, aux2 = f_at(s2)
        ok = lp2 > log_y
        upd = active & ok
        lo = torch.where(active & ~ok & (s2 < 0.0), s2, lo)
        hi = torch.where(active & ~ok & (s2 >= 0.0), s2, hi)
        s = torch.where(upd, s2, s)
        lp_s = torch.where(upd, lp2, lp_s)
        aux_s = _select(upd, aux2, aux_s)
        done = done | upd
        i = i + active.to(torch.int32)
        active = ~done & (i < max_shrink)
        if not _any(active):
            break
    theta_new = th + _chain(s, th) * d
    new = SamplerState(theta_new, lp_s, state.grad, aux_s)
    return new, StepInfo(torch.ones_like(state.lp), done, n_lo + n_hi + i)


def hmc_step(f: LogDensityFn, key, state: SamplerState, step_size,
             n_leapfrog: int = 10):
    """Hamiltonian Monte Carlo: ``n_leapfrog`` leapfrog steps with
    gradients through autograd, then one evaluation at the end point."""
    ks = jr.split(key)
    k_mom, k_acc = ks[:, 0], ks[:, 1]
    th = state.theta
    eps = _chain(step_size, th)
    p0 = jr.normal(k_mom, th.shape[1:])
    theta, p, grad = th, p0, state.grad
    for _ in range(n_leapfrog):
        p_half = p + 0.5 * eps * grad
        theta = theta + eps * p_half
        _, _, grad = value_and_grad(f, theta)
        p = p_half + 0.5 * eps * grad
    lp_p, aux_p = f(theta)
    h0 = -state.lp + 0.5 * flat_tree_sum(torch.square(p0))
    h1 = -lp_p + 0.5 * flat_tree_sum(torch.square(p))
    return _accept(state, SamplerState(theta, lp_p, grad, aux_p), h0 - h1,
                   k_acc, n_leapfrog + 1)


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


def make_kernel(name: str, f: LogDensityFn, **kwargs) -> Callable:
    """A named θ-kernel bound to a log-density: ``(key, state, scale)``."""
    return partial(get_kernel(name).step_fn, f, **kwargs)


def bind(name: str, f: LogDensityFn, static_kwargs=()) -> Callable:
    """Uniform ``(key, state, scale) -> (state, info)`` for a registered
    kernel: :func:`make_kernel`, with the scale passed under the kernel's
    own parameter name (``step_size``, or slice's ``width``)."""
    step = make_kernel(name, f, **dict(static_kwargs))
    param = get_kernel(name).scale_param

    def kernel(key, state: SamplerState, scale):
        return step(key, state, **{param: scale})

    return kernel


register_kernel("rwmh", rwmh_step, needs_grad=False, target_accept=0.234)
register_kernel("mala", mala_step, needs_grad=True, target_accept=0.574)
register_kernel("slice", slice_step, needs_grad=False, target_accept=1.0,
                scale_param="width")
register_kernel("hmc", hmc_step, needs_grad=True, target_accept=0.8)
