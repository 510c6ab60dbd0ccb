"""Bayesian GLMs for the paper's three experiments (§4.1–§4.3).

Port of :mod:`repro.models.bayes_glm`: a bound, a prior, data and
sufficient statistics in one object; the full-data posterior (the "Regular
MCMC" baseline of Table 1); MAP estimation by Adam ascent and MAP-tuned
bounds. Densities take θ with a leading chain axis and return ``(K,)``; the
MAP estimate is one θ of ``theta_shape``. The full-data ``x @ θ`` is a plain
``torch.matmul``, as it is plain XLA in the reference.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from repro_torch import random as jr
from repro_torch.core import bounds as bounds_lib
from repro_torch.core import flymc
from repro_torch.core.bounds import GLMData
from repro_torch.device import resolve_device


def _on(data: GLMData, device) -> GLMData:
    dev = resolve_device(device)
    return GLMData(*(a.to(dev) for a in data))


@dataclasses.dataclass
class GLMModel:
    bound: Any
    log_prior: Callable[[torch.Tensor], torch.Tensor]
    data: GLMData
    stats: bounds_lib.CollapsedStats
    theta_shape: tuple

    @classmethod
    def logistic(cls, data: GLMData, prior_scale: float = 1.0, xi: float = 1.5,
                 device="cuda"):
        """§4.1: logistic regression, Jaakkola–Jordan bound, Gaussian prior."""
        bound = bounds_lib.LogisticBound()
        data = bound.default_xi(_on(data, device), xi)
        return cls(bound, partial(bounds_lib.gaussian_log_prior, scale=prior_scale),
                   data, bound.suffstats(data), (data.x.shape[1],))

    @classmethod
    def softmax(cls, data: GLMData, n_classes: int, prior_scale: float = 1.0,
                device="cuda"):
        """§4.2: softmax classification, Böhning bound, Gaussian prior."""
        bound = bounds_lib.SoftmaxBound()
        data = bound.default_xi(_on(data, device), n_classes)
        data = data._replace(t=data.t.to(torch.int64))
        return cls(bound, partial(bounds_lib.gaussian_log_prior, scale=prior_scale),
                   data, bound.suffstats(data), (n_classes, data.x.shape[1]))

    @classmethod
    def robust(cls, data: GLMData, nu: float = 4.0, sigma: float = 1.0,
               prior_scale: float = 1.0, device="cuda"):
        """§4.3: robust Student-t regression, tangent bound, Laplace prior."""
        bound = bounds_lib.StudentTBound(nu=nu, sigma=sigma)
        data = bound.default_xi(_on(data, device))
        return cls(bound, partial(bounds_lib.laplace_log_prior, scale=prior_scale),
                   data, bound.suffstats(data), (data.x.shape[1],))

    @property
    def device(self) -> torch.device:
        return self.data.x.device

    def full_log_posterior(self, theta: torch.Tensor) -> torch.Tensor:
        """Exact full-data log posterior for θ (K, ...) → (K,)."""
        return self.log_prior(theta) + self.bound.log_lik(theta, self.data).sum(-1)

    def full_logpdf_fn(self):
        """(lp, aux) form for the θ-kernels; aux is a dummy (K,) zero."""

        def f(theta):
            lp = self.full_log_posterior(theta)
            return lp, torch.zeros_like(lp)

        return f

    def map_estimate(self, key, steps: int = 500, lr: float = 0.05,
                     theta0=None) -> torch.Tensor:
        """Adam ascent on the full-data log posterior (≈ the paper's SGD)."""
        if theta0 is None:
            theta0 = 0.01 * jr.normal(key.to(self.device), self.theta_shape)
        th = theta0.detach().clone()
        m = torch.zeros_like(th)
        v = torch.zeros_like(th)
        t = torch.zeros((), dtype=th.dtype, device=th.device)
        for _ in range(steps):
            x = th.detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(-self.full_log_posterior(x[None])[0], x)
            t = t + 1
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - 0.9**t)
            vh = v / (1.0 - 0.999**t)
            th = th - lr * mh / (torch.sqrt(vh) + 1e-8)
        return th

    def map_tuned(self, theta_map: torch.Tensor) -> "GLMModel":
        """Retighten bounds at θ_MAP and rebuild suff-stats (one-time cost)."""
        data = self.bound.tighten(theta_map, self.data)
        return dataclasses.replace(self, data=data, stats=self.bound.suffstats(data))

    # ---- api glue ------------------------------------------------------------

    def algorithm(self, **kw):
        """FlyMC SamplingAlgorithm over this model (see ``api.firefly``)."""
        from repro_torch import api

        return api.firefly(self, **{"device": self.device, **kw})

    def baseline(self, **kw):
        """Full-data MCMC SamplingAlgorithm (see ``api.regular_mcmc``)."""
        from repro_torch import api

        return api.regular_mcmc(self, **{"device": self.device, **kw})

    def init_chain(self, spec, theta0, key, **kw):
        """Deprecated: ``api.sample`` initializes internally
        (:func:`repro_torch.core.flymc.init_chain`)."""
        return flymc.init_chain(spec, self.data, self.stats, theta0, key, **kw)

    def run_chain(self, spec, state, num_iters, **kw):
        """Deprecated: delegates to the driver
        (:func:`repro_torch.core.flymc.run_chain`)."""
        return flymc.run_chain(spec, self.data, self.stats, state, num_iters,
                               **kw)

    def flymc_spec(self, kernel: str = "rwmh", capacity: int = 1024,
                   cand_capacity: int = 1024, q_db: float = 0.01,
                   mode: str = "implicit", **kw) -> flymc.FlyMCSpec:
        """A :class:`FlyMCSpec` over this model (for
        ``api.algorithm_from_spec``); capacities are capped at N."""
        n = self.data.x.shape[0]
        return flymc.FlyMCSpec(
            bound=self.bound, log_prior=self.log_prior, kernel=kernel,
            capacity=min(capacity, n), cand_capacity=min(cand_capacity, n),
            q_db=q_db, mode=mode, **kw,
        )


def run_regular_mcmc(model: GLMModel, theta0: torch.Tensor, key: torch.Tensor,
                     num_iters: int, kernel: str = "rwmh",
                     step_size: float = 0.05, **kernel_kwargs):
    """Full-data MCMC baseline, one chain (deprecated shim over
    ``api.regular_mcmc`` and ``api.sample``). Returns (samples, likelihood
    queries per iteration)."""
    from repro_torch import api

    alg = api.regular_mcmc(model, kernel=kernel, step_size=step_size,
                           kernel_params=tuple(kernel_kwargs.items()),
                           device=model.device)
    trace = api.sample(alg, key, num_iters, init_position=theta0,
                       device=model.device)
    samples = list(trace.theta[0])
    queries = [int(q) for q in trace.stats.lik_queries[0].tolist()]
    return samples, queries
