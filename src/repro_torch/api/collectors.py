"""Streaming observables over the sampling trajectory, chain-batched.

Port of the four :mod:`repro.api.collectors` the quickstart uses:
:class:`FullTrace`, :class:`OnlineMoments`, :class:`RHat` and
:class:`QueryBudget`. A collector is an ``(init, update, finalize)``
reduction whose carry lives on the device:

  * ``init(num_samples, position, stats) -> carry`` — ``position`` (K, ...)
    and ``stats`` (a StepStats of (K,) leaves) are examples for shapes;
  * ``update(carry, position, stats) -> carry`` — one committed step, all
    chains at once;
  * ``finalize(carry) -> result`` — host-side; cross-chain reductions (R̂)
    happen here.

The driver updates carries only with committed chunks (after the overflow
check), so every result is bitwise invariant to capacity and chunking like
the trajectory. ``ThinnedTrace``, ``BatchMeansESS`` and
``PosteriorPredictive`` wait for a later slice (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import diagnostics
from repro_torch.core.flymc import StepStats


@dataclasses.dataclass(eq=False)
class FullTrace:
    """Every θ sample plus per-iteration StepStats: (K, S, ...) buffers."""

    with_stats: bool = True

    def init(self, num_samples, position, stats):
        buf = lambda a: a.new_zeros((a.shape[0], num_samples) + a.shape[1:])
        carry = {"n": 0, "theta": buf(position)}
        if self.with_stats:
            carry["stats"] = StepStats(*(buf(a) for a in stats))
        return carry

    def update(self, carry, position, stats):
        n = carry["n"]
        carry["theta"][:, n] = position
        if self.with_stats:
            for b, a in zip(carry["stats"], stats):
                b[:, n] = a
        carry["n"] = n + 1
        return carry

    def finalize(self, carry):
        out = {"theta": carry["theta"]}
        if self.with_stats:
            out["stats"] = carry["stats"]
        return out


@dataclasses.dataclass(eq=False)
class OnlineMoments:
    """Welford running mean (and covariance) of θ per chain."""

    cov: bool = True

    def init(self, num_samples, position, stats):
        k = position.shape[0]
        d = position[0].numel()
        carry = {"count": 0, "shape": tuple(position.shape[1:]),
                 "mean": position.new_zeros(k, d)}
        if self.cov:
            carry["m2"] = position.new_zeros(k, d, d)
        return carry

    def update(self, carry, position, stats):
        x = position.reshape(position.shape[0], -1)
        n1 = carry["count"] + 1
        delta = x - carry["mean"]
        mean = carry["mean"] + delta / float(n1)
        carry["mean"] = mean
        if self.cov:
            carry["m2"] = carry["m2"] + delta[:, :, None] * (x - mean)[:, None, :]
        carry["count"] = n1
        return carry

    def finalize(self, carry):
        k = carry["mean"].shape[0]
        count = np.full(k, carry["count"])
        mean = carry["mean"].cpu().numpy()
        out = {"count": count, "mean": mean.reshape((k,) + carry["shape"])}
        if self.cov:
            m2 = carry["m2"].cpu().numpy().astype(np.float64)
            out["cov"] = m2 / max(carry["count"] - 1, 1)
        return out


@dataclasses.dataclass(eq=False)
class RHat:
    """Split-chain R̂ from streamed per-half Welford moments."""

    def init(self, num_samples, position, stats):
        k = position.shape[0]
        d = position[0].numel()
        return {"half": num_samples // 2, "n": 0, "count": [0, 0],
                "mean": position.new_zeros(k, 2, d),
                "m2": position.new_zeros(k, 2, d)}

    def update(self, carry, position, stats):
        half, n = carry["half"], carry["n"]
        if n < 2 * half:
            x = position.reshape(position.shape[0], -1)
            split = 0 if n < half else 1
            cnt = carry["count"][split] + 1
            mean0 = carry["mean"][:, split]
            delta = x - mean0
            mean = mean0 + delta / float(cnt)
            carry["m2"][:, split] = carry["m2"][:, split] + delta * (x - mean)
            carry["mean"][:, split] = mean
            carry["count"][split] = cnt
        carry["n"] = n + 1
        return carry

    def finalize(self, carry):
        h = carry["count"][0]
        if h < 2:
            return {"r_hat": float("nan"), "per_coordinate": None}
        mean = carry["mean"].cpu().numpy().astype(np.float64)
        m2 = carry["m2"].cpu().numpy().astype(np.float64)
        c, _, d = mean.shape
        per = diagnostics.rhat_from_split_moments(
            h, mean.reshape(2 * c, d), m2.reshape(2 * c, d) / (h - 1)
        )
        per = np.atleast_1d(per)
        return {"r_hat": float(per.max()), "per_coordinate": per}


@dataclasses.dataclass(eq=False)
class QueryBudget:
    """Exact int64 likelihood-query accounting over all chains."""

    def init(self, num_samples, position, stats):
        return {"total": torch.zeros_like(stats.lik_queries, dtype=torch.int64)}

    def update(self, carry, position, stats):
        carry["total"] = carry["total"] + stats.lik_queries.to(torch.int64)
        return carry

    def finalize(self, carry):
        return int(carry["total"].sum().item())


def validate_collectors(collectors: dict) -> dict:
    """Check a user-supplied ``{name: collector}`` dict."""
    if not isinstance(collectors, dict):
        raise TypeError("collectors must be a {name: collector} dict")
    for name, col in collectors.items():
        if not isinstance(name, str):
            raise TypeError(f"collector names must be strings, got {name!r}")
        for attr in ("init", "update", "finalize"):
            if not callable(getattr(col, attr, None)):
                raise TypeError(
                    f"collector {name!r} ({type(col).__name__}) does not "
                    "implement the (init, update, finalize) protocol"
                )
    return dict(collectors)
