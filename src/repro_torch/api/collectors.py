"""Streaming observables over the sampling trajectory, chain-batched.

Port of :mod:`repro.api.collectors`: :class:`FullTrace`,
:class:`ThinnedTrace`, :class:`OnlineMoments`, :class:`RHat`,
:class:`BatchMeansESS`, :class:`PosteriorPredictive` and
:class:`QueryBudget`. A collector is an ``(init, update, finalize)``
reduction whose carry lives on the device:

  * ``init(num_samples, position, stats) -> carry`` — ``position`` (K, ...)
    and ``stats`` (a StepStats of (K,) leaves) are examples for shapes and
    dtypes only (``SamplingAlgorithm.output_structs`` gives zeros);
  * ``update(carry, position, stats) -> carry`` — one committed step, all
    chains at once. Updates write into the carry's tensors in place;
  * ``finalize(carry) -> result`` — host-side; cross-chain reductions (R̂)
    happen here;
  * ``peek(carry) -> result`` — optional non-destructive mid-run read. The
    default (the :class:`Collector` base and the module-level :func:`peek`)
    finalizes a deep clone of the carry: since updates write in place, a
    result that aliased the live carry would change under the next chunk.
    A peek-then-continue run is bitwise one that never peeked.

The driver updates carries only with committed chunks (after the overflow
check), so every result is bitwise invariant to capacity and chunking like
the trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import diagnostics
from repro_torch.core.flymc import StepStats
from repro_torch.core.numerics import tree_sum


def clone_carry(carry):
    """A deep copy of a carry: every tensor cloned, containers rebuilt,
    host scalars shared (they are immutable). What a peek finalizes, and
    what a serve engine folds a chunk into, so that a fold that raises
    halfway leaves the live carry as it was."""
    if isinstance(carry, torch.Tensor):
        return carry.clone()
    if isinstance(carry, dict):
        return {k: clone_carry(v) for k, v in carry.items()}
    if isinstance(carry, tuple) and hasattr(carry, "_fields"):
        return type(carry)(*(clone_carry(v) for v in carry))
    if isinstance(carry, (list, tuple)):
        return type(carry)(clone_carry(v) for v in carry)
    return carry


class Collector:
    """Optional base class for collectors: supplies the default ``peek``."""

    def peek(self, carry):
        """The would-be result of ``finalize(carry)``, read without touching
        the live carry: ``finalize`` runs on a deep clone, so nothing in the
        result aliases tensors that the next chunk's updates write."""
        return self.finalize(clone_carry(carry))


def peek(collector, carry):
    """``collector.peek(carry)``, or, for a bare-protocol collector without
    one, ``finalize`` on a deep clone of the carry (never the carry
    itself). The chunk-boundary read of ``ChunkEvent.peek`` and of the
    :mod:`repro_torch.serve` service."""
    fn = getattr(collector, "peek", None)
    if callable(fn):
        return fn(carry)
    return collector.finalize(clone_carry(carry))


@dataclasses.dataclass(eq=False)
class FullTrace(Collector):
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
class ThinnedTrace(Collector):
    """Every ``thin``-th θ: ``theta[:, thin-1::thin]``, (K, S // thin, ...).

    Entry ``i`` is iteration ``(i+1)·thin - 1``, the last of each window; a
    trailing partial window contributes nothing.
    """

    thin: int = 1

    def __post_init__(self):
        if self.thin < 1:
            raise ValueError("thin must be >= 1")

    def init(self, num_samples, position, stats):
        kept = num_samples // self.thin
        return {"n": 0, "theta": position.new_zeros(
            (position.shape[0], kept) + position.shape[1:])}

    def update(self, carry, position, stats):
        n = carry["n"]
        kept = carry["theta"].shape[1]
        if kept and n % self.thin == self.thin - 1:
            carry["theta"][:, min(n // self.thin, kept - 1)] = position
        carry["n"] = n + 1
        return carry

    def finalize(self, carry):
        return {"theta": carry["theta"]}


@dataclasses.dataclass(eq=False)
class OnlineMoments(Collector):
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
class RHat(Collector):
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

    def peek(self, carry):
        """Mid-run R̂ over the splits that hold at least two samples, pooled
        at the length of the shortest of them; ``r_hat = inf`` ("not
        converged yet") while fewer than two splits qualify. Reads the carry
        only: a peek-then-continue run is bitwise one that never peeked."""
        mean = carry["mean"].cpu().numpy().astype(np.float64)
        m2 = carry["m2"].cpu().numpy().astype(np.float64)
        c, _, d = mean.shape
        counts = np.tile(np.asarray(carry["count"], np.int64), c)  # (2C,)
        usable = counts >= 2
        if int(usable.sum()) < 2:
            return {"r_hat": float("inf"), "per_coordinate": None,
                    "splits_used": int(usable.sum())}
        h = int(counts[usable].min())
        means = mean.reshape(2 * c, d)[usable]
        variances = m2.reshape(2 * c, d)[usable] / (counts[usable, None] - 1)
        per = np.atleast_1d(
            diagnostics.rhat_from_split_moments(h, means, variances))
        return {"r_hat": float(per.max()), "per_coordinate": per,
                "splits_used": int(usable.sum())}


@dataclasses.dataclass(eq=False)
class BatchMeansESS(Collector):
    """Batch-means τ and ESS per chain and coordinate.

    The carry holds ``num_batches`` running batch means and Welford chain
    moments; iterations past ``num_batches · batch_len`` are ignored, as
    :func:`repro_torch.core.diagnostics.batch_means_ess` truncates.
    """

    num_batches: int = 32

    def __post_init__(self):
        if self.num_batches < 2:
            raise ValueError("num_batches must be >= 2")

    def init(self, num_samples, position, stats):
        k = position.shape[0]
        d = position[0].numel()
        return {"batch_len": max(1, num_samples // self.num_batches), "n": 0,
                "batch_mean": position.new_zeros(k, self.num_batches, d),
                "count": 0, "mean": position.new_zeros(k, d),
                "m2": position.new_zeros(k, d)}

    def update(self, carry, position, stats):
        n, batch_len = carry["n"], carry["batch_len"]
        if n < self.num_batches * batch_len:
            x = position.reshape(position.shape[0], -1)
            idx = n // batch_len
            j = n - idx * batch_len + 1  # 1-based place in the batch
            cur = carry["batch_mean"][:, idx]
            carry["batch_mean"][:, idx] = cur + (x - cur) / float(j)
            cnt = carry["count"] + 1
            delta = x - carry["mean"]
            mean = carry["mean"] + delta / float(cnt)
            carry["m2"] = carry["m2"] + delta * (x - mean)
            carry["mean"] = mean
            carry["count"] = cnt
        carry["n"] = n + 1
        return carry

    def finalize(self, carry):
        batch_len = carry["batch_len"]
        bm = carry["batch_mean"].cpu().numpy().astype(np.float64)
        m2 = carry["m2"].cpu().numpy().astype(np.float64)
        c, _, d = bm.shape
        nu = carry["count"]
        tau = np.full((c, d), np.nan)
        ess = np.full((c,), np.nan)
        nb = nu // batch_len
        if nb >= 2 and nu >= 2:
            for i in range(c):
                t = diagnostics.tau_from_batch_means(bm[i, :nb], batch_len,
                                                     m2[i] / (nu - 1))
                tau[i] = np.maximum(t, 1.0)
                ess[i] = (nu / tau[i]).min()
        return {"tau": tau, "ess": ess, "count": np.full(c, nu)}


def _default_predict(theta, x_eval):
    """The logistic GLM's ``sigmoid(x_eval @ θ)`` for θ (K, D): (K, M).
    A fixed-order sum, not a matmul, so a chain's value does not depend on
    how many chains ride along."""
    return torch.sigmoid(tree_sum(theta[:, None, :] * x_eval[None]))


@dataclasses.dataclass(eq=False)
class PosteriorPredictive(Collector):
    """Running posterior-mean predictive probability at fixed points.

    ``predict_fn(theta (K, ...), x_eval) -> (K, ...)`` is chain-batched and
    defaults to the logistic GLM's ``sigmoid(x_eval @ θ)``.
    """

    x_eval: Any = None
    predict_fn: Callable | None = None

    def __post_init__(self):
        if self.x_eval is None:
            raise ValueError("PosteriorPredictive needs x_eval")
        self.x_eval = torch.as_tensor(self.x_eval)

    def _predict(self, position, x):
        return (self.predict_fn or _default_predict)(position, x)

    def init(self, num_samples, position, stats):
        # The evaluation points ride in the carry, on the chain's device.
        x = self.x_eval.to(position.device)
        return {"count": 0, "x": x,
                "mean": torch.zeros_like(self._predict(position, x))}

    def update(self, carry, position, stats):
        p = self._predict(position, carry["x"])
        n1 = carry["count"] + 1
        carry["mean"] = carry["mean"] + (p - carry["mean"]) / float(n1)
        carry["count"] = n1
        return carry

    def finalize(self, carry):
        k = carry["mean"].shape[0]
        return {"count": np.full(k, carry["count"]),
                "mean_prob": carry["mean"].cpu().numpy()}


@dataclasses.dataclass(eq=False)
class QueryBudget(Collector):
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


__all__ = [
    "BatchMeansESS",
    "Collector",
    "FullTrace",
    "OnlineMoments",
    "PosteriorPredictive",
    "QueryBudget",
    "RHat",
    "ThinnedTrace",
    "clone_carry",
    "peek",
    "validate_collectors",
]
