"""MCMC output analysis: autocorrelation, ESS, R-hat (paper §4, Table 1).

The port's own copy of :mod:`repro.core.diagnostics` (numpy only; the port
imports nothing of the JAX package). The paper reports "effective samples
per 1000 iterations" computed with R-CODA. We implement the standard
initial-monotone-positive-sequence estimator (Geyer 1992) of the integrated
autocorrelation time τ, giving ESS = n/τ. Host-side numpy: these are the
offline estimators. The streaming path (:mod:`repro_torch.api.collectors`)
reuses the moment→estimate functions here (:func:`rhat_from_split_moments`,
:func:`tau_from_batch_means`) so online and offline results cannot drift.

Everything is vectorized over a trailing coordinate axis: ``(n,)`` chains
behave exactly as before (bitwise — the batched FFT and the masked lag loop
perform the identical per-column operations), and ``(n, D)`` inputs run one
batched rfft instead of D Python-loop FFT passes.
"""

from __future__ import annotations

import numpy as np


def autocovariance(x: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Biased autocovariance estimates via FFT, lags 0..max_lag.

    ``x`` is ``(n,)`` or ``(n, D)``; the transform runs along axis 0 (one
    batched rfft for all D coordinates).
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if max_lag is None:
        max_lag = n - 1
    xc = x - x.mean(axis=0)
    size = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), size, axis=0)[: max_lag + 1].real / n
    return acov


def _taus(x: np.ndarray) -> np.ndarray:
    """Geyer τ per coordinate of an (n, D) chain array, vectorized.

    One batched FFT; the initial-monotone-positive-sequence truncation runs
    as a masked loop over lag pairs (early exit once every coordinate has
    terminated), performing per-column exactly the scalar estimator's
    operations — a 1-column input reproduces the scalar path bitwise.
    Degenerate coordinates (n < 4, constant chain, non-positive variance)
    report τ = n, as before.
    """
    x = np.asarray(x, np.float64)
    n, d = x.shape
    fallback = np.full(d, float(n))
    if n < 4:
        return fallback
    # per-coordinate np.allclose(x, x[0]) (rtol=1e-5, atol=1e-8)
    degenerate = np.all(
        np.abs(x - x[0]) <= 1e-8 + 1e-5 * np.abs(x[0]), axis=0
    )
    acov = autocovariance(x)
    ok = ~degenerate & (acov[0] > 0)
    if not ok.any():
        return fallback
    rho = acov / np.where(acov[0] > 0, acov[0], 1.0)
    # Pair sums Γ_k = ρ_{2k} + ρ_{2k+1}; keep while positive and monotone.
    max_pairs = (rho.shape[0] - 1) // 2
    tau = np.zeros(d)
    prev = np.full(d, np.inf)
    active = ok.copy()
    for k in range(max_pairs):
        if not active.any():
            break
        gamma = rho[2 * k] + rho[2 * k + 1]
        active &= gamma > 0
        gamma = np.minimum(gamma, prev)  # enforce monotone decrease
        prev = np.where(active, gamma, prev)
        tau = np.where(active, tau + 2.0 * gamma, tau)
    # τ = -1 + 2 Σ_k Γ_k  (Γ_0 = ρ_0 + ρ_1; iid chain → τ = 1)
    return np.where(ok, np.maximum(tau - 1.0, 1.0), fallback)


def integrated_autocorr_time(x: np.ndarray) -> float:
    """Geyer initial monotone positive sequence estimator of τ (1-D chain)."""
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError("integrated_autocorr_time expects a 1-D chain; "
                         "effective_sample_size handles (n, D)")
    return float(_taus(x[:, None])[0])


def effective_sample_size(x: np.ndarray) -> float:
    """ESS of a 1-D chain; for (n, D), the per-coordinate minimum."""
    x = np.asarray(x)
    n = x.shape[0]
    if x.ndim == 1:
        return n / integrated_autocorr_time(x)
    return float((n / _taus(x)).min())


def ess_per_1000_iters(x: np.ndarray) -> float:
    """The paper's Table-1 metric."""
    x = np.asarray(x)
    return 1000.0 * effective_sample_size(x) / x.shape[0]


def rhat_from_split_moments(count, means, variances):
    """Split-R̂ from per-split first/second moments — the shared estimator.

    ``count`` is the per-split length h; ``means``/``variances`` are the
    per-split sample means and ``ddof=1`` variances, shape ``(k,)`` or
    ``(k, D)`` for k splits. Both the offline :func:`split_r_hat` (two-pass
    numpy moments) and the streaming :class:`repro.api.collectors.RHat`
    (Welford carries) feed this same function.
    """
    means = np.asarray(means, np.float64)
    variances = np.asarray(variances, np.float64)
    w = variances.mean(axis=0)
    b = count * means.var(axis=0, ddof=1)
    var_plus = (count - 1) / count * w + b / count
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(w > 0, np.sqrt(var_plus / w), np.inf)
    return out if means.ndim > 1 else float(out)


def split_r_hat(chains: np.ndarray) -> float:
    """Split-R̂ (Gelman et al.) over chains of shape (n_chains, n_iters).

    A ``(n_chains, n_iters, D)`` input reduces per-coordinate and returns
    the maximum R̂ — the coordinate that binds convergence.
    """
    chains = np.asarray(chains, np.float64)
    half = chains.shape[1] // 2
    splits = np.concatenate([chains[:, :half], chains[:, half : 2 * half]], 0)
    means = splits.mean(axis=1)
    variances = splits.var(axis=1, ddof=1)
    if chains.ndim == 3:  # one vectorized pass over the coordinate axis
        return float(np.max(rhat_from_split_moments(half, means, variances)))
    return float(rhat_from_split_moments(half, means, variances))


def tau_from_batch_means(batch_means, batch_len: int, chain_var):
    """Batch-means τ̂ = batch_len · Var(batch means) / Var(chain).

    ``batch_means`` is ``(B,)`` or ``(B, D)``; ``chain_var`` the matching
    whole-chain ``ddof=1`` variance. Shared by the offline
    :func:`batch_means_ess` and the streaming
    :class:`repro.api.collectors.BatchMeansESS`. Zero-variance chains report
    τ = B·batch_len (one effective sample), matching the Geyer convention.
    """
    batch_means = np.asarray(batch_means, np.float64)
    chain_var = np.asarray(chain_var, np.float64)
    vb = batch_means.var(axis=0, ddof=1)
    n_total = float(batch_means.shape[0] * batch_len)
    with np.errstate(divide="ignore", invalid="ignore"):
        tau = np.where(chain_var > 0, batch_len * vb / chain_var, n_total)
    return tau


def batch_means_ess(x: np.ndarray, num_batches: int = 32) -> float:
    """Offline batch-means ESS of a chain ``(n,)`` or ``(n, D)``.

    Mirrors the streaming collector's truncation exactly: batches are
    ``batch_len = max(1, n // num_batches)`` long and iterations past
    ``num_batches · batch_len`` are dropped. Coarser than the Geyer
    estimator but computable as a pure streaming reduction; the two agree
    on well-behaved chains.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    batch_len = max(1, n // num_batches)
    n_used = min(n, num_batches * batch_len)
    nb = n_used // batch_len
    if nb < 2 or n_used < 2:
        return float("nan")
    used = x[: nb * batch_len]
    batch_means = used.reshape(nb, batch_len, -1).mean(axis=1)
    chain_var = x[:n_used].var(axis=0, ddof=1)
    tau = np.maximum(
        tau_from_batch_means(batch_means, batch_len, chain_var), 1.0
    )
    return float((n_used / tau).min())
