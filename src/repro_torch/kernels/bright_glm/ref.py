"""Plain PyTorch version of the bright-GLM kernel (``csrc/bright_glm.cu``).

Same inputs and outputs as the kernel (one dataset shared by K chains, or
a stack of L lanes' datasets with K chains each), the same δ formulas
(:mod:`repro_torch.core.numerics`) and the same summation order for the
total: rows summed sequentially within blocks of :data:`BLOCK_ROWS`, then the
blocks sequentially in order (:func:`~repro_torch.core.numerics.blocked_sum`).
Trailing padding blocks add exactly ``+0.0``, so the total is bitwise
independent of the buffer capacity. The wrapper runs it for CPU tensors, the
tests hold it against the JAX package, and it is what the kernel is held
against on the card. It is also the kernel's backward pass.
"""

from __future__ import annotations

import torch

from repro_torch.core.numerics import (
    blocked_sum,
    log_expm1,
    logistic_delta,
    softmax_delta_padded,
    student_t_delta,
    tree_sum,
)

BLOCK_ROWS = 8  # must equal kBlockRows in csrc/bright_glm.cu
FAMILIES = ("logistic", "student_t", "softmax")


def gather_rows(a, idx):
    """Each chain's rows ``a[clamp(idx)]``: ``a`` (N, ...) and idx (K, C)
    → (K, C, ...), or a lane stack ``a`` (L, N, ...) and idx (L, K, C) →
    (L, K, C, ...), chain (l, k) gathering from lane l."""
    lanes = idx.dim() == 3
    i = idx.to(torch.int64).clamp(0, a.shape[int(lanes)] - 1)
    if not lanes:
        return a[i]
    return a[torch.arange(a.shape[0], device=a.device)[:, None, None], i]


def flat_chains(x, t, xi, idx, n_bright, theta):
    """The operands as one flat chain axis: ``(rows (K', C, D), t_rows,
    xi_rows, n_bright (K',), theta (K', ...))`` with K' = K, or L·K for a
    lane stack (x (L, N, D), idx (L, K, C), n_bright (L, K), theta (L, K,
    ...)). Gathers copy values, so a chain's rows are the same bits
    whichever lane stack it came in."""
    rows, t_rows, xi_rows = (gather_rows(a, idx) for a in (x, t, xi))
    lead = idx.shape[:-1]
    if len(lead) == 2:
        k = lead[0] * lead[1]
        rows, t_rows, xi_rows = (a.reshape((k,) + a.shape[2:])
                                 for a in (rows, t_rows, xi_rows))
        n_bright = n_bright.reshape(k)
        theta = theta.reshape((k,) + theta.shape[2:])
    return rows, t_rows, xi_rows, n_bright, theta


def row_scores(rows, theta, family):
    """s = θ_k·x (K, C) or, for softmax, η = Θ_k x (K, C, Kc)."""
    if family == "softmax":
        return tree_sum(rows[:, :, None, :] * theta[:, None, :, :])
    return tree_sum(rows * theta[:, None, :])


def delta_of_scores(scores, t_rows, xi_rows, family, nu=4.0, sigma=1.0):
    """δ = log L - log B per slot from the scores and the gathered t, ξ."""
    if family == "logistic":
        return logistic_delta(t_rows * scores, xi_rows)
    if family == "student_t":
        return student_t_delta(t_rows - scores, xi_rows, nu, sigma)
    if family == "softmax":
        kc = scores.shape[-1]
        onehot = torch.nn.functional.one_hot(t_rows.to(torch.int64), kc)
        return softmax_delta_padded(scores, xi_rows, onehot.to(scores.dtype), kc)
    raise ValueError(f"unknown family {family!r}; expected {FAMILIES}")


def total_of_delta(delta, n_bright):
    """(K,) Σ_{c < n_bright[k]} log_expm1(δ) in the kernel's block order."""
    slots = torch.arange(delta.shape[1], device=delta.device)
    mask = slots[None] < n_bright.to(torch.int64)[:, None]
    contrib = torch.where(mask, log_expm1(delta), torch.zeros_like(delta))
    return blocked_sum(contrib, BLOCK_ROWS)


def bright_glm_ref(x, t, xi, idx, n_bright, theta, family="logistic",
                   nu=4.0, sigma=1.0):
    """Returns (delta (K, C) f32, total (K,) f32); for a lane stack,
    (delta (L, K, C), total (L, K)). Each chain is evaluated on its own, so
    L lanes give what L single-lane calls give."""
    rows, t_rows, xi_rows, nb, th = flat_chains(x, t, xi, idx, n_bright,
                                                theta)
    scores = row_scores(rows, th, family)
    delta = delta_of_scores(scores, t_rows, xi_rows, family, nu, sigma)
    total = total_of_delta(delta, nb)
    return delta.reshape(idx.shape), total.reshape(idx.shape[:-1])
