"""Plain PyTorch version of the bright-GLM kernel (``csrc/bright_glm.cu``).

Same inputs and outputs as the kernel (one dataset shared by K chains, or
a stack of L lanes' datasets with K chains each), the same δ formulas
(:mod:`repro_torch.core.numerics`; η by elementwise products and
``tree_sum``, or, for a softmax past the register kernel, by fixed-shape
blocked matmuls) and the same summation order for the total: rows summed sequentially within blocks of :data:`BLOCK_ROWS`, then the
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
MAX_CLASSES = 16  # kMaxClasses in csrc/bright_glm.cu
SMEM_BYTES = 48 * 1024  # the register kernel stages Θ_k in shared memory
# A softmax past the register kernel (an LM head: Kc = 128,256, D = 3,072)
# takes its products as matmuls of a fixed shape, SLOT_BLOCK slots at a
# time: an elementwise (C, Kc, D) product would be 1.6 TB.
SLOT_BLOCK = 64


def register_path(kt: int, d: int) -> bool:
    """Whether θ's ``kt`` classes × D go to the register kernel (all of Θ_k
    in shared memory, η in registers); a softmax past it goes to the wide
    kernel, and its plain version to :func:`wide_scores`."""
    return kt <= MAX_CLASSES and kt * d * 4 <= SMEM_BYTES


def _slot_blocks(a):
    """(K, C, ...) → (K, C', ...) zero-padded to whole ``SLOT_BLOCK`` s, and
    the blocks' first slots."""
    pad = -a.shape[1] % SLOT_BLOCK
    a = torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
    return a, range(0, a.shape[1], SLOT_BLOCK)


def wide_scores(rows, theta):
    """η = Θ_k x (K, C, Kc) for a wide softmax: per chain and block of
    ``SLOT_BLOCK`` slots one (SLOT_BLOCK, D) × (D, Kc) ``torch.matmul`` on
    fresh operands. Every product has that shape and each output row is a
    dot product of its own slot's row, so a slot's η is the same bits
    whatever the capacity, the chain count or the lane stack."""
    c = rows.shape[1]
    rp, starts = _slot_blocks(rows)
    out = []
    for k in range(rows.shape[0]):
        th_t = theta[k].clone().t()
        out.append(torch.cat([torch.matmul(rp[k, b:b + SLOT_BLOCK].clone(),
                                           th_t) for b in starts])[:c])
    return torch.stack(out)


def wide_theta_grad(g_scores, rows):
    """Σ_c g_scores[k, c] ⊗ rows[k, c] (K, Kc, D) for a wide softmax: per
    chain one (Kc, SLOT_BLOCK) × (SLOT_BLOCK, D) ``torch.matmul`` a block,
    the blocks summed in order. Slots past the bright count have zero
    cotangents, so their blocks add exact zeros: the gradient is the same
    bits whatever the capacity."""
    gp, starts = _slot_blocks(g_scores)
    rp, _ = _slot_blocks(rows)
    out = []
    for k in range(g_scores.shape[0]):
        acc = None
        for b in starts:
            part = torch.matmul(gp[k, b:b + SLOT_BLOCK].clone().t(),
                                rp[k, b:b + SLOT_BLOCK].clone())
            acc = part if acc is None else acc + part
        out.append(acc)
    return torch.stack(out)


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
    """s = θ_k·x (K, C) or, for softmax, η = Θ_k x (K, C, Kc): elementwise
    products summed by ``tree_sum``, or :func:`wide_scores` past the
    register kernel."""
    if family == "softmax":
        if not register_path(theta.shape[1], rows.shape[-1]):
            return wide_scores(rows, theta)
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
