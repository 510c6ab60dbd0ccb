"""Shared FlyMC numerics: δ and log L̃ math, the counter RNG, fixed-order sums.

Port of :mod:`repro.core.numerics`. Everything here is consumed by the plain
PyTorch versions of both kernels and by the step around them; the CUDA
kernels in ``csrc/`` repeat the same formulas with the same branch structure.

Two rules carried over from the reference:

* the double-``where`` guards and the ``min(d, 80)`` clamp in
  :func:`log_expm1` (``torch.where`` has the same NaN-gradient trap as
  ``jnp.where``);
* softplus is ``logaddexp(x, 0)`` written out (:func:`softplus`), never
  ``F.softplus``, whose ``threshold=20`` switches branches.

Two rules particular to the port:

* Threefry runs on int64 words masked to 32 bits: torch's ``>>`` on int32 is
  arithmetic, the reference's ``shift_right_logical`` is not. Key words are
  int64 tensors holding values in ``[0, 2³²)``.
* Every float reduction that feeds the chain goes through :func:`tree_sum`
  (halving pairwise sums of a zero-padded power-of-two axis, elementwise adds
  only). Its result depends neither on the chain count, nor on a buffer's
  capacity (extra trailing zeros add exactly ``+0.0``), nor on the library's
  reduction strategy for a shape — which is what keeps the port's chains
  bitwise capacity- and batching-invariant on the CPU and on the card.
"""

from __future__ import annotations

import torch

_DELTA_FLOOR = 1e-10  # δ = logL - logB ≥ 0 in exact math; clamp FP noise.
M32 = 0xFFFFFFFF

# Draw-id words: one independent stream per Algorithm-2 decision.
DRAW_DARKEN = 0  # bright → dark accept uniform (u1)
DRAW_CAND = 1  # dark → bright candidate selection (u2)
DRAW_BRIGHT = 2  # candidate brighten accept uniform (u3)

_UNIFORM_BITS = 24  # bits24 ∈ [0, 2^24): exact in f32, u = bits24 · 2⁻²⁴


# ---------------------------------------------------------------------------
# Fixed-order reductions
# ---------------------------------------------------------------------------


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by halving pairwise adds of a zero-padded 2^p axis.

    Element ``i`` pairs with ``i + h`` at every level, so appending zeros to
    the axis (a bigger buffer with masked tail) leaves the result bitwise
    unchanged, and the chain axis never changes how one chain is summed.
    """
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1])
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def flat_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """:func:`tree_sum` over every axis but the leading chain axis."""
    return tree_sum(x.reshape(x.shape[0], -1))


def blocked_sum(x: torch.Tensor, block: int) -> torch.Tensor:
    """Sum a ``(K, C)`` tensor over C the way the bright-GLM kernel does:
    sequentially within blocks of ``block`` rows, then sequentially over the
    blocks in order. Trailing zero blocks add exactly ``+0.0``."""
    k, c = x.shape
    nb = -(-c // block)
    x = torch.nn.functional.pad(x, (0, nb * block - c)).reshape(k, nb, block)
    part = x[..., 0]
    for r in range(1, block):
        part = part + x[..., r]
    total = part[:, 0]
    for b in range(1, nb):
        total = total + part[:, b]
    return total


# ---------------------------------------------------------------------------
# log L̃ and softplus
# ---------------------------------------------------------------------------


def log_expm1(delta: torch.Tensor) -> torch.Tensor:
    """Stable log(exp(δ) - 1) = log L̃ for δ ≥ 0 (double-where guarded)."""
    d = torch.clamp(delta, min=_DELTA_FLOOR)
    small = d < 15.0
    d_small = torch.where(small, d, torch.ones_like(d))
    d_big = torch.where(small, torch.full_like(d, 20.0), d)
    return torch.where(
        small,
        torch.log(torch.expm1(d_small)),
        d_big + torch.log1p(-torch.exp(-torch.clamp(d_big, max=80.0))),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, written out elementwise."""
    amax = torch.clamp(x, min=0.0)
    out = amax + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


# ---------------------------------------------------------------------------
# Counter-based per-datum RNG (shared by the z-update kernel and its plain
# version, and by the step's darken/brighten uniforms)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words.

    Inputs are masked to 32 bits (so int32 words, negative or not, are taken
    as their uint32 bit patterns) and broadcast together; outputs are int64
    in ``[0, 2³²)``. Bit-compatible with ``repro.core.numerics.threefry2x32``
    and with jax's threefry PRNG.
    """
    k0 = torch.as_tensor(k0).to(torch.int64) & M32
    k1 = torch.as_tensor(k1).to(torch.int64) & M32
    x0 = torch.as_tensor(x0).to(torch.int64) & M32
    x1 = torch.as_tensor(x1).to(torch.int64) & M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for r in range(5):
        for d in _ROTATIONS[r % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, d) ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & M32
        x1 = (x1 + ks[(r + 2) % 3] + (r + 1)) & M32
    return x0, x1


def counter_bits24(
    key_words: torch.Tensor, draw_id: int, datum: torch.Tensor
) -> torch.Tensor:
    """24-bit random integers keyed on (step key, draw stream, datum index).

    ``key_words`` is ``(..., 2)`` (one row per chain); ``datum`` is any
    integer tensor whose leading axes broadcast against the key's leading
    axes (``(K, C)`` against ``(K, 2)``). Returns int64 in ``[0, 2²⁴)``.
    """
    extra = datum.dim() - (key_words.dim() - 1)
    k0 = key_words[..., 0].reshape(key_words.shape[:-1] + (1,) * extra)
    k1 = key_words[..., 1].reshape(key_words.shape[:-1] + (1,) * extra)
    b0, _ = threefry2x32(k0, k1, torch.full_like(datum, draw_id,
                                                 dtype=torch.int64), datum)
    return b0 >> (32 - _UNIFORM_BITS)


def counter_uniform(
    key_words: torch.Tensor, draw_id: int, datum: torch.Tensor
) -> torch.Tensor:
    """Per-datum U[0, 1) floats (24-bit grid) from :func:`counter_bits24`."""
    bits = counter_bits24(key_words, draw_id, datum)
    return bits.to(torch.float32) * (1.0 / (1 << _UNIFORM_BITS))


def key_words_of(key: torch.Tensor) -> torch.Tensor:
    """Counter-RNG key words of a port key: the raw ``(..., 2)`` words."""
    return key[..., :2] & M32


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 → their int32 bit patterns."""
    w = words.to(torch.int64) & M32
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


# ---------------------------------------------------------------------------
# Jaakkola–Jordan (logistic) bound pieces
# ---------------------------------------------------------------------------


def jj_a(xi: torch.Tensor) -> torch.Tensor:
    """a(ξ) = -tanh(ξ/2)/(4ξ), with the ξ→0 limit -1/8 handled exactly."""
    tiny = torch.abs(xi) < 1e-4
    safe = torch.where(tiny, torch.ones_like(xi), xi)
    a = -torch.tanh(safe / 2.0) / (4.0 * safe)
    return torch.where(tiny, -0.125 + xi * xi / 96.0, a)


def jj_c(xi: torch.Tensor) -> torch.Tensor:
    """c(ξ) = -a·ξ² + ξ/2 - log(eᶻ+1); tightness: log B(±ξ) = log σ(±ξ)."""
    return -jj_a(xi) * xi * xi + xi / 2.0 - softplus(xi)


def logistic_delta(s: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """δ = log L - log B for the Jaakkola–Jordan bound, s = t·θᵀx."""
    log_l = -softplus(-s)
    log_b = jj_a(xi) * s * s + 0.5 * s + jj_c(xi)
    return log_l - log_b


# ---------------------------------------------------------------------------
# Student-t tangent bound
# ---------------------------------------------------------------------------


def student_t_delta(
    r: torch.Tensor, xi: torch.Tensor, nu: float, sigma: float
) -> torch.Tensor:
    """δ for the tangent-in-r² Gaussian bound; ``r`` = t - θᵀx."""
    z2 = (r / sigma) ** 2
    u0 = (xi / sigma) ** 2
    h = (nu + 1.0) / 2.0
    fprime = -h / (nu + u0)
    f_z = -h * torch.log1p(z2 / nu)
    f_u0 = -h * torch.log1p(u0 / nu)
    return f_z - (f_u0 + fprime * (z2 - u0))


# ---------------------------------------------------------------------------
# Böhning (softmax) bound
# ---------------------------------------------------------------------------


def softmax_delta_padded(
    eta: torch.Tensor,  # (..., Kp) logits θx, columns ≥ n_classes are padding
    eta0: torch.Tensor,  # (..., Kp) tangency logits, same padding
    t_onehot: torch.Tensor,  # (..., Kp) one-hot labels (0 on padding)
    n_classes: int,
) -> torch.Tensor:
    """δ = log L - log B for the Böhning bound on (..., Kp) logits.

    Padding columns are excluded from every reduction; with ``Kp ==
    n_classes`` (the port's kernels need no lane padding) this is the
    unpadded formula. Class sums use :func:`tree_sum`.
    """
    col = torch.arange(eta.shape[-1], device=eta.device)
    valid = col < n_classes
    neg = torch.full_like(eta, -1e30)

    def lse(e):
        e_m = torch.where(valid, e, neg)
        m = e_m.max(dim=-1, keepdim=True).values
        ex = torch.where(valid, torch.exp(e_m - m), torch.zeros_like(e))
        return m + torch.log(tree_sum(ex)[..., None])

    zero = torch.zeros_like(eta)
    lse0 = lse(eta0)
    at_t = lambda e: tree_sum(t_onehot * torch.where(valid, e, zero))
    ll_eta = at_t(eta) - lse(eta)[..., 0]
    ll_eta0 = at_t(eta0) - lse0[..., 0]
    g = t_onehot - torch.where(valid, torch.exp(eta0 - lse0), zero)
    d = torch.where(valid, eta - eta0, zero)
    a_d = 0.5 * (d - tree_sum(d)[..., None] / n_classes)
    quad = tree_sum(d * a_d)
    log_b = ll_eta0 + tree_sum(g * d) - 0.5 * quad
    return ll_eta - log_b
