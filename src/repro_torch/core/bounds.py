"""Collapsible likelihood lower bounds (paper §3.1), chain-batched.

Port of :mod:`repro.core.bounds`. θ always carries a leading chain axis:
``(K, D)`` for the logistic and Student-t bounds, ``(K, Kc, D)`` for the
softmax bound; per-datum results are ``(K, N)`` and collapsed products
``(K,)``. The collapsed quadratic forms are summed with
:func:`repro_torch.core.numerics.tree_sum`, so a chain's value does not
depend on how many chains ride along. ``collapsed`` also takes statistics
with a leading chain axis, each chain's own (the sampling service's lane
stacks, where chains of different datasets step together), with the same
bits as the shared statistics give. :func:`psum_stats` sums statistics
over the ranks that hold a dataset's shards.

Surface of every bound:

    log_lik(theta, data)          -> (K, N) per-datum log L_n(θ)
    log_bound(theta, data)        -> (K, N) per-datum log B_n(θ)
    suffstats(data)               -> CollapsedStats  (one-time, O(N·D²))
    collapsed(theta, stats)       -> (K,) Σ_n log B_n(θ)  (O(D²) per θ)
    tighten(theta_map, data)      -> data with per-datum tightness at θ_MAP
"""

from __future__ import annotations

import math
from typing import NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.core.numerics import flat_tree_sum, jj_a, jj_c, softplus, tree_sum


class GLMData(NamedTuple):
    """x (N, D) f32; t (N,) labels ±1 / class ids (int64) / responses;
    xi (N,) tightness, or (N, Kc) tangency logits for the softmax bound."""

    x: torch.Tensor
    t: torch.Tensor
    xi: torch.Tensor


class CollapsedStats(NamedTuple):
    """``Σ log B = θᵀQθ + q·θ + c`` (vector θ), or S=Q (D,D), R=q (D,Kc) and
    ``-½tr(AθSθᵀ)+tr(θR)+c`` for the softmax bound."""

    Q: torch.Tensor
    q: torch.Tensor
    c: torch.Tensor


def _quad(theta: torch.Tensor, q_mat: torch.Tensor) -> torch.Tensor:
    """(K, D) θ, (D, D) Q or each chain's own (K, D, D) → (K,) θᵀQθ, in a
    fixed summation order: elementwise products and ``tree_sum``, so a
    chain's value is the same bits whether Q is shared or its own."""
    q_theta = tree_sum(theta[:, None, :] * q_mat.transpose(-1, -2), dim=-1)
    return tree_sum(q_theta * theta)


@runtime_checkable
class Bound(Protocol):
    """The surface every collapsible FlyMC bound implements (§3.1)."""

    name: str

    def log_lik(self, theta, data: GLMData) -> torch.Tensor: ...

    def log_bound(self, theta, data: GLMData) -> torch.Tensor: ...

    def suffstats(self, data: GLMData) -> CollapsedStats: ...

    def collapsed(self, theta, stats: CollapsedStats) -> torch.Tensor: ...

    def tighten(self, theta_map, data: GLMData) -> GLMData: ...


def fused_family_of(bound) -> str | None:
    """The bound's kernel family, or None if it must use a plain engine.

    The hook counts only if no likelihood method is overridden below the
    class that declared ``fused_family`` (see the reference for why).
    """
    cls = type(bound)
    declarer = next((k for k in cls.__mro__ if "fused_family" in vars(k)), None)
    if declarer is None or getattr(cls, "fused_family", None) is None:
        return None
    for meth in ("log_lik", "log_bound"):
        effective = next((k for k in cls.__mro__ if meth in vars(k)), None)
        if effective is not None and not issubclass(declarer, effective):
            return None
    return cls.fused_family


BOUND_REGISTRY: dict[str, type] = {}


def register_bound(cls: type, *aliases: str) -> type:
    """Register a Bound class under its ``name`` attribute plus aliases."""
    for k in (cls.name, *aliases):
        BOUND_REGISTRY[k] = cls
    return cls


def get_bound(bound) -> Bound:
    """Resolve a bound: pass through instances, instantiate registered names."""
    if isinstance(bound, str):
        try:
            cls = BOUND_REGISTRY[bound]
        except KeyError:
            raise KeyError(
                f"unknown bound {bound!r}; registered: {sorted(BOUND_REGISTRY)}"
            ) from None
        return cls()
    if not isinstance(bound, Bound):
        raise TypeError(
            f"{type(bound).__name__} does not implement the Bound protocol "
            "(log_lik/log_bound/suffstats/collapsed/tighten)"
        )
    return bound


# ---------------------------------------------------------------------------
# Jaakkola–Jordan bound for logistic regression
# ---------------------------------------------------------------------------


class LogisticBound:
    """log B_n(s) = a(ξ_n)·s² + s/2 + c(ξ_n), s = t_n·θᵀx_n."""

    name = "jaakkola-jordan"
    fused_family = "logistic"

    @staticmethod
    def fused_kernel_kwargs() -> dict:
        return {}

    @staticmethod
    def log_lik(theta, data: GLMData):
        s = data.t * (theta @ data.x.t())
        return -softplus(-s)

    @staticmethod
    def log_bound(theta, data: GLMData):
        s = data.t * (theta @ data.x.t())
        return jj_a(data.xi) * s * s + 0.5 * s + jj_c(data.xi)

    @staticmethod
    def suffstats(data: GLMData) -> CollapsedStats:
        a = jj_a(data.xi)
        q_mat = (data.x * a[:, None]).t() @ data.x
        q = 0.5 * (data.t.to(data.x.dtype) @ data.x)
        return CollapsedStats(q_mat, q, jj_c(data.xi).sum())

    @staticmethod
    def collapsed(theta, stats: CollapsedStats):
        return _quad(theta, stats.Q) + tree_sum(theta * stats.q) + stats.c

    @staticmethod
    def tighten(theta_map, data: GLMData) -> GLMData:
        return data._replace(xi=torch.abs(data.x @ theta_map))

    @staticmethod
    def default_xi(data: GLMData, xi: float = 1.5) -> GLMData:
        return data._replace(xi=torch.full_like(data.x[:, 0], xi))


# ---------------------------------------------------------------------------
# Böhning bound for softmax classification
# ---------------------------------------------------------------------------


def _a_mul_tree(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * (v - tree_sum(v)[..., None] / v.shape[-1])


class _AMul(torch.autograd.Function):
    """A·v with the mean a ``tree_sum``; A is symmetric, so its VJP is A·g,
    summed the same way. Autograd's own VJP of a mean sums the broadcast
    cotangent with a library reduction whose order changes with the chain
    count on the card (at 512 classes)."""

    @staticmethod
    def forward(ctx, v):
        return _a_mul_tree(v)

    @staticmethod
    def backward(ctx, g):
        return _a_mul_tree(g)


def _a_mul(v: torch.Tensor) -> torch.Tensor:
    """Apply Böhning curvature A = ½(I - 𝟙𝟙ᵀ/K) along the last axis, in a
    fixed summation order both ways (batch-invariant)."""
    return _AMul.apply(v)


def _softmax_log_lik_eta(eta, t):
    """log softmax(η)[t] for per-row class ids t."""
    lsm = torch.log_softmax(eta, dim=-1)
    idx = t.to(torch.int64).expand(eta.shape[:-1])[..., None]
    return torch.gather(lsm, -1, idx)[..., 0]


class SoftmaxBound:
    """Böhning (1992) quadratic lower bound; θ is (K, Kc, D), ξ = η₀ (N, Kc)."""

    name = "bohning"
    fused_family = "softmax"

    @staticmethod
    def fused_kernel_kwargs() -> dict:
        return {}

    @staticmethod
    def log_lik(theta, data: GLMData):
        eta = data.x @ theta.transpose(-1, -2)  # (K, N, Kc)
        return _softmax_log_lik_eta(eta, data.t)

    @staticmethod
    def log_bound(theta, data: GLMData):
        eta = data.x @ theta.transpose(-1, -2)
        eta0 = data.xi
        kc = eta.shape[-1]
        g = torch.nn.functional.one_hot(data.t.long(), kc).to(eta.dtype)
        g = g - torch.softmax(eta0, dim=-1)
        d = eta - eta0
        quad = (d * _a_mul(d)).sum(-1)
        return _softmax_log_lik_eta(eta0, data.t) + (g * d).sum(-1) - 0.5 * quad

    @staticmethod
    def suffstats(data: GLMData) -> CollapsedStats:
        x, t, eta0 = data.x, data.t, data.xi
        kc = eta0.shape[-1]
        g = torch.nn.functional.one_hot(t.long(), kc).to(x.dtype)
        g = g - torch.softmax(eta0, dim=-1)
        r = g + _a_mul(eta0)
        s_mat = x.t() @ x
        r_mat = x.t() @ r
        c = (
            _softmax_log_lik_eta(eta0, t)
            - (g * eta0).sum(-1)
            - 0.5 * (eta0 * _a_mul(eta0)).sum(-1)
        ).sum()
        return CollapsedStats(s_mat, r_mat, c)

    @staticmethod
    def collapsed(theta, stats: CollapsedStats):
        """-½ tr(AθSθᵀ) + tr(θR) + c per chain. (Aθ_k) @ S is one 2-D
        ``torch.matmul`` a chain, on a fresh (Kc, D) operand and a shared
        or fresh (D, D) S: its shape and alignment are the same whatever
        K or the lane stack, so a chain's value and gradient are the same
        bits batched or solo on a device. O(Kc·D + D²) a chain, where an
        elementwise product would hold (Kc, D, D): 4.8 TB at an LM head."""
        s_mat, r_mat, c = stats  # shared, or each chain's (K, ...)
        a_theta = _a_mul(theta.transpose(-1, -2)).transpose(-1, -2)  # (K,Kc,D)
        own = s_mat.dim() == 3
        a_theta_s = torch.stack([
            torch.matmul(a_theta[k].clone(),
                         s_mat[k].clone() if own else s_mat)
            for k in range(theta.shape[0])])
        quad = flat_tree_sum(a_theta_s * theta)
        lin = flat_tree_sum(theta * r_mat.transpose(-1, -2))
        return -0.5 * quad + lin + c

    @staticmethod
    def tighten(theta_map, data: GLMData) -> GLMData:
        return data._replace(xi=data.x @ theta_map.t())

    @staticmethod
    def default_xi(data: GLMData, n_classes: int) -> GLMData:
        return data._replace(
            xi=torch.zeros(data.x.shape[0], n_classes, dtype=data.x.dtype,
                           device=data.x.device)
        )


# ---------------------------------------------------------------------------
# Gaussian bound for Student-t robust regression
# ---------------------------------------------------------------------------


class StudentTBound:
    """Tangent-in-r² Gaussian lower bound on the Student-t likelihood."""

    name = "student-t-tangent"
    fused_family = "student_t"

    def __init__(self, nu: float = 4.0, sigma: float = 1.0):
        self.nu = float(nu)
        self.sigma = float(sigma)

    def fused_kernel_kwargs(self) -> dict:
        return {"nu": self.nu, "sigma": self.sigma}

    def _log_t_const(self) -> float:
        nu = self.nu
        return (math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0)
                - 0.5 * math.log(nu * math.pi) - math.log(self.sigma))

    def _f(self, u):
        return self._log_t_const() - ((self.nu + 1.0) / 2.0) * torch.log1p(
            u / self.nu
        )

    def _fprime(self, u):
        return -((self.nu + 1.0) / 2.0) / (self.nu + u)

    def log_lik(self, theta, data: GLMData):
        z = (data.t - theta @ data.x.t()) / self.sigma
        return self._f(z * z)

    def log_bound(self, theta, data: GLMData):
        z = (data.t - theta @ data.x.t()) / self.sigma
        u0 = (data.xi / self.sigma) ** 2
        return self._f(u0) + self._fprime(u0) * (z * z - u0)

    def suffstats(self, data: GLMData) -> CollapsedStats:
        x, y = data.x, data.t
        u0 = (data.xi / self.sigma) ** 2
        a = self._fprime(u0) / (self.sigma**2)
        q_mat = (x * a[:, None]).t() @ x
        q = -2.0 * ((a * y) @ x)
        c = (a * y * y).sum() + (self._f(u0) - self._fprime(u0) * u0).sum()
        return CollapsedStats(q_mat, q, c)

    @staticmethod
    def collapsed(theta, stats: CollapsedStats):
        return _quad(theta, stats.Q) + tree_sum(theta * stats.q) + stats.c

    def tighten(self, theta_map, data: GLMData) -> GLMData:
        return data._replace(xi=data.t - data.x @ theta_map)

    @staticmethod
    def default_xi(data: GLMData) -> GLMData:
        return data._replace(xi=torch.zeros_like(data.x[:, 0]))


register_bound(LogisticBound, "logistic")
register_bound(SoftmaxBound, "softmax")
register_bound(StudentTBound, "student-t", "robust")


def psum_stats(stats: CollapsedStats, group) -> CollapsedStats:
    """The whole dataset's statistics from each rank's shard's: each leaf
    summed over ``group``'s ranks once, at setup (the counterpart of the
    reference's ``psum_stats``). Sufficient statistics are sums over data
    rows, so the shards' add up to the whole; the collapsed term is then
    replicated O(D²) work a density evaluation, with no collective."""
    from repro_torch.distributed import comm

    return CollapsedStats(*(comm.all_reduce_sum(a, group) for a in stats))


# ---------------------------------------------------------------------------
# Priors (θ with a leading chain axis → (K,))
# ---------------------------------------------------------------------------


def gaussian_log_prior(theta, scale: float):
    """Isotropic Gaussian prior (normalization constant dropped)."""
    return -0.5 * flat_tree_sum(theta * theta) / (scale**2)


def laplace_log_prior(theta, scale: float):
    """Sparsity-inducing Laplace prior (paper §4.3)."""
    return -flat_tree_sum(torch.abs(theta)) / scale
