"""Synthetic data generators matching the paper's three experiments (§4).

Port of :mod:`repro.data.synthetic`, built on :mod:`repro_torch.random`:
the same key gives the reference's uniforms and labels bit for bit, and its
normals to a few ulps (``erfinv``). ``robust_data`` draws its Student-t noise
as ``z / sqrt(χ²_ν / ν)`` from ν squared normals (integer ν), which has the
reference's law but not its bits.

  * :func:`logistic_data` — MNIST 7-vs-9 on 50 PCA components + bias
    (N≈12,214, D=51), labels in {-1, +1};
  * :func:`softmax_data` — 3-class CIFAR-10 on 256 binary features
    (N=18,000, D=256, K=3), class ids as int64;
  * :func:`robust_data` — OPV HOMO-LUMO regression (N≈1.8M, D=57).
"""

from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.core.bounds import GLMData
from repro_torch.device import resolve_device


def _with_bias(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones(x.shape[0], 1, dtype=x.dtype,
                                    device=x.device)], dim=1)


def logistic_data(key, n: int = 12214, d: int = 51, separation: float = 2.0,
                  device="cuda") -> GLMData:
    """Two-class Gaussian clouds in a PCA-like spectrum, labels in {-1,+1}."""
    key = key.to(resolve_device(device))
    ks = jr.split(key, 3)
    k_x, k_t, k_dir = ks[0], ks[1], ks[2]
    d_feat = d - 1
    t = torch.where(jr.bernoulli(k_t, 0.5, (n,)), 1.0, -1.0).to(torch.float32)
    spectrum = 1.0 / torch.sqrt(
        1.0 + torch.arange(d_feat, dtype=torch.float32, device=key.device)
    )
    x = jr.normal(k_x, (n, d_feat)) * spectrum
    direction = jr.normal(k_dir, (d_feat,))
    direction = direction / torch.linalg.norm(direction)
    x = x + 0.5 * separation * t[:, None] * direction * spectrum
    x = _with_bias(x)
    return GLMData(x=x, t=t, xi=torch.zeros_like(t))


def softmax_data(key, n: int = 18000, d: int = 256, k: int = 3,
                 sharpness: float = 3.0, device="cuda") -> GLMData:
    """K-class binary-feature data (deep-autoencoder-code regime)."""
    key = key.to(resolve_device(device))
    ks = jr.split(key, 3)
    k_proto, k_t, k_x = ks[0], ks[1], ks[2]
    t = jr.randint(k_t, (n,), 0, k).to(torch.int64)
    logits = sharpness * jr.normal(k_proto, (k, d))
    rates = torch.sigmoid(logits)
    u = jr.uniform(k_x, (n, d))
    x = (u < rates[t]).to(torch.float32)
    return GLMData(x=x, t=t, xi=torch.zeros(n, k, dtype=torch.float32,
                                            device=key.device))


def robust_data(key, n: int = 1_800_000, d: int = 57, nu: float = 4.0,
                outlier_frac: float = 0.01, outlier_scale: float = 10.0,
                sparsity: float = 0.5, device="cuda"):
    """Sparse linear response + Student-t noise + gross outliers.

    Returns (data, theta_true); ``data.t`` holds the real-valued response.
    """
    if float(nu) != int(nu) or nu < 1:
        raise ValueError("robust_data draws t noise from integer nu only")
    key = key.to(resolve_device(device))
    ks = jr.split(key, 6)
    k_x, k_w, k_mask, k_noise, k_out, k_osel = (ks[i] for i in range(6))
    x = _with_bias(jr.normal(k_x, (n, d - 1)))
    theta_true = jr.normal(k_w, (d,))
    mask = jr.bernoulli(k_mask, sparsity, (d,))
    theta_true = torch.where(mask, theta_true, torch.zeros_like(theta_true))
    kz = jr.split(k_noise)
    z = jr.normal(kz[0], (n,))
    chi = jr.normal(kz[1], (int(nu), n))
    noise = z / torch.sqrt((chi * chi).sum(0) / nu)
    gross = outlier_scale * jr.normal(k_out, (n,))
    is_out = jr.bernoulli(k_osel, outlier_frac, (n,))
    y = x @ theta_true + torch.where(is_out, gross, noise)
    return GLMData(x=x, t=y, xi=torch.zeros_like(y)), theta_true
