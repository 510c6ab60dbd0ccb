"""The slice of ``jax.random`` the FlyMC main path uses, on raw key words.

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32 words
of a jax threefry key; leading axes batch keys (one row per chain). Every
function here reproduces jax 0.9.0's ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` bit for bit: ``split``, ``fold_in``,
``bits``, ``uniform``, ``bernoulli``, ``randint`` and ``permutation`` match
exactly;
``normal`` goes through ``erfinv``, whose float32 implementations differ
between the libraries by a few ulps.

Randomness is explicit: nothing here reads or advances global RNG state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.numerics import M32, threefry2x32
from repro_torch.device import resolve_device


def key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.key(seed)``'s words: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    hi = (seed >> 32) & M32 if seed >= 0 else 0
    return torch.tensor([hi, seed & M32], dtype=torch.int64,
                        device=resolve_device(device))


def _words(k: torch.Tensor):
    return k[..., 0:1], k[..., 1:2]


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(..., 2)`` keys → ``(..., num, 2)`` subkeys (fold-like split)."""
    k0, k1 = _words(k)
    cnt = torch.arange(num, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    return torch.stack([b0, b1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the uint32 ``data`` into ``(..., 2)`` keys."""
    k0, k1 = k[..., 0], k[..., 1]
    if isinstance(data, int):  # torch.full: a host int copied over would wait
        d = torch.full((), data & M32, dtype=torch.int64, device=k.device)
    else:
        d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element: ``(..., 2)`` keys → ``(..., *shape)``."""
    shape = tuple(shape)
    n = math.prod(shape)
    k0, k1 = _words(k)
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return (b0 ^ b1).reshape(k.shape[:-1] + shape)


def uniform(k, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 U[minval, maxval) on the 23-bit mantissa grid, as jax."""
    b = bits(k, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # torch.full, not torch.tensor: no host-to-device copy, no stream wait.
    lo = torch.full((), minval, dtype=torch.float32, device=k.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles (2010) single-precision erfinv coefficients, the approximation XLA
# uses for float32: torch.special.erfinv strays further from it in the tails
# than the few ulps this form does.
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(lt, _ERFINV_W_LT5[i], _ERFINV_W_GE5[i])
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT5)):
        p = coef(i) + p * w
    return torch.where(torch.abs(x) == 1.0, x * torch.finfo(x.dtype).max, p * x)


def normal(k, shape=()) -> torch.Tensor:
    """Standard normals: ``√2 · erfinv(U(nextafter(-1, 0), 1))``, as jax."""
    return _erfinv(uniform(k, shape, _NORMAL_LO, 1.0)) * _SQRT2


def bernoulli(k, p: float, shape=()) -> torch.Tensor:
    """Booleans ``uniform(k, shape) < p`` with ``p`` rounded to float32."""
    u = uniform(k, shape)
    return u < torch.full((), p, dtype=torch.float32, device=u.device)


def randint(k, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 in ``[minval, maxval)`` by jax's two-draw modulus scheme."""
    ks = split(k)
    hi_bits = bits(ks[..., 0, :], shape)
    lo_bits = bits(ks[..., 1, :], shape)
    span = max(int(maxval) - int(minval), 1)
    mult = ((1 << 16) % span) ** 2 % span
    off = (((hi_bits % span) * mult) & M32) + (lo_bits % span)
    off = (off & M32) % span
    return (off + int(minval)).to(torch.int32)


_UINT32_MAX = np.iinfo(np.uint32).max


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, jnp.arange(n))``: ``(..., 2)`` keys →
    ``(..., n)`` int32 permutations.

    jax's shuffle: ``ceil(3·ln n / ln(2³²−1))`` rounds, each splitting the
    key, drawing 32 bits a position and stably sorting by them. The bits are
    sorted as int64: an int32 view would put the values ≥ 2³¹ first.
    """
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))
    x = torch.arange(n, dtype=torch.int32, device=k.device)
    x = x.expand(k.shape[:-1] + (n,))
    for _ in range(rounds):
        ks = split(k)
        k, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x
