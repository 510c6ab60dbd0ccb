"""Shared set-up of the SP-mode training parity tests
(``test_torch_train_sp.py``, ``test_torch_train_sp_steps.py``): the reduced
twins of the dense, MoE, encoder-decoder and VLM families in both packages,
numpy batches for both, the MoE routing held from ties, and the
comparisons.

Weights: JAX ``init_model(key 0)`` with its zero-initialised QKV biases and
unit norm scales replaced by seeded random values (so that the bias and
norm-scale gradients are exercised) → numpy → :func:`repro_torch.convert.
lm_params`. Batches: tokens, labels, and the stub frontends' frames or
patches (0.1·N(0, 1)), drawn with numpy and handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.distributed.par import Par
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import layers as L

SP_ARCHS = ("llama3.2-3b", "qwen2-7b", "stablelm-1.6b", "qwen1.5-110b",
            "mixtral-8x7b", "arctic-480b", "whisper-tiny",
            "llava-next-mistral-7b")
PAR = Par()
GAP = 1e-4  # the least gap between a token's k-th and (k+1)-th router prob


@pytest.fixture(autouse=True)
def routing_held_from_ties(monkeypatch):
    """Every MoE dispatch the port makes: each token's k-th router
    probability at least GAP above its (k+1)-th, so that both packages pick
    the same top-k set (and so drop the same pairs)."""
    route = L.moe_route

    def held(tokens, router, cfg):
        r = route(tokens, router, cfg)
        p = r["probs"].detach().sort(-1, descending=True).values
        k = cfg.moe.top_k
        gap = float((p[:, k - 1] - p[:, k]).min())
        assert gap >= GAP, f"a routing tie within {gap:.3g}"
        return r

    monkeypatch.setattr(L, "moe_route", held)


def _randomize(tree, rng):
    """QKV biases and norm scales drawn at random, in place (numpy)."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _randomize(leaf, rng)
        elif name in ("bq", "bk", "bv"):
            tree[name] = rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        elif name == "scale":
            tree[name] = (1.0 + rng.normal(0, 0.2, leaf.shape)).astype(
                np.float32)


class Twin:
    """The same reduced model in both packages (``n_layers`` overrides the
    twin's depth in both)."""

    def __init__(self, arch, n_layers=None):
        kw = {} if n_layers is None else {"n_layers": n_layers}
        self.jcfg = jax_get_reduced(arch, **kw)
        self.cfg = get_reduced(arch, **kw)
        params, self.specs = JT.init_model(self.jcfg, jax.random.key(0))
        self.params_np = jax.tree.map(np.array, jax.device_get(params))
        _randomize(self.params_np, np.random.default_rng(1))

    def jax_params(self):
        return jax.tree.map(jnp.asarray, self.params_np)

    def model(self, params_np=None):
        """A fresh port model from ``params_np`` (default: the twin's
        weights), its parameters requiring gradients."""
        model = convert.lm_params(
            self.params_np if params_np is None else params_np, self.cfg,
            "cpu")
        return model.requires_grad_(True)

    def batch(self, seed, b=2, s=64):
        """Numpy tokens and labels (b, s) and the frontend's input."""
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, (b, s + 1)).astype(
            np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "encdec":
            out["frames"] = rng.normal(
                0, 0.1, (b, self.cfg.encoder_seq, self.cfg.d_model)).astype(
                np.float32)
        if self.cfg.family == "vlm":
            out["patches"] = rng.normal(
                0, 0.1, (b, self.cfg.patch_positions,
                         self.cfg.d_model)).astype(np.float32)
        return out

    def as_model(self, tree):
        """A reference tree shaped like the parameters (gradients, moments)
        as a dict keyed by the port's parameter names."""
        return {n: p.detach() for n, p in convert.lm_params(
            jax.device_get(tree), self.cfg, "cpu").named_parameters()}

    @functools.cache
    def jax_value_and_grad(self, remat):
        return jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(p, self.specs, self.jcfg, PAR, b,
                                    dtype=jnp.float32, remat=remat),
            has_aux=True))


@functools.cache
def twin(arch, n_layers=None):
    return Twin(arch, n_layers)


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


def close(got, want, tol=1e-4, name=""):
    """Within ``tol`` relative plus ``tol`` of the largest value."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def metrics_close(met, jmet, keys=("loss", "nll", "lb_loss", "drop_frac")):
    """Each metric at 1e-5 relative (``drop_frac`` and the zeros of a
    config without MoE exactly)."""
    for k in keys:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5,
                                   atol=1e-12, err_msg=k)
