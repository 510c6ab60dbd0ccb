"""Port parity: the recurrentgemma serving path of repro_torch against the JAX
package, on the reduced config (6 layers: 2 groups of rglru, rglru, attn; and
a 5-layer variant whose last two layers are the reference's unrolled
``extra`` layers), in float32.

Both packages start from the same weights: JAX ``init_model(key 0)`` →
numpy → :func:`repro_torch.convert.lm_params`. Tolerances: 1e-4 absolute
and relative (float32 through a few layers, different summation orders);
ring positions bitwise. The 32-slot local window equals the prompt length,
so every decode step writes over a prompt slot (the ring wraps).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.distributed.par import Par
from repro.models import serving as JSV
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import serve
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, MoEConfig, check_trainable

ARCH = "recurrentgemma-9b"
PAR = Par()
S_PROMPT, SEQ_CAP = 32, 64
TOL = dict(rtol=1e-4, atol=1e-4)


class Pair:
    """The same model in both packages, and a token stream."""

    def __init__(self, n_layers):
        over = {} if n_layers is None else {"n_layers": n_layers}
        self.jcfg = jax_get_reduced(ARCH, **over)
        self.cfg = get_reduced(ARCH, **over)
        params, self.specs = JT.init_model(self.jcfg, jax.random.key(0))
        self.params = params
        self.model = convert.lm_params(jax.device_get(params), self.cfg, "cpu")
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   (2, S_PROMPT + 5)).astype(np.int32)

    def jax_prefill(self):
        return JSV.prefill(self.params, self.specs,
                           {"tokens": jnp.asarray(self.tokens[:, :S_PROMPT])},
                           self.jcfg, PAR, SEQ_CAP, dtype=jnp.float32,
                           kv_dtype=jnp.float32)

    def torch_prefill(self):
        return SV.prefill(self.model, self.t(self.tokens[:, :S_PROMPT]),
                          SEQ_CAP, dtype=torch.float32,
                          kv_dtype=torch.float32)

    def jax_forward_logits(self, n):
        h, _ = JT.forward_hidden(self.params, self.specs, self.jcfg, PAR,
                                 {"tokens": jnp.asarray(self.tokens[:, :n])},
                                 dtype=jnp.float32, remat=False)
        return np.asarray(h[:, -1:] @ self.params["embed"]["head"])

    @staticmethod
    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64))


@functools.cache
def _pair(n_layers):
    return Pair(n_layers)


@pytest.fixture(params=[None, 5], ids=["6L", "5L-extras"])
def pair(request):
    return _pair(request.param)


@pytest.fixture
def pair6():
    return _pair(None)


def test_forward_hidden_matches_jax(pair):
    h, _ = JT.forward_hidden(pair.params, pair.specs, pair.jcfg, PAR,
                             {"tokens": jnp.asarray(pair.tokens)},
                             dtype=jnp.float32, remat=False)
    got = T.forward_hidden(pair.model, pair.t(pair.tokens), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **TOL)


def test_prefill_cache_matches_jax(pair):
    jcache, jh = pair.jax_prefill()
    cache, h = pair.torch_prefill()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert cache["t"] == int(jcache["t"]) == S_PROMPT
    want = convert.per_layer(jax.device_get(jcache), pair.cfg)
    kinds = [blk.kind for blk in pair.model.blocks]
    assert len(cache["layers"]) == len(want) == len(kinds)
    for kind, got, ref in zip(kinds, cache["layers"], want):
        assert set(got) == set(ref)
        if kind == "attn":
            assert got["pos"].dtype == torch.int32
            np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"])
            names = ("k", "v")
        else:
            names = ("state", "conv")
        for name in names:
            np.testing.assert_allclose(got[name].numpy(), ref[name], **TOL)


def test_init_cache_matches_jax_and_prefill_layout(pair):
    """An empty cache has the reference's leaves, shapes and fill (pos = -1)
    and the shapes and dtypes that prefill produces."""
    jc = JSV.init_cache(pair.jcfg, 2, SEQ_CAP, PAR, kv_dtype=jnp.float32)
    want = convert.per_layer(jax.device_get(jc), pair.cfg)
    got = SV.init_cache(pair.cfg, 2, SEQ_CAP, torch.float32, "cpu")
    filled, _ = pair.torch_prefill()
    assert got["t"] == int(jc["t"]) == 0
    for g, w, f in zip(got["layers"], want, filled["layers"], strict=True):
        assert set(g) == set(w) == set(f)
        for name in g:
            np.testing.assert_array_equal(g[name].numpy(), w[name])
            assert (g[name].shape, g[name].dtype) == (f[name].shape,
                                                      f[name].dtype)


def test_decode_step_matches_jax(pair):
    jcache, _ = pair.jax_prefill()
    cache, _ = pair.torch_prefill()
    tok = pair.tokens[:, S_PROMPT:S_PROMPT + 1]
    jnext, jlogits, _ = JSV.decode_step(pair.params, pair.specs, jcache,
                                        jnp.asarray(tok), pair.jcfg, PAR,
                                        SEQ_CAP, dtype=jnp.float32)
    nxt, logits, cache = SV.decode_step(pair.model, cache, pair.t(tok),
                                        SEQ_CAP, torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    assert cache["t"] == S_PROMPT + 1


def test_multistep_decode_matches_jax_across_ring_wrap(pair6):
    """Four autoregressive steps, each fed the reference's greedy token:
    logits at 1e-4, the port's greedy token equal to the reference's."""
    jcache, _ = pair6.jax_prefill()
    cache, _ = pair6.torch_prefill()
    step = jax.jit(lambda c, tok: JSV.decode_step(
        pair6.params, pair6.specs, c, tok, pair6.jcfg, PAR, SEQ_CAP,
        dtype=jnp.float32))
    tok = pair6.tokens[:, S_PROMPT:S_PROMPT + 1]
    for i in range(4):
        jnext, jlogits, jcache = step(jcache, jnp.asarray(tok))
        nxt, logits, cache = SV.decode_step(pair6.model, cache, pair6.t(tok),
                                            SEQ_CAP, torch.float32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        tok = np.asarray(jnext)
    want = convert.per_layer(jax.device_get(jcache), pair6.cfg)
    for got, ref in zip(cache["layers"], want):
        if "pos" in got:
            np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"])


def test_decode_matches_own_forward(pair6):
    """The port's own serving contract (tests/test_serving.py's): prefill +
    one decode step reproduce the full forward's last logits, 2e-3."""
    cache, _ = pair6.torch_prefill()
    tok = pair6.tokens[:, S_PROMPT:S_PROMPT + 1]
    nxt, logits, _ = SV.decode_step(pair6.model, cache, pair6.t(tok), SEQ_CAP,
                                    torch.float32)
    h = T.forward_hidden(pair6.model, pair6.t(pair6.tokens[:, :S_PROMPT + 1]),
                         torch.float32)
    ref = h[:, -1:] @ pair6.model.embed.head
    torch.testing.assert_close(logits, ref, rtol=2e-3, atol=2e-3)
    assert torch.equal(nxt[:, 0], ref[:, 0].argmax(-1))
    np.testing.assert_allclose(
        ref.numpy(), pair6.jax_forward_logits(S_PROMPT + 1), **TOL)


def test_serve_on_cpu_is_greedy_decode_of_own_forward():
    """``serve`` (the port's entry point) on the CPU in float32: each
    generated token is the argmax of the full forward over the prompt and
    the tokens before it."""
    ids, stats = serve(ARCH, batch=2, prompt_len=20, gen=4, seed=3,
                       dtype=torch.float32, device="cpu")
    assert ids.shape == (2, 4) and stats["tok_per_s"] > 0
    model = T.init_model(get_reduced(ARCH), 3, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, 512, (2, 20), generator=gen)
    seq = prompts
    for i in range(4):
        h = T.forward_hidden(model, seq, torch.float32)
        nxt = (h[:, -1] @ model.embed.head).argmax(-1)
        assert torch.equal(nxt, ids[:, i]), f"token {i}"
        seq = torch.cat([seq, nxt[:, None]], 1)


def test_bf16_decode_stays_close_to_f32():
    """The serving dtype: a bfloat16 model (the float32 weights rounded)
    decodes to logits within bf16 noise of the float32 path."""
    cfg = get_reduced(ARCH)
    m32 = T.init_model(cfg, 1, "cpu", torch.float32)
    m16 = T.init_model(cfg, 1, "cpu", torch.bfloat16)
    toks = torch.randint(0, 512, (2, S_PROMPT + 1),
                         generator=torch.Generator().manual_seed(2))
    out = []
    for m, dt in ((m32, torch.float32), (m16, torch.bfloat16)):
        cache, _ = SV.prefill(m, toks[:, :S_PROMPT], SEQ_CAP, dt, dt)
        out.append(SV.decode_step(m, cache, toks[:, S_PROMPT:], SEQ_CAP,
                                  dt)[1])
    assert out[1].dtype == torch.float32 and torch.isfinite(out[1]).all()
    torch.testing.assert_close(out[1], out[0], rtol=0.1, atol=0.1)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_unsupported_config_cannot_build_a_model(device):
    """Every arch builds, serves and trains now: ``check_trainable``
    accepts the MoE, encdec and VLM families (SP mode), a TP-mode config
    given an MoE, and rwkv6 (its WKV kernel has a backward) on both
    devices. What the port cannot run, an unknown block kind, still cannot
    build a model and is refused for training on either device."""
    moe_like = dataclasses.replace(get_reduced(ARCH), name="moe-like",
                                   moe=MoEConfig(n_experts=4, top_k=2))
    assert isinstance(moe_like, ModelConfig)
    T.LM(moe_like, "cpu")
    for cfg in [get_config(arch) for arch in (
            "mixtral-8x7b", "arctic-480b", "whisper-tiny",
            "llava-next-mistral-7b", "rwkv6-7b")] + [moe_like]:
        check_trainable(cfg, device)
    unknown = dataclasses.replace(get_reduced(ARCH), name="unknown-kind",
                                  block_pattern=("rglru", "mamba"))
    with pytest.raises(NotImplementedError, match="mamba"):
        T.LM(unknown, "cpu")
    with pytest.raises(NotImplementedError, match="mamba"):
        check_trainable(unknown, device)
