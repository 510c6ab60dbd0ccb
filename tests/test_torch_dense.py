"""Port parity: the dense decoder family (llama3.2-3b, qwen2-7b,
stablelm-1.6b, qwen1.5-110b) of repro_torch against the JAX package, on
each arch's reduced twin (2 layers, d_model 128, 4 heads over 2 KV heads,
vocab 512), in float32.

Both packages start from the same weights: JAX ``init_model(key 0)`` with
its zero-initialised QKV biases and unit norm scales replaced by seeded
random values (so that the bias and layernorm paths are exercised) →
numpy → :func:`repro_torch.convert.lm_params`. Tolerances: 1e-4 absolute
and relative (float32 through two layers, different summation orders);
ring positions and greedy tokens bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.distributed.par import Par
from repro.models import layers as JL
from repro.models import serving as JSV
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T
from repro_torch.models.config import check_trainable

DENSE = ("llama3.2-3b", "qwen2-7b", "stablelm-1.6b", "qwen1.5-110b")
PAR = Par()
S_PROMPT, SEQ_CAP = 24, 40
TOL = dict(rtol=1e-4, atol=1e-4)


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


class Pair:
    """The same reduced dense model in both packages, and a token stream."""

    def __init__(self, arch):
        self.jcfg = jax_get_reduced(arch)
        self.cfg = get_reduced(arch)
        params, self.specs = JT.init_model(self.jcfg, jax.random.key(0))
        p_np = jax.tree.map(np.array, jax.device_get(params))
        _randomize(p_np, np.random.default_rng(1))
        self.params = jax.tree.map(jnp.asarray, p_np)
        self.model = convert.lm_params(p_np, self.cfg, "cpu")
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

    @staticmethod
    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64))


@functools.cache
def _pair(arch):
    return Pair(arch)


@pytest.fixture(params=DENSE)
def pair(request):
    return _pair(request.param)


@pytest.mark.parametrize("arch", DENSE)
def test_config_is_the_reference_field_for_field(arch):
    got = dataclasses.asdict(get_config(arch))
    want = dataclasses.asdict(jax_get_config(arch))
    assert got == want
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(
        jax_get_reduced(arch))


def test_reduced_twins_exercise_bias_layernorm_and_gqa():
    cfgs = {a: get_reduced(a) for a in DENSE}
    assert cfgs["qwen2-7b"].qkv_bias and cfgs["qwen1.5-110b"].qkv_bias
    assert cfgs["stablelm-1.6b"].norm == "layernorm"
    assert all(c.mlp == "swiglu" and c.parallel_mode == "sp"
               and c.n_heads > c.n_kv_heads for c in cfgs.values())
    blk = _pair("qwen2-7b").model.blocks[0]
    assert {"bq", "bk", "bv"} <= set(blk.mix.defs)
    assert "w3" in blk.ffn.defs


def test_forward_hidden_matches_jax(pair):
    h, _ = JT.forward_hidden(pair.params, pair.specs, pair.jcfg, PAR,
                             {"tokens": jnp.asarray(pair.tokens)},
                             dtype=jnp.float32, remat=False)
    got = T.forward_hidden(pair.model, pair.t(pair.tokens), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **TOL)


@pytest.mark.parametrize("sublayer", ["norm", "attn", "mlp"])
def test_sp_sublayers_match_jax(sublayer):
    """Each new sublayer on the same input: stablelm's bias-free layernorm,
    qwen2's biased GQA attention (SP mode), llama's swiglu MLP (SP mode)."""
    arch = {"norm": "stablelm-1.6b", "attn": "qwen2-7b",
            "mlp": "llama3.2-3b"}[sublayer]
    p = _pair(arch)
    x = np.random.default_rng(3).normal(0, 1, (2, 33, p.cfg.d_model)).astype(
        np.float32)
    w = jax.tree.map(lambda a: a[0], p.params["blocks"]["slot0"])
    ws = jax.tree.map(JT._unstack_spec, p.specs["blocks"]["slot0"],
                      is_leaf=lambda s: hasattr(s, "fsdp_dim"))
    blk = p.model.blocks[0]
    if sublayer == "norm":
        want = JL.apply_norm(jnp.asarray(x), w["ln1"], ws["ln1"], "layernorm",
                             jnp.float32)
        got = L.apply_norm(torch.from_numpy(x), blk.ln1, torch.float32,
                           "layernorm")
    elif sublayer == "attn":
        want = JL.attn_sp(jnp.asarray(x), w["attn"], ws["attn"], p.jcfg, PAR)
        got = L.attn_sp(torch.from_numpy(x), blk.mix, p.cfg)
    else:
        want = JL.mlp_sp(jnp.asarray(x), w["ffn"], ws["ffn"], p.jcfg, PAR)
        got = L.mlp_sp(torch.from_numpy(x), blk.ffn, p.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_matches_jax(pair):
    jcache, jh = pair.jax_prefill()
    cache, h = pair.torch_prefill()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert cache["t"] == int(jcache["t"]) == S_PROMPT
    want = convert.per_layer(jax.device_get(jcache), pair.cfg)
    assert len(cache["layers"]) == len(want) == pair.cfg.n_layers
    for got, ref in zip(cache["layers"], want):
        assert set(got) == set(ref) == {"k", "v", "pos"}
        # a dense decoder's ring is the whole context
        assert got["k"].shape[1] == SEQ_CAP
        np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"])
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name].numpy(), ref[name], **TOL)


def test_decode_steps_match_jax(pair):
    """Four autoregressive steps, each fed the reference's greedy token:
    logits at 1e-4, the port's greedy token equal to the reference's, and
    the ring positions bitwise."""
    jcache, _ = pair.jax_prefill()
    cache, _ = pair.torch_prefill()
    step = jax.jit(lambda c, tok: JSV.decode_step(
        pair.params, pair.specs, c, tok, pair.jcfg, PAR, SEQ_CAP,
        dtype=jnp.float32))
    tok = pair.tokens[:, S_PROMPT:S_PROMPT + 1]
    for i in range(4):
        jnext, jlogits, jcache = step(jcache, jnp.asarray(tok))
        nxt, logits, cache = SV.decode_step(pair.model, cache, pair.t(tok),
                                            SEQ_CAP, torch.float32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        tok = np.asarray(jnext)
    want = convert.per_layer(jax.device_get(jcache), pair.cfg)
    for got, ref in zip(cache["layers"], want):
        np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"])


@pytest.mark.parametrize("arch", DENSE)
def test_serve_on_cpu_is_greedy_decode_of_own_forward(arch):
    """``serve`` (the port's entry point) on the CPU in float32: each
    generated token is the argmax of the full forward over the prompt and
    the tokens before it."""
    ids, stats = serve(arch, batch=2, prompt_len=12, gen=3, seed=3,
                       dtype=torch.float32, device="cpu")
    assert ids.shape == (2, 3) and stats["tok_per_s"] > 0
    model = T.init_model(get_reduced(arch), 3, "cpu", torch.float32)
    prompts = torch.randint(0, 512, (2, 12),
                            generator=torch.Generator().manual_seed(4))
    seq = prompts
    for i in range(3):
        h = T.forward_hidden(model, seq, torch.float32)
        nxt = (h[:, -1] @ model.embed.head).argmax(-1)
        assert torch.equal(nxt, ids[:, i]), f"token {i}"
        seq = torch.cat([seq, nxt[:, None]], 1)


def test_serve_cuts_depth():
    """``n_layers`` cuts a published config's depth (qwen1.5-110b's 80
    layers do not fit one card): the reduced twin at one layer."""
    ids, _ = serve("qwen1.5-110b", batch=1, prompt_len=6, gen=2,
                   dtype=torch.float32, device="cpu", n_layers=1)
    assert ids.shape == (1, 2)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_dense_training_raises_naming_its_roadmap_item(device):
    """This family trains (ce_loss_sp, the swiglu and QKV-bias backward,
    bf16 moments: ``tests/test_torch_train_sp.py``): ``check_trainable``
    accepts each twin and published config on both devices, and an
    ``rwkv`` block too now (the WKV kernel has a backward). It still
    refuses what the port cannot run: an unknown parallel mode."""
    for arch in DENSE:
        check_trainable(get_reduced(arch), device)
        check_trainable(get_config(arch), device)
    rwkv = dataclasses.replace(get_reduced(DENSE[0]), name="rwkv-like",
                               block_pattern=("rwkv",))
    check_trainable(rwkv, device)
    pp = dataclasses.replace(get_reduced(DENSE[0]), name="pp-like",
                             parallel_mode="pp")
    with pytest.raises(NotImplementedError, match="parallel mode"):
        check_trainable(pp, device)
