"""Port parity: the MoE (mixtral-8x7b, arctic-480b), encoder-decoder
(whisper-tiny) and VLM (llava-next-mistral-7b) serving paths of
repro_torch against the JAX package, on each arch's reduced twin (2
layers, d_model 128, 4 heads over 2 KV heads, vocab 512; E = 4 experts,
a 64-token sliding window, 2 encoder layers over 32 frames, 16 patch
positions), in float32.

Both packages start from the same weights: JAX ``init_model(key 0)`` →
numpy → :func:`repro_torch.convert.lm_params`; the stub frontends' frames
and patches are 0.1·N(0, 1) from numpy. mixtral's prompt (80 tokens) is
longer than its window, so the decode ring wraps; llava's (24) is longer
than its patch positions. Every MoE dispatch is held 1e-4 away from a
routing tie before the comparison. Tolerances: 1e-4 absolute and relative
(float32 through a few layers, different summation orders); ring
positions and greedy tokens bitwise.
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
from repro.models import serving as JSV
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T

FAMILIES = ("mixtral-8x7b", "arctic-480b", "whisper-tiny",
            "llava-next-mistral-7b")
PAR = Par()
TOL = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4
STEPS = 4


@pytest.fixture(autouse=True)
def routing_held_from_ties(monkeypatch):
    """Every MoE dispatch the port makes: the k-th router probability of
    each token at least GAP above the (k+1)-th, so that both packages pick
    the same top-k set."""
    route = L.moe_route

    def held(tokens, router, cfg):
        r = route(tokens, router, cfg)
        p = r["probs"].sort(-1, descending=True).values
        k = cfg.moe.top_k
        gap = float((p[:, k - 1] - p[:, k]).min())
        assert gap >= GAP, f"a routing tie within {gap:.3g}"
        return r

    monkeypatch.setattr(L, "moe_route", held)


class Pair:
    """The same reduced model in both packages, a token stream and the stub
    frontend's input."""

    def __init__(self, arch):
        self.jcfg = jax_get_reduced(arch)
        self.cfg = cfg = get_reduced(arch)
        params, self.specs = JT.init_model(self.jcfg, jax.random.key(0))
        self.params = params
        self.model = convert.lm_params(jax.device_get(params), cfg, "cpu")
        self.prompt = 80 if cfg.swa_window else 24
        self.seq_cap = self.prompt + 16
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, cfg.vocab_size,
                                   (2, self.prompt + 5)).astype(np.int32)
        self.frontend = {}
        if cfg.family == "encdec":
            self.frontend["frames"] = rng.normal(
                0, 0.1, (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            self.frontend["patches"] = rng.normal(
                0, 0.1, (2, cfg.patch_positions, cfg.d_model)).astype(
                np.float32)

    def jax_batch(self, n):
        return {"tokens": jnp.asarray(self.tokens[:, :n]),
                **{k: jnp.asarray(v) for k, v in self.frontend.items()}}

    def torch_kw(self):
        return {k: torch.from_numpy(v) for k, v in self.frontend.items()}

    def jax_prefill(self):
        return JSV.prefill(self.params, self.specs,
                           self.jax_batch(self.prompt), self.jcfg, PAR,
                           self.seq_cap, dtype=jnp.float32,
                           kv_dtype=jnp.float32)

    def torch_prefill(self):
        return SV.prefill(self.model, self.t(self.tokens[:, :self.prompt]),
                          self.seq_cap, dtype=torch.float32,
                          kv_dtype=torch.float32, **self.torch_kw())

    @staticmethod
    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64))


@functools.cache
def _pair(arch):
    return Pair(arch)


@pytest.fixture(params=FAMILIES)
def pair(request):
    return _pair(request.param)


@pytest.mark.parametrize("arch", FAMILIES)
def test_config_is_the_reference_field_for_field(arch):
    got = dataclasses.asdict(get_config(arch))
    want = dataclasses.asdict(jax_get_config(arch))
    assert got == want
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(
        jax_get_reduced(arch))


def test_every_arch_of_the_reference_builds():
    """All ten arch ids resolve, and each reduced twin builds a model."""
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch
        T.LM(get_reduced(arch), "cpu")


def test_reduced_twins_exercise_each_family():
    cfgs = {a: get_reduced(a) for a in FAMILIES}
    assert cfgs["mixtral-8x7b"].swa_window == 64
    assert cfgs["arctic-480b"].moe.dense_residual
    assert all(cfgs[a].moe.n_experts == 4 for a in FAMILIES[:2])
    whisper = _pair("whisper-tiny").model
    assert len(whisper.enc_blocks) == 2
    assert {"ln_cross", "cross"} <= {n for n, _ in
                                     whisper.blocks[0].named_children()}
    assert cfgs["llava-next-mistral-7b"].patch_positions == 16


def test_forward_hidden_matches_jax(pair):
    """The whole forward with its frontend: hidden states and the logits
    of the untied head at 1e-4."""
    n = pair.prompt + 5
    h, _ = JT.forward_hidden(pair.params, pair.specs, pair.jcfg, PAR,
                             pair.jax_batch(n), dtype=jnp.float32,
                             remat=False)
    got = T.forward_hidden(pair.model, pair.t(pair.tokens[:, :n]),
                           torch.float32, **pair.torch_kw())
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **TOL)
    head = pair.params["embed"]["head"]
    np.testing.assert_allclose((got @ pair.model.embed.head).numpy(),
                               np.asarray(h @ head), **TOL)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-mistral-7b"])
def test_frontend_inputs_move_the_output(arch):
    """The frames (whisper) and patches (llava) are read: other values (each
    row's features rolled by one) give other hidden states."""
    pair = _pair(arch)
    toks = pair.t(pair.tokens[:, :pair.prompt])
    kw = pair.torch_kw()
    a = T.forward_hidden(pair.model, toks, torch.float32, **kw)
    b = T.forward_hidden(pair.model, toks, torch.float32,
                         **{k: v.roll(1, -1) for k, v in kw.items()})
    assert float((a - b).abs().max()) > 1e-3


def test_prefill_cache_matches_jax(pair):
    jcache, jh = pair.jax_prefill()
    cache, h = pair.torch_prefill()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert cache["t"] == int(jcache["t"]) == pair.prompt
    want = convert.per_layer(jax.device_get(jcache), pair.cfg)
    assert len(cache["layers"]) == len(want) == pair.cfg.n_layers
    w_ring = min(pair.cfg.swa_window or pair.seq_cap, pair.seq_cap)
    for got, ref in zip(cache["layers"], want):
        assert set(got) == set(ref)
        assert got["k"].shape[1] == w_ring
        np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"])
        names = ("k", "v")
        if pair.cfg.family == "encdec":
            names += ("ck", "cv")
            assert got["ck"].shape == (2, pair.cfg.encoder_seq,
                                       pair.cfg.n_kv_heads, 32)
        for name in names:
            np.testing.assert_allclose(got[name].numpy(), ref[name], **TOL)


def test_init_cache_matches_jax_and_prefill_layout(pair):
    """An empty cache has the reference's leaves (whisper's ``ck``/``cv``
    too), shapes and fill (pos = -1) and the shapes and dtypes that
    prefill produces."""
    jc = JSV.init_cache(pair.jcfg, 2, pair.seq_cap, PAR, kv_dtype=jnp.float32)
    want = convert.per_layer(jax.device_get(jc), pair.cfg)
    got = SV.init_cache(pair.cfg, 2, pair.seq_cap, torch.float32, "cpu")
    filled, _ = pair.torch_prefill()
    for g, w, f in zip(got["layers"], want, filled["layers"], strict=True):
        assert set(g) == set(w) == set(f)
        for name in g:
            np.testing.assert_array_equal(g[name].numpy(), w[name])
            assert (g[name].shape, g[name].dtype) == (f[name].shape,
                                                      f[name].dtype)


def test_decode_steps_match_jax(pair):
    """Four autoregressive steps after the prefill, each fed the previous
    greedy token: logits at 1e-4, the greedy tokens bitwise, and the ring
    positions bitwise (mixtral's ring wraps and its window masks)."""
    jcache, jh = pair.jax_prefill()
    cache, h = pair.torch_prefill()
    head = pair.params["embed"]["head"]
    tok = np.asarray(jnp.argmax(jh[:, -1:] @ head, -1)).astype(np.int32)
    assert np.array_equal(
        SV.vocab_parallel_argmax(h[:, -1:] @ pair.model.embed.head).numpy(),
        tok)
    step = jax.jit(lambda c, tk: JSV.decode_step(
        pair.params, pair.specs, c, tk, pair.jcfg, PAR, pair.seq_cap,
        dtype=jnp.float32))
    for i in range(STEPS):
        jnext, jlogits, jcache = step(jcache, jnp.asarray(tok))
        nxt, logits, cache = SV.decode_step(pair.model, cache, pair.t(tok),
                                            pair.seq_cap, torch.float32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        tok = np.asarray(jnext)
    assert cache["t"] == pair.prompt + STEPS
    want = convert.per_layer(jax.device_get(jcache), pair.cfg)
    for got, ref in zip(cache["layers"], want):
        np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"])
        np.testing.assert_allclose(got["k"].numpy(), ref["k"], **TOL)


def test_decode_step_calls_the_kernel_per_attention(pair, monkeypatch):
    """One ``decode_attention`` call a layer a step for the self-attention,
    and for whisper one more over the encoder's K/V: every position 0..S_enc-1
    valid (t = 10^9, no window); mixtral's with its 64-token window."""
    calls = []
    real = attn_ops.decode_attention

    def counted(q, k, v, pos, t, window=None):
        calls.append((k.shape[1], t, window, pos))
        return real(q, k, v, pos, t, window)

    monkeypatch.setattr(attn_ops, "decode_attention", counted)
    cache, _ = pair.torch_prefill()
    tok = pair.t(pair.tokens[:, pair.prompt:pair.prompt + 1])
    SV.decode_step(pair.model, cache, tok, pair.seq_cap, torch.float32)
    cross = pair.cfg.family == "encdec"
    assert len(calls) == (1 + cross) * pair.cfg.n_layers
    for w, t, window, pos in calls[1::2] if cross else ():
        assert (w, t, window) == (pair.cfg.encoder_seq, SV.CROSS_T, None)
        assert torch.equal(pos, torch.arange(w, dtype=torch.int32))
    self_calls = calls[0::2] if cross else calls
    assert all(c[1:3] == (pair.prompt, pair.cfg.swa_window)
               for c in self_calls)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-mistral-7b"])
def test_serve_on_cpu_is_greedy_decode_of_own_forward(arch):
    """``serve`` (the port's entry point) on the CPU in float32, with the
    stub frontend's frames or patches drawn after the prompts from the
    seed's generator: each generated token is the argmax of the full
    forward over the prompt and the tokens before it, given the same
    frontend input."""
    cfg = get_reduced(arch)
    ids, stats = serve(arch, batch=2, prompt_len=20, gen=3, seed=3,
                       dtype=torch.float32, device="cpu")
    assert ids.shape == (2, 3) and stats["tok_per_s"] > 0
    assert "drop_frac" not in stats
    model = T.init_model(cfg, 3, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
    rows = cfg.encoder_seq or cfg.patch_positions
    stub = 0.1 * torch.randn(2, rows, cfg.d_model, generator=gen)
    kw = {"frames" if cfg.family == "encdec" else "patches": stub}
    seq = prompts
    for i in range(3):
        h = T.forward_hidden(model, seq, torch.float32, **kw)
        nxt = (h[:, -1] @ model.embed.head).argmax(-1)
        assert torch.equal(nxt, ids[:, i]), f"token {i}"
        seq = torch.cat([seq, nxt[:, None]], 1)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_serve_moe_on_cpu_is_its_prefill_and_decode_steps(arch):
    """``serve`` of an MoE twin on the CPU: its tokens are those of
    ``prefill`` and ``decode_step`` called by hand (a decode step's
    capacity is the batch's, not the prompt's), and it reports the
    prefill's ``drop_frac``, a share in [0, 1)."""
    cfg = get_reduced(arch)
    ids, stats = serve(arch, batch=2, prompt_len=70, gen=3, seed=3,
                       dtype=torch.float32, device="cpu")
    assert 0.0 <= stats["drop_frac"] < 1.0
    model = T.init_model(cfg, 3, "cpu", torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (2, 70),
                            generator=torch.Generator().manual_seed(4))
    cache, h, aux = SV.prefill(model, prompts, 73, torch.float32,
                               torch.float32, aux=True)
    assert float(aux["drop_frac"]) == stats["drop_frac"]
    tok = SV.vocab_parallel_argmax(h[:, -1:] @ model.embed.head)
    out = [tok]
    for _ in range(2):
        tok, _, cache = SV.decode_step(model, cache, tok, 73, torch.float32)
        out.append(tok)
    assert torch.equal(torch.cat(out, 1), ids)
