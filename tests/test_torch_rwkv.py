"""Port parity: the rwkv6-7b serving path of repro_torch against the JAX
package, on the reduced config (2 layers, d_model 128, 4 heads × 32, d_ff
256, vocab 512), in float32.

Both packages start from the same weights: JAX ``init_model(key 0)``, whose
token-shift mixes ``mu``, decay LoRA ``wb`` and bonus ``u`` (zeros at init,
which would hide a wrong shift, decay or bonus path) are overwritten from a
numpy seed, → numpy → :func:`repro_torch.convert.lm_params`. Tolerance 1e-4
absolute and relative (float32 through two layers, different summation
orders). Sequence lengths cover one time chunk with one WKV chunk (S=32),
a WKV chunk of 33 (S=33), the state carried across two 512-step time chunks
(S=1024) and WKV chunks of one step (S=513: the reference halves the time
chunk from 512 until it divides S, down to 1).
"""

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
from repro_torch.configs.rwkv6_7b import N_PARAMS
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.launch.serve import serve
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T

ARCH = "rwkv6-7b"
PAR = Par()
S_PROMPT, SEQ_CAP = 32, 64
TOL = dict(rtol=1e-4, atol=1e-4)


def randomize_zero_inits(params, seed: int = 0):
    """Overwrite the reference's zero-initialised ``mu`` (token shifts, in
    [0, 1]), ``wb`` (decay LoRA) and ``u`` (bonus) with seeded values."""
    rng = np.random.default_rng(seed)
    mix = params["blocks"]["slot0"]["mix"]
    for name, draw in (("mu", lambda s: rng.uniform(0.0, 1.0, s)),
                       ("wb", lambda s: 0.3 * rng.normal(size=s)),
                       ("u", lambda s: 0.5 * rng.normal(size=s))):
        mix[name] = jnp.asarray(draw(mix[name].shape).astype(np.float32))
    return params


class Pair:
    """The same rwkv model in both packages, and a token stream."""

    def __init__(self):
        self.jcfg = jax_get_reduced(ARCH)
        self.cfg = get_reduced(ARCH)
        params, self.specs = JT.init_model(self.jcfg, jax.random.key(0))
        self.params = randomize_zero_inits(params)
        self.model = convert.lm_params(jax.device_get(self.params), self.cfg,
                                       "cpu")
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   (2, 1024)).astype(np.int32)

    def jax_prefill(self, n=S_PROMPT):
        return JSV.prefill(self.params, self.specs,
                           {"tokens": jnp.asarray(self.tokens[:, :n])},
                           self.jcfg, PAR, SEQ_CAP, dtype=jnp.float32,
                           kv_dtype=jnp.float32)

    def torch_prefill(self, n=S_PROMPT):
        return SV.prefill(self.model, self.t(self.tokens[:, :n]), SEQ_CAP,
                          dtype=torch.float32, kv_dtype=torch.float32)

    @staticmethod
    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64))


@functools.cache
def _pair():
    return Pair()


@pytest.fixture
def pair():
    return _pair()


def test_config_is_the_published_one():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size) == (32, 4096, 64, 64, 14336, 65536)
    assert cfg.block_pattern == ("rwkv",) and cfg.parallel_mode == "tp"
    assert not cfg.tie_embeddings
    with torch.device("meta"):
        model = T.LM(cfg, "cpu")
    # the blocks have no MLP: 32 · (6·d² + 2·d·d_ff + …) + 2 · 65536 · d
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert all(not hasattr(b, "ffn") for b in model.blocks)


@pytest.mark.parametrize("s", [32, 33, 1024, 513])
def test_forward_hidden_matches_jax(pair, s):
    h, _ = JT.forward_hidden(pair.params, pair.specs, pair.jcfg, PAR,
                             {"tokens": jnp.asarray(pair.tokens[:, :s])},
                             dtype=jnp.float32, remat=False)
    before = rwkv_ops.launch_count
    got = T.forward_hidden(pair.model, pair.t(pair.tokens[:, :s]),
                           torch.float32)
    assert rwkv_ops.launch_count == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **TOL)


@pytest.mark.parametrize("n", [S_PROMPT, 1024])
def test_prefill_cache_matches_jax(pair, n):
    jcache, jh = pair.jax_prefill(n)
    cache, h = pair.torch_prefill(n)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert cache["t"] == int(jcache["t"]) == n
    want = convert.per_layer(jax.device_get(jcache), pair.cfg)
    assert len(cache["layers"]) == len(want) == pair.cfg.n_layers
    for got, ref in zip(cache["layers"], want):
        assert set(got) == set(ref) == {"state", "shift_tm", "shift_cm"}
        for name in got:
            assert got[name].dtype == torch.float32
            np.testing.assert_allclose(got[name].numpy(), ref[name],
                                       err_msg=name, **TOL)


def test_init_cache_matches_jax_and_prefill_layout(pair):
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
    jnext, jlogits, jcache = JSV.decode_step(
        pair.params, pair.specs, jcache, jnp.asarray(tok), pair.jcfg, PAR,
        SEQ_CAP, dtype=jnp.float32)
    before = rwkv_ops.launch_count
    nxt, logits, cache = SV.decode_step(pair.model, cache, pair.t(tok),
                                        SEQ_CAP, torch.float32)
    assert rwkv_ops.launch_count == before  # decode is plain tensor code
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    assert cache["t"] == S_PROMPT + 1
    want = convert.per_layer(jax.device_get(jcache), pair.cfg)
    for got, ref in zip(cache["layers"], want):
        for name in got:
            np.testing.assert_allclose(got[name].numpy(), ref[name],
                                       err_msg=name, **TOL)


def test_multistep_decode_matches_jax(pair):
    """Four autoregressive steps, each fed the reference's greedy token:
    logits at 1e-4, the port's greedy token equal to the reference's."""
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


def test_decode_matches_own_forward(pair):
    """The serving contract: a prefill, then teacher-forced decode steps,
    reproduce the full forward's logits at each position (2e-3), across
    the forward's other chunking (one time chunk of S_PROMPT + 8 steps)."""
    n = 8
    cache, _ = pair.torch_prefill()
    h = T.forward_hidden(pair.model, pair.t(pair.tokens[:, :S_PROMPT + n]),
                         torch.float32)
    ref = h[:, S_PROMPT:] @ pair.model.embed.head
    for i in range(n):
        tok = pair.t(pair.tokens[:, S_PROMPT + i:S_PROMPT + i + 1])
        nxt, logits, cache = SV.decode_step(pair.model, cache, tok, SEQ_CAP,
                                            torch.float32)
        torch.testing.assert_close(logits[:, 0], ref[:, i], rtol=2e-3,
                                   atol=2e-3)
        assert torch.equal(nxt[:, 0], ref[:, i].argmax(-1))


def test_serve_on_cpu_is_greedy_decode_of_own_forward():
    """``serve`` (the port's entry point) on the CPU in float32: each
    generated token is the argmax of the full forward over the prompt and
    the tokens before it."""
    ids, stats = serve(ARCH, batch=2, prompt_len=20, gen=4, seed=3,
                       dtype=torch.float32, device="cpu")
    assert ids.shape == (2, 4) and stats["tok_per_s"] > 0
    model = T.init_model(get_reduced(ARCH), 3, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(4)
    seq = torch.randint(0, 512, (2, 20), generator=gen)
    for i in range(4):
        h = T.forward_hidden(model, seq, torch.float32)
        nxt = (h[:, -1] @ model.embed.head).argmax(-1)
        assert torch.equal(nxt, ids[:, i]), f"token {i}"
        seq = torch.cat([seq, nxt[:, None]], 1)


def test_bf16_decode_stays_close_to_f32(pair):
    """The serving dtype: the bfloat16 model (the float32 weights rounded)
    decodes to logits within bf16 noise of the float32 path: bf16 keeps
    about 3 significant digits, and the two layers' recurrent state and
    token shifts carry its rounding, so the bound is 5% of the largest
    logit (the measured gap is about 3.6%)."""
    m16 = convert.lm_params(jax.device_get(pair.params), pair.cfg, "cpu",
                            torch.bfloat16)
    toks = pair.t(pair.tokens[:, :S_PROMPT + 1])
    out = []
    for m, dt in ((pair.model, torch.float32), (m16, torch.bfloat16)):
        cache, _ = SV.prefill(m, toks[:, :S_PROMPT], SEQ_CAP, dt, dt)
        out.append(SV.decode_step(m, cache, toks[:, S_PROMPT:], SEQ_CAP,
                                  dt)[1])
    assert out[1].dtype == torch.float32 and torch.isfinite(out[1]).all()
    torch.testing.assert_close(out[1], out[0], rtol=0.1,
                               atol=0.05 * float(out[0].abs().max()))
