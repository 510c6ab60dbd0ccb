"""The sharded prefill and decode on ``torch.distributed`` (gloo, CPU).

Against the reference: :func:`repro.launch.steps.make_sharded_prefill` and
:func:`repro.launch.steps.make_sharded_decode` on 4 of 8 emulated CPU
devices (a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_
count=8``), and the port's functions of the same names on 4 gloo ranks
(processes), float32 compute with the reference's bfloat16 rings, from the
reference's ``init_model`` weights with seeded random QKV biases and norm
scales (``convert.lm_params(..., mesh=)`` cuts each rank's shards). The
cases (:data:`CASES`): ``get_reduced("llama3.2-3b")`` on meshes (2, 2),
(1, 4) and (4, 1), a prompt of 28 tokens into a 32-slot ring, then 6
greedy steps that wrap it (positions 28..33: the last two are written by
model rank 0, the others by the last); a 33-slot ring that 2 does not
divide (every model rank holds the whole ring, no merge); a batch of 1 on
(2, 2), which runs whole on both data ranks (the reference's
``_strip_dp``); a qwen2-7b twin; and the ``tp`` layout from an empty
cache, 8 teacher-forced steps, on (2, 2) and on (1, 4) (where the 2 K/V
heads are held by pairs of ranks), for llama and the qwen2 twin.

Tolerances, with the gaps measured on the CPU beside them:

  * the prefill's hidden: ``HIDDEN_ATOL`` (measured ≤ 4.3e-6);
  * the rings' positions bitwise, their bfloat16 K/V within one
    bfloat16 ulp (``rtol=2**-7``: a float32 value a few ulps from a
    rounding boundary rounds the other way), at most ``KV_FLIP_SHARE`` of
    the entries not bitwise (measured ≤ 0.11%);
  * each step's logits: ``LOGIT_ATOL`` (measured ≤ 2.0e-4 for the qwen2
    twin, ≤ 8.8e-5 for llama; a K/V entry rounded the other way moves
    the logits by ~1e-4); the greedy tokens
    equal wherever the top-2 gap clears twice ``LOGIT_ATOL``. Every step
    of both packages is fed the reference's token.

The ``tp`` layout has no QKV bias, in the reference as in the port (the
reference's ``attn_tp_defs``): the qwen2 twin's tp logits equal the
reference's, and the port's single-device decode of the twin with its
biases zeroed, and differ from those with its biases by far more than
the tolerance (ROADMAP queue 3 item 3).

Within the port: mesh (1, 1) on one rank is bitwise the single-device
prefill and decode (hidden, cache, logits, tokens) in both layouts; the
merge of the plain kernel's per-block (out, m, l) equals
``decode_attention_ref`` over the whole ring, with a wholly empty block
and with every block empty (``MERGE_ATOL``, measured ≤ 2.4e-7);
``vocab_parallel_argmax`` picks the lowest global index of a tie planted
across shards; the serving-resident placement and ``cache_pspecs`` equal
the reference's; a decode started from the reference's own prefill cache
(``convert.lm_cache``) matches it as one from the port's prefill; the
step functions build the MoE, encoder-decoder and VLM archs' steps and
the TP-mode archs' (recurrentgemma, rwkv6), whose rank caches make up the
single-device cache (their runs against the reference:
``tests/test_torch_serve_sharded_families.py`` and
``tests/test_torch_serve_sharded_tp.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_serve_ranks as ranks
from repro.configs import get_reduced as jax_reduced
from repro.distributed.par import Par as JPar
from repro.models import serving as JSV
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.distributed.launch import run_ranks, single_rank
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch.mesh import Mesh, make_par
from repro_torch.launch.steps import make_sharded_decode, make_sharded_prefill
from repro_torch.models import serving as SV
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HIDDEN_ATOL = 2e-5
KV_RTOL = 2**-7  # one bfloat16 ulp
KV_FLIP_SHARE = 0.01
LOGIT_ATOL = 5e-4
MERGE_ATOL = 1e-6
AXES = ("data", "model")

_L, _Q = "llama3.2-3b", "qwen2-7b"
CASES = {  # name: arch, mesh, batch, prompt, ring, steps, layout
    "fsdp22": dict(arch=_L, mesh=[2, 2], batch=4, prompt=28, seq=32, steps=6,
                   layout="fsdp"),
    "fsdp14": dict(arch=_L, mesh=[1, 4], batch=4, prompt=28, seq=32, steps=6,
                   layout="fsdp"),
    "fsdp41": dict(arch=_L, mesh=[4, 1], batch=4, prompt=28, seq=32, steps=6,
                   layout="fsdp"),
    "odd_ring": dict(arch=_L, mesh=[2, 2], batch=4, prompt=28, seq=33,
                     steps=4, layout="fsdp"),
    "batch1": dict(arch=_L, mesh=[2, 2], batch=1, prompt=28, seq=32, steps=6,
                   layout="fsdp"),
    "qwen_fsdp": dict(arch=_Q, mesh=[2, 2], batch=4, prompt=28, seq=32,
                      steps=6, layout="fsdp"),
    "tp22": dict(arch=_L, mesh=[2, 2], batch=4, prompt=0, seq=32, steps=8,
                 layout="tp"),
    "tp14": dict(arch=_L, mesh=[1, 4], batch=4, prompt=0, seq=32, steps=8,
                 layout="tp"),
    "qwen_tp": dict(arch=_Q, mesh=[2, 2], batch=4, prompt=0, seq=32, steps=8,
                    layout="tp"),
}
FSDP = [n for n, c in CASES.items() if c["layout"] == "fsdp"]

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import get_reduced
    from repro.distributed import par as parlib
    from repro.launch import steps
    from repro.models import transformer as T
    from repro.models.config import ShapeConfig
    inp, cases = dict(np.load(sys.argv[1])), json.loads(sys.argv[2])
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, prefix + "/" + k)
        else:
            a = jnp.asarray(tree)
            out[prefix] = np.asarray(a.astype(jnp.float32)
                                     if a.dtype == jnp.bfloat16 else a)

    def randomize(tree, rng):  # as tests/test_torch_dense.py
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                randomize(leaf, rng)
            elif name in ("bq", "bk", "bv"):
                tree[name] = rng.normal(0, 0.5, leaf.shape).astype(np.float32)
            elif name == "scale":
                tree[name] = (1.0 + rng.normal(0, 0.2, leaf.shape)).astype(
                    np.float32)

    def no_bias(tree):  # the tp layout's tree (attn_tp_defs)
        if not isinstance(tree, dict):
            return tree
        return {k: no_bias(v) for k, v in tree.items()
                if k not in ("bq", "bk", "bv")}

    trees = {}
    for arch in sorted({c["arch"] for c in cases.values()}):
        p, _ = T.init_model(get_reduced(arch), jax.random.key(0))
        p = jax.tree.map(np.array, jax.device_get(p))
        randomize(p, np.random.default_rng(1))
        trees[arch] = p
        flat(p, "init_" + arch)

    for name, c in cases.items():
        cfg = get_reduced(c["arch"])
        mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:4])
        put = lambda tree, ps: jax.tree.map(
            lambda a, q: jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, q)), tree, ps)
        toks = inp["b%d" % c["batch"]]
        b, s, seq, tp = c["batch"], c["prompt"], c["seq"], c["layout"] == "tp"
        dfn, sds, specs = steps.make_sharded_decode(
            cfg, mesh, ShapeConfig("d", seq, b, "decode"), dtype=jnp.float32,
            layout=c["layout"])
        p = put(no_bias(trees[c["arch"]]) if tp else trees[c["arch"]],
                parlib.spec_tree_to_pspecs(specs, "model"))
        if tp:  # an empty cache of the layout's global shapes
            def empty(path, sd):
                fill = -1 if path[-1].key == "pos" else 0
                return jax.device_put(jnp.full(sd.shape, fill, sd.dtype),
                                      sd.sharding)
            cache = jax.tree_util.tree_map_with_path(empty, sds[1])
            feed = [toks[:, i:i + 1] for i in range(c["steps"])]
        else:
            fn, _, _ = steps.make_sharded_prefill(
                cfg, mesh, ShapeConfig("p", seq, b, "prefill"),
                dtype=jnp.float32)
            cache, h = fn(p, {"tokens": jnp.asarray(toks[:, :s])})
            out[name + "/hidden"] = np.asarray(h)
            flat(jax.device_get(cache), name + "/prefill")
            feed = [toks[:, s:s + 1]]
        for i in range(c["steps"]):
            nxt, lg, cache = dfn(p, cache, jnp.asarray(feed[i]))
            out[name + "/logits%d" % i] = np.asarray(lg)
            out[name + "/next%d" % i] = np.asarray(nxt)
            if not tp:
                feed.append(np.asarray(nxt))
        flat(jax.device_get(cache), name + "/cache")
    np.savez(sys.argv[3], **out)
""")


def _nest(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        *path, leaf = k[len(prefix) + 1:].split("/")
        d = tree
        for key in path:
            d = d.setdefault(key, {})
        d[leaf] = v
    return tree


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(5)
    return {f"b{b}": rng.integers(0, 512, (b, 40)).astype(np.int32)
            for b in (1, 4)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory, tokens):
    d = tmp_path_factory.mktemp("ref")
    np.savez(d / "in.npz", **tokens)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
                    json.dumps(CASES), str(d / "out.npz")], check=True,
                   env=env, timeout=600, cwd=ROOT)
    with np.load(d / "out.npz") as z:
        return dict(z)


def _feed(name, reference, tokens):
    """The tokens each step is fed: the reference's greedy ones after the
    prompt's next (fsdp), the stream itself (tp)."""
    c = CASES[name]
    toks = tokens[f"b{c['batch']}"]
    if c["layout"] == "tp":
        return [toks[:, i:i + 1] for i in range(c["steps"])]
    s = c["prompt"]
    return [toks[:, s:s + 1]] + [reference[f"{name}/next{i}"]
                                 for i in range(c["steps"] - 1)]


def _job(name, reference, tokens):
    c = CASES[name]
    job = dict(arch=c["arch"], device="cpu", mesh=(tuple(c["mesh"]), AXES),
               seq_len=c["seq"], batch=c["batch"], layout=c["layout"],
               params=_nest(reference, "init_" + c["arch"]),
               feed=_feed(name, reference, tokens))
    if c["layout"] == "fsdp":
        job["prompt"] = tokens[f"b{c['batch']}"][:, :c["prompt"]]
    return job


TIE = np.zeros((3, 1, 512), np.float32)
TIE[0, 0, [7, 300]] = 2.0  # within shard 0, and across shards 0 and 2
TIE[0, 0, 400] = 2.0
TIE[1, 0, [511, 130]] = 1.5  # shards 1 and 3 (of 4); 130 wins
TIE[2, 0, 256] = -1.0  # all others 0: the first index, 0


FROM_REF = ("fsdp22", "batch1")  # decode from the reference's own prefill


@pytest.fixture(scope="module")
def port(reference, tokens):
    """One 4-rank start: every case, the cases of ``FROM_REF`` decoded
    from the reference's prefill cache (``convert.lm_cache`` cuts each
    rank's shard), then the planted argmax ties on (1, 4) and (2, 2)."""
    jobs = [("serve", _job(n, reference, tokens)) for n in CASES]
    for n in FROM_REF:
        job = _job(n, reference, tokens)
        del job["prompt"]
        jobs.append(("serve", dict(job, cache=_nest(reference,
                                                    f"{n}/prefill"))))
    jobs += [("argmax_tie", dict(mesh=(m, AXES), logits=TIE))
             for m in ((1, 4), (2, 2))]
    out = run_ranks(ranks.many, 4, backend="gloo", device="cpu",
                    args=(jobs,))
    for r in out[1:]:  # every rank gathered the same logical results
        for a, b in zip(out[0][:len(CASES)], r):
            for i, lg in enumerate(a["logits"]):
                assert np.array_equal(lg, b["logits"][i])
                assert np.array_equal(a["tokens"][i], b["tokens"][i])
    res = dict(zip(CASES, out[0]))
    n = len(CASES) + len(FROM_REF)
    res["from_ref"] = dict(zip(FROM_REF, out[0][len(CASES):n]))
    res["ties"] = [o[n:] for o in out]
    return res


def _layers(reference, key, arch):
    cfg = get_reduced(arch)
    return convert.per_layer(_nest(reference, key), cfg)


def _assert_cache(got: dict, want: list, what: str):
    assert len(got["layers"]) == len(want)
    flips = 0
    for i, (g, w) in enumerate(zip(got["layers"], want)):
        np.testing.assert_array_equal(g["pos"], w["pos"],
                                      err_msg=f"{what} layer {i} pos")
        for n in ("k", "v"):
            assert g[n].shape == w[n].shape, (what, i, n)
            np.testing.assert_allclose(g[n], w[n], rtol=KV_RTOL, atol=1e-6,
                                       err_msg=f"{what} layer {i} {n}")
            flips = max(flips, np.mean(g[n] != w[n]))
    assert flips <= KV_FLIP_SHARE, (what, flips)


@pytest.mark.parametrize("name", FSDP)
def test_prefill_matches_reference(reference, port, name):
    """The sharded prefill's hidden (gathered from each rank's sequence
    block) and its cache (gathered from the ring blocks)."""
    c, got = CASES[name], port[name]
    np.testing.assert_allclose(got["hidden"], reference[f"{name}/hidden"],
                               rtol=0, atol=HIDDEN_ATOL)
    assert got["prefill_cache"]["t"] == c["prompt"]
    assert int(reference[f"{name}/prefill/t"]) == c["prompt"]
    _assert_cache(got["prefill_cache"],
                  _layers(reference, f"{name}/prefill", c["arch"]), name)


def _gap_ok(logits, tok, want_tok):
    """Tokens equal wherever the reference's top-2 gap clears the
    tolerance."""
    top2 = np.sort(logits[:, 0], -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
    assert clear.any()
    np.testing.assert_array_equal(tok[clear], want_tok[clear])


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_reference(reference, port, name):
    c, got = CASES[name], port[name]
    assert len(got["logits"]) == c["steps"]
    for i in range(c["steps"]):
        want = reference[f"{name}/logits{i}"]
        assert got["logits"][i].shape == want.shape == (c["batch"], 1, 512)
        np.testing.assert_allclose(got["logits"][i], want, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {i}")
        _gap_ok(want, got["tokens"][i], reference[f"{name}/next{i}"])
    assert got["cache"]["t"] == c["prompt"] + c["steps"]
    _assert_cache(got["cache"], _layers(reference, f"{name}/cache",
                                        c["arch"]), name)


@pytest.mark.parametrize("name", FROM_REF)
def test_decode_from_the_references_cache(reference, port, name):
    """The decode steps started from the reference's own prefill cache,
    cut to each rank's shard by ``convert.lm_cache``: logits and final
    cache as from the port's prefill."""
    c, got = CASES[name], port["from_ref"][name]
    for i in range(c["steps"]):
        np.testing.assert_allclose(got["logits"][i],
                                   reference[f"{name}/logits{i}"], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {i}")
    assert got["cache"]["t"] == c["prompt"] + c["steps"]
    _assert_cache(got["cache"], _layers(reference, f"{name}/cache",
                                        c["arch"]), name)


@pytest.mark.parametrize("name,ring", [
    ("fsdp22", (2, 16, 2, 32)), ("fsdp14", (4, 8, 2, 32)),
    ("fsdp41", (1, 32, 2, 32)), ("odd_ring", (2, 33, 2, 32)),
    ("batch1", (1, 16, 2, 32)), ("tp22", (2, 32, 1, 32)),
    ("tp14", (4, 32, 1, 32))])
def test_rank_ring_shapes(port, name, ring):
    """Each rank's ring: its rows, its W/mp slots where mp divides W (the
    whole ring where it does not, or in the tp layout), and in the tp
    layout max(1, Hk/mp) K/V heads."""
    assert port[name]["ring_local"] == ring


def _single_decode(params, arch, feed, zero_bias=False):
    """The port's single-device decode from an empty 32-slot ring."""
    if zero_bias:
        params = _zero_biases(params)
    model = convert.lm_params(params, get_reduced(arch), "cpu")
    cache = SV.init_cache(model.cfg, feed[0].shape[0], 32, torch.bfloat16,
                          "cpu")
    out = []
    for tok in feed:
        _, lg, cache = SV.decode_step(model, cache, torch.as_tensor(tok), 32,
                                      torch.float32)
        out.append(lg.numpy())
    return out


def _zero_biases(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: (np.zeros_like(v) if k in ("bq", "bk", "bv")
                else _zero_biases(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["tp22", "qwen_tp"])
def test_tp_layout_is_single_device_decode_without_bias(reference, port,
                                                        tokens, name):
    """The tp layout equals the single-device decode of the model whose
    QKV biases are zero: llama's own model; for the qwen2 twin, whose
    biases are not zero, another model, farther from it than the
    tolerance by orders of magnitude."""
    c = CASES[name]
    params = _nest(reference, "init_" + c["arch"])
    feed = _feed(name, reference, tokens)
    zero = _single_decode(params, c["arch"], feed, zero_bias=True)
    for got, want in zip(port[name]["logits"], zero):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    if c["arch"] == _Q:
        biased = _single_decode(params, c["arch"], feed)
        gap = max(float(np.abs(a - b).max())
                  for a, b in zip(port[name]["logits"], biased))
        assert gap > 100 * LOGIT_ATOL


def test_argmax_picks_the_lowest_index_of_a_tie(port):
    want = np.array([[7], [130], [0]])
    assert np.array_equal(SV.vocab_parallel_argmax(torch.as_tensor(TIE)),
                          want)
    for rank_out in port["ties"]:
        for got in rank_out:
            assert np.array_equal(got, want)


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
def test_one_by_one_mesh_is_bitwise_single_device(reference, tokens, layout):
    """Mesh (1, 1) on one rank: the prefill's hidden and cache and each
    step's logits, tokens and cache bit for bit the single-device ones
    (tp: from an empty cache; llama has no QKV bias to drop)."""
    c = CASES["fsdp22" if layout == "fsdp" else "tp22"]
    params = _nest(reference, "init_" + _L)
    feed = _feed("fsdp22" if layout == "fsdp" else "tp22", reference,
                 tokens)
    model = convert.lm_params(params, get_reduced(_L), "cpu")
    prompt = tokens["b4"][:, :c["prompt"]]
    if layout == "fsdp":
        cache, h = SV.prefill(model, torch.as_tensor(prompt), c["seq"],
                              torch.float32)
    else:
        cache = SV.init_cache(model.cfg, 4, c["seq"], torch.bfloat16, "cpu")
    logits, toks = [], []
    for tok in feed:
        nxt, lg, cache = SV.decode_step(model, cache, torch.as_tensor(tok),
                                        c["seq"], torch.float32)
        logits.append(lg.numpy())
        toks.append(nxt.numpy())
    job = dict(arch=_L, device="cpu", mesh=((1, 1), AXES), seq_len=c["seq"],
               batch=4, layout=layout, params=params, feed=feed)
    if layout == "fsdp":
        job["prompt"] = prompt
    with single_rank("gloo", "cpu"):
        got = ranks.serve(None, job)
    if layout == "fsdp":
        assert np.array_equal(got["hidden"], h.numpy())
    for a, b in zip(got["logits"], logits):
        assert np.array_equal(a, b)
    for a, b in zip(got["tokens"], toks):
        assert np.array_equal(a, b)
    for g, w in zip(got["cache"]["layers"], cache["layers"]):
        for n in g:
            assert np.array_equal(g[n], w[n].float().numpy()), n


@pytest.mark.parametrize("blocks,empty", [(4, (2,)), (2, ()), (3, (0, 1, 2))])
def test_merge_of_blocks_is_the_whole_ring(blocks, empty):
    """The plain kernel on each block of a ring, merged, against
    ``decode_attention_ref`` over the whole ring; ``empty``: blocks whose
    slots are all unwritten (pos = -1), the last case every block."""
    gen = torch.Generator().manual_seed(29)
    b, h, hk, d, w_loc, t = 2, 8, 2, 32, 24, 70
    w = blocks * w_loc
    q = torch.randn(b, h, d, generator=gen)
    k = torch.randn(b, w, hk, d, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, w, hk, d, generator=gen).to(torch.bfloat16)
    pos = torch.arange(w, dtype=torch.int32)
    for e in empty:
        pos[e * w_loc:(e + 1) * w_loc] = -1
    parts = [attn_ops.decode_attention(
        q, k[:, i * w_loc:(i + 1) * w_loc].contiguous(),
        v[:, i * w_loc:(i + 1) * w_loc].contiguous(),
        pos[i * w_loc:(i + 1) * w_loc].contiguous(), t)
        for i in range(blocks)]
    out, m, l = (torch.stack(x) for x in zip(*parts))
    got = attn_ops.merge_stacked(out, m, l)
    want = decode_attention_ref(q, k, v, pos, t)[0]
    assert float((got - want).abs().max()) <= MERGE_ATOL


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", [_L, _Q, "stablelm-1.6b", "qwen1.5-110b"])
def test_tp_placement_matches_reference(arch, mesh):
    """``build_specs(serve_tp=True)`` with the data axes excluded: the
    reference's, leaf for leaf (its layers stacked over groups), and no
    QKV bias."""
    sizes = dict(zip(AXES, mesh))
    got = T.build_specs(get_reduced(arch), sizes, "model", ("data",),
                        serve_tp=True)
    want = JT.build_specs(jax_reduced(arch), sizes, "model",
                          exclude_fsdp=("data",), serve_tp=True)
    ref = {"embed": want["embed"], "final_norm": want["final_norm"],
           "mix": want["blocks"]["slot0"]["attn"],
           **{k: want["blocks"]["slot0"][k] for k in ("ln1", "ln2", "ffn")}}
    port = {"embed": got["embed"], "final_norm": got["final_norm"],
            **got["blocks"][0]}
    assert set(port["mix"]) == {"wq", "wk", "wv", "wo"}
    for sub, leaves in port.items():
        assert set(leaves) == set(ref[sub]), sub
        drop = 0 if sub in ("embed", "final_norm") else 1
        for n, s in leaves.items():
            r = ref[sub][n]
            less = lambda x: None if x is None else x - drop
            assert (s.shape, s.tp_dim, s.fsdp_dim, s.fsdp_axes, s.sync,
                    s.local_shape) == (
                tuple(r.shape[drop:]), less(r.tp_dim), less(r.fsdp_dim),
                tuple(r.fsdp_axes), tuple(r.sync),
                tuple(r.local_shape(sizes, "model")[drop:])), (sub, n)


def _ps(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("serve_tp", [False, True])
@pytest.mark.parametrize("seq", [32, 33])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
def test_cache_pspecs_match_reference(mesh, seq, serve_tp):
    cfg = get_reduced(_L)
    par = make_par(Mesh(AXES, mesh))
    got = SV.cache_pspecs(cfg, seq, par, serve_tp)
    jpar = JPar(dp=("data",), mp="model", dp_size=mesh[0], mp_size=mesh[1])
    want = JSV.cache_pspecs(jax_reduced(_L), seq, jpar, dict(zip(AXES, mesh)),
                            serve_tp=serve_tp)["blocks"]["slot0"]
    for layer in got["layers"]:
        for n, spec in layer.items():
            assert spec.dims == tuple(_ps(e) for e in want[n][1:]), n


@pytest.mark.parametrize("arch,step", [
    ("mixtral-8x7b", "step 2"), ("whisper-tiny", "step 2"),
    ("llava-next-mistral-7b", "step 2"), ("recurrentgemma-9b", "step 3"),
    ("rwkv6-7b", "step 3")])
def test_serving_steps_refuse_later_steps(arch, step):
    """The archs of ROADMAP item 9f's steps 2 (MoE, encoder-decoder, VLM)
    and 3 (the TP-mode recurrentgemma and rwkv6), once refused, build both
    steps, and each rank's cache shard in either layout, times the mesh
    axes its specs split it over, is the single-device cache (whisper's
    ``ck``/``cv``, the RG-LRU states' r/mp channels and the WKV states'
    H/mp heads included; a tp ring's logical K/V heads are
    ``serve_kv_heads`` times mp: an MQA head is held once a rank)."""
    cfg = get_reduced(arch)
    mesh = Mesh(AXES, (2, 2))
    make_sharded_prefill(cfg, mesh, ShapeConfig("s", 32, 4, "prefill"))
    par = make_par(mesh)
    whole = SV.init_cache(cfg, 4, 32, torch.bfloat16, "meta")["layers"]
    for layout in ("fsdp", "tp"):
        _, specs, _ = make_sharded_decode(
            cfg, mesh, ShapeConfig("s", 32, 4, "decode"), layout=layout)
        mine = SV.init_cache(cfg, 2, 32, torch.bfloat16, "meta", par,
                             layout == "tp")["layers"]
        for c, sp, w in zip(mine, specs["cache"]["layers"], whole):
            assert set(c) == set(sp) == set(w)
            for n, t in c.items():
                logical = tuple(d * mesh.size_of(a)
                                for d, a in zip(t.shape, sp[n].dims))
                want = list(w[n].shape)
                if layout == "tp" and n in ("k", "v"):
                    want[2] = SV.serve_kv_heads(cfg, 2) * 2
                assert logical == tuple(want), (layout, n)


def test_tp_layout_needs_divisible_heads():
    cfg = dataclasses.replace(get_reduced(_L), n_heads=6, n_kv_heads=2)
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_decode(cfg, Mesh(AXES, (1, 4)),
                            ShapeConfig("s", 32, 4, "decode"), layout="tp")
