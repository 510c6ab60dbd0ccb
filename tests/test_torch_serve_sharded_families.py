"""The sharded prefill and decode of the MoE, encoder-decoder and VLM
families on ``torch.distributed`` (gloo, CPU).

Against the reference: :func:`repro.launch.steps.make_sharded_prefill` and
:func:`repro.launch.steps.make_sharded_decode` on 4 of 8 emulated CPU
devices (a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_
count=8``), and the port's functions of the same names on 4 gloo ranks
(processes), float32 compute with the reference's bfloat16 rings, from the
reference's ``init_model`` weights (``convert.lm_params(..., mesh=)`` cuts
each rank's shards). The cases (:data:`CASES`), reduced configs:

  * mixtral-8x7b and arctic-480b (the dense residual) in the training
    layout (``fsdp``) on (2, 2): a 28-token prompt into a 32-slot ring,
    then greedy steps; the MoE's expert-ff shards and its psum over
    ``model``; every dispatch held ``GAP`` from a routing tie;
  * whisper-tiny fsdp on (2, 2) and (1, 4): its 32 frames split over
    ``model`` (8 a rank on (1, 4)), the cross K/V a rank's S_enc/mp block,
    attended by the kernel and merged over ``model``;
  * llava-next-mistral-7b fsdp on (1, 4) with a 48-token prompt: 12
    positions a rank, so its 16 patch positions end inside rank 1's block;
  * the serving-resident layout (``tp``) on (2, 2) for mixtral and llava
    from an empty cache, and for whisper from a cache made from a seed
    with numpy (empty rings, random ``ck``/``cv``: the reference's tp
    layout has no prefill, so its own cross cache would be zeros), cut to
    each rank's shard by ``convert.lm_cache``, so that the cross merge
    does real work;
  * the decode of mixtral and whisper from the reference's own fsdp
    prefill cache (``convert.lm_cache`` carries ``ck``/``cv``).

Tolerances, with the gaps measured on the CPU beside them:

  * the prefill's hidden: ``HIDDEN_ATOL`` (measured ≤ 4.5e-6);
  * the rings' positions bitwise, their bfloat16 K/V and ``ck``/``cv``
    within one bfloat16 ulp (``rtol=2**-7``) plus ``KV_ATOL`` (a value
    near zero keeps the float32 gap of the products: measured ≤ 1.2e-6),
    at most ``KV_FLIP_SHARE`` of the entries not bitwise (measured
    ≤ 0.21%); the least routing margin measured 2.6e-4;
  * each step's logits: ``LOGIT_ATOL`` (measured ≤ 4.1e-4, mixtral), and
    for whisper ``WHISPER_LOGIT_ATOL`` (measured ≤ 7.6e-4 after the
    port's own prefill, 4.9e-4 in tp, 2.1e-6 from the reference's own
    cache). A ring or cross entry whose float32 value lies at a bfloat16
    rounding edge rounds the other way when its products are summed in
    another order, and one such entry moves the logits by ~1e-4 (more
    for whisper, where a step attends few positions: at t = 0 the
    output is the one V row). The reference's own sharded tp decode of
    whisper differs from its single-device decode of the same cache by
    3.7e-4 in the same way, while the port's is within 2.2e-6 of it.
    The greedy tokens equal wherever the top-2 gap clears twice the
    tolerance. Every step of both packages is fed the reference's token.

Also: each rank's cache shapes (the ring's W/mp slots, ``ck``/``cv``'s
S_enc/mp positions in both layouts) and ``cache_pspecs`` against the
reference's for the four archs on (2, 2), (1, 4) and (4, 1) in both
layouts.
"""

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
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.distributed.launch import run_ranks
from repro_torch.launch.mesh import Mesh, make_par
from repro_torch.models import serving as SV

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HIDDEN_ATOL = 2e-5
KV_RTOL = 2**-7  # one bfloat16 ulp, beyond the float32 gap near zero:
KV_ATOL = 1e-5
KV_FLIP_SHARE = 0.01
LOGIT_ATOL = 5e-4
WHISPER_LOGIT_ATOL = 1e-3
GAP = 1e-4
AXES = ("data", "model")

_M, _A, _W, _V = ("mixtral-8x7b", "arctic-480b", "whisper-tiny",
                  "llava-next-mistral-7b")
ARCHS = (_M, _A, _W, _V)
CASES = {  # name: arch, mesh, batch, prompt, ring, steps, layout
    "mixtral22": dict(arch=_M, mesh=[2, 2], batch=4, prompt=28, seq=32,
                      steps=6, layout="fsdp"),
    "arctic22": dict(arch=_A, mesh=[2, 2], batch=4, prompt=28, seq=32,
                     steps=4, layout="fsdp"),
    "whisper22": dict(arch=_W, mesh=[2, 2], batch=4, prompt=28, seq=32,
                      steps=6, layout="fsdp"),
    "whisper14": dict(arch=_W, mesh=[1, 4], batch=4, prompt=28, seq=32,
                      steps=4, layout="fsdp"),
    "llava_edge": dict(arch=_V, mesh=[1, 4], batch=4, prompt=48, seq=52,
                       steps=4, layout="fsdp"),
    "mixtral_tp": dict(arch=_M, mesh=[2, 2], batch=4, prompt=0, seq=32,
                       steps=6, layout="tp"),
    "whisper_tp": dict(arch=_W, mesh=[2, 2], batch=4, prompt=0, seq=32,
                       steps=6, layout="tp", cache_seed=7),
    "llava_tp": dict(arch=_V, mesh=[2, 2], batch=4, prompt=0, seq=32,
                     steps=6, layout="tp"),
}
FSDP = [n for n, c in CASES.items() if c["layout"] == "fsdp"]
FROM_REF = ("mixtral22", "whisper22")  # decode from the reference's prefill

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

    trees = {}
    for arch in sorted({c["arch"] for c in cases.values()}):
        p, _ = T.init_model(get_reduced(arch), jax.random.key(0))
        trees[arch] = jax.tree.map(np.array, jax.device_get(p))
        flat(trees[arch], "init_" + arch)

    for name, c in cases.items():
        cfg = get_reduced(c["arch"])
        mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:4])
        put = lambda tree, ps: jax.tree.map(
            lambda a, q: jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, q)), tree, ps)
        toks = inp[name + "/tokens"]
        b, s, seq, tp = c["batch"], c["prompt"], c["seq"], c["layout"] == "tp"
        dfn, sds, specs = steps.make_sharded_decode(
            cfg, mesh, ShapeConfig("d", seq, b, "decode"), dtype=jnp.float32,
            layout=c["layout"])
        p = put(trees[c["arch"]], parlib.spec_tree_to_pspecs(specs, "model"))
        if tp:  # an empty cache of the layout's global shapes, ck/cv seeded
            rng = np.random.default_rng(c.get("cache_seed", 0))
            def start(path, sd):
                name_ = path[-1].key
                if name_ in ("ck", "cv") and "cache_seed" in c:
                    a = jnp.asarray(rng.normal(0, 1, sd.shape), sd.dtype)
                else:
                    a = jnp.full(sd.shape, -1 if name_ == "pos" else 0,
                                 sd.dtype)
                return jax.device_put(a, sd.sharding)
            cache = jax.tree_util.tree_map_with_path(start, sds[1])
            flat(jax.device_get(cache), name + "/start")
            feed = [toks[:, i:i + 1] for i in range(c["steps"])]
        else:
            fn, (_, bsds), _ = steps.make_sharded_prefill(
                cfg, mesh, ShapeConfig("p", seq, b, "prefill"),
                dtype=jnp.float32)
            batch = {"tokens": jnp.asarray(toks[:, :s])}
            for k in ("frames", "patches"):
                if name + "/" + k in inp:
                    batch[k] = jax.device_put(jnp.asarray(inp[name + "/" + k]),
                                              bsds[k].sharding)
            cache, h = fn(p, batch)
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

TOKEN_SEEDS = {n: 5 for n in CASES}  # prompts held from routing ties


def _inputs(name: str) -> dict:
    c = CASES[name]
    cfg = get_reduced(c["arch"])
    rng = np.random.default_rng(TOKEN_SEEDS[name])
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (c["batch"], 56)).astype(np.int32)}
    if cfg.family == "encdec" and c["layout"] == "fsdp":
        out["frames"] = rng.normal(
            0, 1, (c["batch"], cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm" and c["layout"] == "fsdp":
        out["patches"] = rng.normal(
            0, 1, (c["batch"], cfg.patch_positions, cfg.d_model)).astype(
            np.float32)
    return out


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
def inputs():
    return {n: _inputs(n) for n in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("ref")
    np.savez(d / "in.npz", **{f"{n}/{k}": v for n, i in inputs.items()
                              for k, v in i.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
                    json.dumps(CASES), str(d / "out.npz")], check=True,
                   env=env, timeout=600, cwd=ROOT)
    with np.load(d / "out.npz") as z:
        return dict(z)


def _feed(name, reference, inputs):
    """The tokens each step is fed: the reference's greedy ones after the
    prompt's next (fsdp), the stream itself (tp)."""
    c, toks = CASES[name], inputs[name]["tokens"]
    if c["layout"] == "tp":
        return [toks[:, i:i + 1] for i in range(c["steps"])]
    s = c["prompt"]
    return [toks[:, s:s + 1]] + [reference[f"{name}/next{i}"]
                                 for i in range(c["steps"] - 1)]


def _job(name, reference, inputs):
    c = CASES[name]
    job = dict(arch=c["arch"], device="cpu", mesh=(tuple(c["mesh"]), AXES),
               seq_len=c["seq"], batch=c["batch"], layout=c["layout"],
               params=_nest(reference, "init_" + c["arch"]),
               feed=_feed(name, reference, inputs))
    if c["layout"] == "fsdp":
        job["prompt"] = inputs[name]["tokens"][:, :c["prompt"]]
        job.update({k: v for k, v in inputs[name].items() if k != "tokens"})
    elif "cache_seed" in c:
        job["cache"] = _nest(reference, f"{name}/start")
    return job


@pytest.fixture(scope="module")
def port(reference, inputs):
    """One 4-rank start: every case, then the cases of ``FROM_REF``
    decoded from the reference's prefill cache."""
    jobs = [("serve", _job(n, reference, inputs)) for n in CASES]
    for n in FROM_REF:
        job = _job(n, reference, inputs)
        for k in ("prompt", "frames", "patches"):
            job.pop(k, None)
        jobs.append(("serve", dict(job, cache=_nest(reference,
                                                    f"{n}/prefill"))))
    out = run_ranks(ranks.many, 4, backend="gloo", device="cpu",
                    args=(jobs,))
    for r in out[1:]:  # every rank gathered the same logical results
        for a, b in zip(out[0], r):
            for i, lg in enumerate(a["logits"]):
                assert np.array_equal(lg, b["logits"][i])
                assert np.array_equal(a["tokens"][i], b["tokens"][i])
    res = dict(zip(CASES, out[0]))
    res["from_ref"] = dict(zip(FROM_REF, out[0][len(CASES):]))
    res["margins"] = [o["margin"] for r in out for o in r
                      if o["margin"] is not None]
    res["shapes"] = [dict(zip(CASES, [o["shapes_local"] for o in r]))
                     for r in out]
    return res


def _layers(reference, key, arch):
    return convert.per_layer(_nest(reference, key), get_reduced(arch))


def _assert_cache(got: dict, want: list, what: str):
    assert len(got["layers"]) == len(want)
    flips = 0
    for i, (g, w) in enumerate(zip(got["layers"], want)):
        assert set(g) == set(w), (what, i)
        np.testing.assert_array_equal(g["pos"], w["pos"],
                                      err_msg=f"{what} layer {i} pos")
        for n in set(g) - {"pos"}:
            assert g[n].shape == w[n].shape, (what, i, n)
            np.testing.assert_allclose(g[n], w[n], rtol=KV_RTOL, atol=KV_ATOL,
                                       err_msg=f"{what} layer {i} {n}")
            flips = max(flips, np.mean(g[n] != w[n]))
    assert flips <= KV_FLIP_SHARE, (what, flips)


def test_routing_is_held_from_ties(port):
    assert len(port["margins"]) > 0
    assert min(port["margins"]) >= GAP


@pytest.mark.parametrize("name", FSDP)
def test_prefill_matches_reference(reference, port, name):
    """The sharded prefill's hidden (gathered from each rank's sequence
    block) and its cache (the ring blocks and whisper's cross K/V
    blocks, gathered)."""
    c, got = CASES[name], port[name]
    np.testing.assert_allclose(got["hidden"], reference[f"{name}/hidden"],
                               rtol=0, atol=HIDDEN_ATOL)
    assert got["prefill_cache"]["t"] == c["prompt"]
    _assert_cache(got["prefill_cache"],
                  _layers(reference, f"{name}/prefill", c["arch"]), name)


def _gap_ok(logits, tok, want_tok, tol):
    top2 = np.sort(logits[:, 0], -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(tok[clear], want_tok[clear])


def _assert_steps(got, reference, name, tol=LOGIT_ATOL):
    c = CASES[name]
    assert len(got["logits"]) == c["steps"]
    for i in range(c["steps"]):
        want = reference[f"{name}/logits{i}"]
        assert got["logits"][i].shape == want.shape == (c["batch"], 1, 512)
        np.testing.assert_allclose(got["logits"][i], want, rtol=0, atol=tol,
                                   err_msg=f"step {i}")
        _gap_ok(want, got["tokens"][i], reference[f"{name}/next{i}"], tol)
    assert got["cache"]["t"] == c["prompt"] + c["steps"]
    _assert_cache(got["cache"], _layers(reference, f"{name}/cache",
                                        c["arch"]), name)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_reference(reference, port, name):
    _assert_steps(port[name], reference, name,
                  WHISPER_LOGIT_ATOL if CASES[name]["arch"] == _W
                  else LOGIT_ATOL)
    if name == "whisper_tp":  # the cross merge attends a real cache
        assert np.abs(port[name]["cache"]["layers"][0]["ck"]).max() > 0.5


@pytest.mark.parametrize("name", FROM_REF)
def test_decode_from_the_references_cache(reference, port, name):
    """The decode steps started from the reference's own prefill cache,
    cut to each rank's shard by ``convert.lm_cache`` (whisper's
    ``ck``/``cv`` blocks included)."""
    _assert_steps(port["from_ref"][name], reference, name)


def test_patch_positions_end_inside_a_rank_block():
    """The llava case's 16 patch positions end inside model rank 1's
    block of 12 prompt positions, not on a block edge."""
    c, cfg = CASES["llava_edge"], get_reduced(_V)
    s_loc = c["prompt"] // c["mesh"][1]
    assert 0 < cfg.patch_positions % s_loc
    assert cfg.patch_positions // s_loc == 1


@pytest.mark.parametrize("name", list(CASES))
def test_rank_cache_shapes(port, name):
    """Each rank's first layer: its rows, its W/mp slots (fsdp; the whole
    ring and its K/V heads in tp), and whisper's ``ck``/``cv`` its S_enc/mp
    positions in both layouts; every rank alike."""
    c = CASES[name]
    cfg = get_reduced(c["arch"])
    dp, mp = c["mesh"]
    b, hd = c["batch"] // dp, cfg.resolved_head_dim
    if c["layout"] == "fsdp":
        ring = (b, c["seq"] // mp, cfg.n_kv_heads, hd)
    else:
        ring = (b, c["seq"], SV.serve_kv_heads(cfg, mp), hd)
    want = {"k": ring, "v": ring, "pos": (ring[1],)}
    if cfg.family == "encdec":
        cross = (b, cfg.encoder_seq // mp, cfg.n_kv_heads, hd)
        want.update(ck=cross, cv=cross)
    for rank_shapes in port["shapes"]:
        assert rank_shapes[name] == want


def _ps(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("serve_tp", [False, True])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, mesh, serve_tp):
    cfg = get_reduced(arch)
    par = make_par(Mesh(AXES, mesh))
    got = SV.cache_pspecs(cfg, 32, par, serve_tp)
    jpar = JPar(dp=("data",), mp="model", dp_size=mesh[0], mp_size=mesh[1])
    want = JSV.cache_pspecs(jax_reduced(arch), 32, jpar,
                            dict(zip(AXES, mesh)),
                            serve_tp=serve_tp)["blocks"]["slot0"]
    for layer in got["layers"]:
        assert set(layer) == set(want)
        for n, spec in layer.items():
            assert spec.dims == tuple(_ps(e) for e in want[n][1:]), n
