"""The sharded prefill and decode of the TP-mode archs on
``torch.distributed`` (gloo, CPU).

Against the reference: :func:`repro.launch.steps.make_sharded_prefill` and
:func:`repro.launch.steps.make_sharded_decode` on 4 of 8 emulated CPU
devices (a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_
count=8``), and the port's functions of the same names on 4 gloo ranks
(processes), float32 compute with the reference's bfloat16 rings, from the
reference's ``init_model`` weights (rwkv6's ``mu``, ``wb`` and ``u``, which
the init zeroes, drawn from a seeded numpy generator;
``convert.lm_params(..., mesh=)`` cuts each rank's shards). The cases
(:data:`CASES`), on mesh (2, 2): the reduced recurrentgemma-9b (RG-LRU
channels, local-attention heads and ff columns over ``model``; its MQA
ring whole on every model rank in ``fsdp``) and rwkv6-7b (WKV heads and
channel-mix columns over ``model``), each in the ``fsdp`` layout (a prompt
of 30 tokens, then 4 greedy steps: recurrentgemma's 32-slot window ring
wraps) and the ``tp`` layout (from an empty cache, 4 teacher-forced
steps).

Tolerances, with the gaps measured on the CPU beside them:

  * the prefill's hidden, whole on every model rank: ``HIDDEN_ATOL``
    (measured ≤ 4.8e-6);
  * the caches: ring positions bitwise, bfloat16 K/V within one bfloat16
    ulp (``KV_RTOL``) with at most ``KV_FLIP_SHARE`` of the entries not
    bitwise (measured ≤ 0.25%); the float32 RG-LRU and WKV states, conv
    histories and token shifts to ``STATE_ATOL`` of the leaf's largest
    value (measured ≤ 6.3e-6);
  * each step's logits: ``LOGIT_ATOL`` (measured ≤ 1.9e-5); the greedy
    tokens equal wherever the top-2 gap clears twice ``LOGIT_ATOL``. Every
    step of both packages is fed the reference's token.

``-s`` prints each gap.

The reference's sharded prefill builds each attention ring as a
sequence-sharded one wherever mp divides W (``repro/models/serving.py:
543-560::_ring_from_full`` does not ask the parallel mode), while its
``cache_pspecs`` places a TP-mode ring whole over ``model``: so
recurrentgemma's prefill cache comes out with model rank 0's W/mp = 16
slots as its whole ring (ROADMAP queue 3). The port keeps the whole ring
on every model rank, as ``cache_pspecs`` says: its ring is the
reference's single-device prefill's, and its first W/mp slots are the
reference's sharded one. The reference's decode steps start from its
single-device prefill cache (placed by the decode's specs), and so does
a port decode started from the reference's cache
(``convert.lm_cache(..., mesh=)`` cuts each rank's shard: the RG-LRU
state and history its r/mp channels, the WKV state its H/mp heads); both
port decodes match the reference's. Each rank's cache shard, times
the mesh axes its specs split it over, is the logical cache, and
``cache_pspecs`` is the reference's on three meshes in both layouts.
Within the
port: mesh (1, 1) on one rank is bitwise the single-device prefill and
decode in both layouts.
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
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.distributed.launch import run_ranks, single_rank
from repro_torch.launch.mesh import Mesh, make_par
from repro_torch.launch.steps import make_sharded_decode
from repro_torch.models import serving as SV
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HIDDEN_ATOL = 2e-5
KV_RTOL = 2**-7  # one bfloat16 ulp
KV_FLIP_SHARE = 0.01
STATE_ATOL = 1e-5
LOGIT_ATOL = 1e-4
AXES = ("data", "model")
SEQ, BATCH, PROMPT, STEPS = 32, 4, 30, 4

_G, _R = "recurrentgemma-9b", "rwkv6-7b"
CASES = {  # name: arch, layout
    "rgemma_fsdp": (_G, "fsdp"), "rgemma_tp": (_G, "tp"),
    "rwkv_fsdp": (_R, "fsdp"), "rwkv_tp": (_R, "tp"),
}

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import get_reduced
    from repro.distributed import par as parlib
    from repro.distributed.par import Par
    from repro.launch import steps
    from repro.models import serving as SV
    from repro.models import transformer as T
    from repro.models.config import ShapeConfig
    toks, cases = np.load(sys.argv[1]), json.loads(sys.argv[2])
    seq, b, s, n_steps = json.loads(sys.argv[4])
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, prefix + "/" + k)
        else:
            out[prefix] = np.asarray(jnp.asarray(tree, jnp.float32))

    trees = {}
    for arch in sorted({c[0] for c in cases.values()}):
        p, _ = T.init_model(get_reduced(arch), jax.random.key(0))
        p = jax.tree.map(np.array, jax.device_get(p))
        rng = np.random.default_rng(0)
        for slot in p["blocks"].values():  # the init zeroes these
            mix = slot.get("mix", {})
            for name, draw in (("mu", lambda s: rng.uniform(0.0, 1.0, s)),
                               ("wb", lambda s: 0.3 * rng.normal(size=s)),
                               ("u", lambda s: 0.5 * rng.normal(size=s))):
                if name in mix:
                    mix[name] = draw(mix[name].shape).astype(np.float32)
        trees[arch] = p
        flat(p, "init_" + arch)

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    for name, (arch, layout) in cases.items():
        cfg = get_reduced(arch)
        put = lambda tree, ps: jax.tree.map(
            lambda a, q: jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, q)), tree, ps)
        tp = layout == "tp"
        dfn, sds, specs = steps.make_sharded_decode(
            cfg, mesh, ShapeConfig("d", seq, b, "decode"), dtype=jnp.float32,
            layout=layout)
        p = put(trees[arch], parlib.spec_tree_to_pspecs(specs, "model"))
        if tp:  # an empty cache of the layout's global shapes
            def empty(path, sd):
                fill = -1 if path[-1].key == "pos" else 0
                return jax.device_put(jnp.full(sd.shape, fill, sd.dtype),
                                      sd.sharding)
            cache = jax.tree_util.tree_map_with_path(empty, sds[1])
            feed = [toks[:, i:i + 1] for i in range(n_steps)]
        else:
            fn, _, _ = steps.make_sharded_prefill(
                cfg, mesh, ShapeConfig("p", seq, b, "prefill"),
                dtype=jnp.float32)
            cache, h = fn(p, {"tokens": jnp.asarray(toks[:, :s])})
            out[name + "/hidden"] = np.asarray(h)
            flat(jax.device_get(cache), name + "/prefill")
            # the single device's prefill: its rings are whole (the
            # sharded prefill's are model rank 0's W/mp slots), and the
            # decode starts from it
            one = T.build_specs(cfg, {}, None)
            cache, _ = jax.jit(lambda q, t: SV.prefill(
                q, one, {"tokens": t}, cfg, Par(), seq, jnp.float32))(
                trees[arch], jnp.asarray(toks[:, :s]))
            flat(jax.device_get(cache), name + "/prefill_one")
            cache = jax.tree.map(lambda a, sd: jax.device_put(a, sd.sharding),
                                 cache, sds[1])
            feed = [toks[:, s:s + 1]]
        for i in range(n_steps):
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
    rng = np.random.default_rng(7)
    return rng.integers(0, 512, (BATCH, 40)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory, tokens):
    d = tmp_path_factory.mktemp("ref")
    np.save(d / "toks.npy", tokens)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "toks.npy"),
                    json.dumps(CASES), str(d / "out.npz"),
                    json.dumps([SEQ, BATCH, PROMPT, STEPS])], check=True,
                   env=env, timeout=600, cwd=ROOT)
    with np.load(d / "out.npz") as z:
        return dict(z)


def _feed(name, reference, tokens):
    """The tokens each step is fed: the reference's greedy ones after the
    prompt's next (fsdp), the stream itself (tp)."""
    if CASES[name][1] == "tp":
        return [tokens[:, i:i + 1] for i in range(STEPS)]
    return [tokens[:, PROMPT:PROMPT + 1]] + [reference[f"{name}/next{i}"]
                                            for i in range(STEPS - 1)]


def _job(name, reference, tokens, mesh=(2, 2)):
    arch, layout = CASES[name]
    job = dict(arch=arch, device="cpu", mesh=(mesh, AXES), seq_len=SEQ,
               batch=BATCH, layout=layout,
               params=_nest(reference, "init_" + arch),
               feed=_feed(name, reference, tokens))
    if layout == "fsdp":
        job["prompt"] = tokens[:, :PROMPT]
    return job


FSDP = [n for n, c in CASES.items() if c[1] == "fsdp"]


@pytest.fixture(scope="module")
def port(reference, tokens):
    """One 4-rank start: every case, then each fsdp case decoded from the
    reference's prefill cache."""
    jobs = [("serve", _job(n, reference, tokens)) for n in CASES]
    for n in FSDP:
        job = _job(n, reference, tokens)
        del job["prompt"]
        jobs.append(("serve", dict(job, cache=_nest(reference,
                                                    f"{n}/prefill_one"))))
    out = run_ranks(ranks.many, 4, backend="gloo", device="cpu",
                    args=(jobs,))
    for r in out[1:]:  # every rank gathered the same logical results
        for a, b in zip(out[0], r):
            for i, lg in enumerate(a["logits"]):
                assert np.array_equal(lg, b["logits"][i])
                assert np.array_equal(a["tokens"][i], b["tokens"][i])
    res = dict(zip(CASES, out[0]))
    res["from_ref"] = dict(zip(FSDP, out[0][len(CASES):]))
    res["shapes"] = [dict(zip(CASES, [o["layer_shapes"] for o in r]))
                     for r in out]
    return res


def _layers(reference, key, arch):
    return convert.per_layer(_nest(reference, key), get_reduced(arch))


def _assert_cache(got: dict, want: list, what: str):
    assert len(got["layers"]) == len(want)
    flips, gaps = 0.0, [0.0]
    for i, (g, w) in enumerate(zip(got["layers"], want)):
        assert set(g) == set(w), (what, i)
        for n in g:
            assert g[n].shape == w[n].shape, (what, i, n)
            msg = f"{what} layer {i} {n}"
            if n == "pos":
                np.testing.assert_array_equal(g[n], w[n], err_msg=msg)
            elif n in ("k", "v"):
                np.testing.assert_allclose(g[n], w[n], rtol=KV_RTOL,
                                           atol=1e-6, err_msg=msg)
                flips = max(flips, float(np.mean(g[n] != w[n])))
            else:
                gap = float(np.abs(g[n] - w[n]).max()
                            / max(np.abs(w[n]).max(), 1e-30))
                gaps.append(gap)
                assert gap <= STATE_ATOL, (msg, gap)
    print(f"{what}: K/V flips {flips:.3g}, states {max(gaps):.3g}")
    assert flips <= KV_FLIP_SHARE, (what, flips)


@pytest.mark.parametrize("name", FSDP)
def test_prefill_matches_reference(reference, port, name):
    """The sharded prefill's hidden (whole over ``model``) and its cache
    (gathered from the rank shards): the recurrent states the reference's
    sharded prefill's, the rings its single-device prefill's, and their
    first W/mp slots its sharded prefill's."""
    arch, got = CASES[name][0], port[name]
    np.testing.assert_allclose(got["hidden"], reference[f"{name}/hidden"],
                               rtol=0, atol=HIDDEN_ATOL)
    print(f"{name}: hidden "
          f"{np.abs(got['hidden'] - reference[name + '/hidden']).max():.3g}")
    assert got["hidden"].shape == (BATCH, PROMPT, 128)
    assert got["prefill_cache"]["t"] == PROMPT
    sharded = _layers(reference, f"{name}/prefill", arch)
    one = _layers(reference, f"{name}/prefill_one", arch)
    want = [w if "k" in w else s for s, w in zip(sharded, one)]
    _assert_cache(got["prefill_cache"], want, name)
    rings = [(g, s) for g, s in zip(got["prefill_cache"]["layers"], sharded)
             if "k" in s]
    assert len(rings) == (2 if arch == _G else 0)
    for g, s in rings:  # the reference's sharded ring: model rank 0's block
        half = SEQ // 2
        assert s["k"].shape[1] == half
        blocks = [{n: g[n][:half] if n == "pos" else g[n][:, :half]
                   for n in g}]
        _assert_cache({"layers": blocks}, [s], name + " rank-0 block")


def _gap_ok(logits, tok, want_tok):
    top2 = np.sort(logits[:, 0], -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
    assert clear.any()
    np.testing.assert_array_equal(tok[clear], want_tok[clear])


def _assert_steps(got, reference, name):
    assert len(got["logits"]) == STEPS
    gap = 0.0
    for i in range(STEPS):
        want = reference[f"{name}/logits{i}"]
        assert got["logits"][i].shape == want.shape == (BATCH, 1, 512)
        np.testing.assert_allclose(got["logits"][i], want, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {i}")
        gap = max(gap, float(np.abs(got["logits"][i] - want).max()))
        _gap_ok(want, got["tokens"][i], reference[f"{name}/next{i}"])
    print(f"{name}: logits {gap:.3g}")


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_reference(reference, port, name):
    arch, layout = CASES[name]
    got = port[name]
    _assert_steps(got, reference, name)
    start = PROMPT if layout == "fsdp" else 0
    assert got["cache"]["t"] == start + STEPS
    _assert_cache(got["cache"], _layers(reference, f"{name}/cache", arch),
                  name)


@pytest.mark.parametrize("name", FSDP)
def test_decode_from_the_references_cache(reference, port, name):
    got = port["from_ref"][name]
    _assert_steps(got, reference, name)
    _assert_cache(got["cache"], _layers(reference, f"{name}/cache",
                                        CASES[name][0]), name)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_caches_make_up_the_logical_cache(reference, port, name):
    """Each rank's cache shard, times the mesh axes its specs split each
    dimension over, is the logical cache's shape; the RG-LRU state and
    history hold r/mp channels and the WKV state H/mp heads."""
    arch, layout = CASES[name]
    cfg = get_reduced(arch)
    _, specs, _ = make_sharded_decode(
        cfg, Mesh(AXES, (2, 2)), ShapeConfig("s", SEQ, BATCH, "decode"),
        layout=layout)
    want = _layers(reference, f"{name}/cache", arch)
    sizes = dict(zip(AXES, (2, 2)))
    for rank_shapes in port["shapes"]:
        for mine, sp, w in zip(rank_shapes[name], specs["cache"]["layers"],
                               want):
            assert set(mine) == set(sp) == set(w)
            for n, shape in mine.items():
                logical = tuple(d * int(np.prod([sizes[a] for a in axes]))
                                for d, axes in zip(shape, sp[n].dims))
                assert logical == w[n].shape, (n, shape, sp[n].dims)
            if "conv" in mine:
                assert mine["state"] == (2, cfg.rnn_dim // 2)
            if "shift_tm" in mine:
                assert mine["state"][1] == cfg.n_heads // 2


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
@pytest.mark.parametrize("arch", [_G, _R])
def test_one_by_one_mesh_is_bitwise_single_device(reference, tokens, arch,
                                                  layout):
    """Mesh (1, 1) on one rank: the prefill's hidden and cache and each
    step's logits, tokens and cache bit for bit the single-device ones."""
    name = next(n for n, c in CASES.items() if c == (arch, layout))
    params = _nest(reference, "init_" + arch)
    feed = _feed(name, reference, tokens)
    model = convert.lm_params(params, get_reduced(arch), "cpu")
    if layout == "fsdp":
        cache, h = SV.prefill(model, torch.as_tensor(tokens[:, :PROMPT]),
                              SEQ, torch.float32)
    else:
        cache = SV.init_cache(model.cfg, BATCH, SEQ, torch.bfloat16, "cpu")
    logits, toks = [], []
    for tok in feed:
        nxt, lg, cache = SV.decode_step(model, cache, torch.as_tensor(tok),
                                        SEQ, torch.float32)
        logits.append(lg.numpy())
        toks.append(nxt.numpy())
    with single_rank("gloo", "cpu"):
        got = ranks.serve(None, _job(name, reference, tokens, mesh=(1, 1)))
    if layout == "fsdp":
        assert np.array_equal(got["hidden"], h.numpy())
    for a, b in zip(got["logits"], logits):
        assert np.array_equal(a, b)
    for a, b in zip(got["tokens"], toks):
        assert np.array_equal(a, b)
    for g, w in zip(got["cache"]["layers"], cache["layers"]):
        for n in g:
            assert np.array_equal(g[n], w[n].float().numpy()), n


def _ps(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("serve_tp", [False, True])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", [_G, _R])
def test_cache_pspecs_match_reference(arch, mesh, serve_tp):
    from repro.configs import get_reduced as jax_reduced
    from repro.distributed.par import Par as JPar
    from repro.models import serving as JSV

    got = SV.cache_pspecs(get_reduced(arch), SEQ, make_par(Mesh(AXES, mesh)),
                          serve_tp)
    jpar = JPar(dp=("data",), mp="model", dp_size=mesh[0], mp_size=mesh[1])
    want = JSV.cache_pspecs(jax_reduced(arch), SEQ, jpar,
                            dict(zip(AXES, mesh)), serve_tp=serve_tp)
    cfg = get_reduced(arch)
    p = len(cfg.block_pattern)
    n_groups = cfg.n_layers // p
    for i, layer in enumerate(got["layers"]):
        # a stacked slot's specs lead with the group axis
        ref, lead = ((want["blocks"][f"slot{i % p}"], 1) if i < n_groups * p
                     else (want[f"extra{i - n_groups * p}"], 0))
        assert set(layer) == set(ref), i
        for n, spec in layer.items():
            assert spec.dims == tuple(_ps(e) for e in ref[n][lead:]), (i, n)
