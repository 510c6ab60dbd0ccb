"""The port's checkpointer on the CPU: the cases of ``tests/test_checkpoint.py``
re-pinned on :class:`repro_torch.checkpoint.Checkpointer` (round trip, async
save, GC, the startup sweep, partial writes, shape checks, a FlyMC chain and
an ``api.sample`` run resumed bitwise, and the integrity properties), the
on-disk format held to the reference's in both directions, the host
snapshot taken before an async ``save`` returns, host values and bf16
round trips, and the reduced trainer resumed bitwise."""

import tempfile
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro_torch import api
from repro_torch import random as jr
from repro_torch.checkpoint import CheckpointCorruptError, Checkpointer
from repro_torch.checkpoint.checkpointer import flatten_with_paths, map_with_paths
from repro_torch.core import flymc
from repro_torch.data import logistic_data
from repro_torch.launch.train import train_reduced
from repro_torch.models.bayes_glm import GLMModel
from repro_torch.optim import AdamWState

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

CPU = "cpu"
KILL_POINTS = ("begin", "leaves_written", "manifest_written", "pre_rename",
               "parked", "renamed")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(8, 16, generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32),
                   "c": torch.tensor(3.5)},
    }


def _zeros(tree):
    return map_with_paths(lambda _, t: torch.zeros_like(t), tree)


def _assert_tree_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y), p
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            np.testing.assert_array_equal(x, y)


def test_round_trip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(7, tree, extra_metadata={"note": "x"}, blocking=True)
    restored, manifest = ck.restore(_zeros(tree))
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    _assert_tree_equal(restored, tree)


def test_async_save_and_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(1))
    ck.wait()
    assert ck.latest_step() == 1


def test_gc_keeps_last_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), blocking=True)
    assert ck.all_steps() == [3, 4]


def test_keep_last_alias_and_zero_disables_gc(tmp_path):
    ck = Checkpointer(Path(tmp_path) / "a", keep_last=1)
    for s in (1, 2, 3):
        ck.save(s, _tree(s), blocking=True)
    assert ck.all_steps() == [3]
    ck0 = Checkpointer(Path(tmp_path) / "b", keep_last=0)
    for s in (1, 2, 3):
        ck0.save(s, _tree(s), blocking=True)
    assert ck0.all_steps() == [1, 2, 3]


def test_startup_sweeps_stale_tmp_dirs(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(3, _tree(), blocking=True)
    stale = Path(tmp_path) / "step_00000009.tmp"
    stale.mkdir()
    (stale / "leaf_0000.npy").write_bytes(b"garbage")
    ck2 = Checkpointer(tmp_path)  # a restarted process
    assert not stale.exists()
    assert ck2.all_steps() == [3]


def test_partial_write_is_invisible(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, _tree(), blocking=True)
    tmp = Path(tmp_path) / "step_00000006.tmp"  # a crash mid-write of step 6
    tmp.mkdir()
    (tmp / "leaf_0000.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    _, m = ck.restore(_zeros(_tree()))
    assert m["step"] == 5


def test_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"a": torch.zeros(4)}, blocking=True)
    with pytest.raises(ValueError):
        ck.restore({"a": torch.zeros(5)})


@pytest.mark.parametrize("verify", [True, False])
def test_dtype_mismatch_raises(tmp_path, verify):
    """A leaf stored in another dtype than its target's is refused, for a
    tensor and a numpy target, instead of being cast on the way in."""
    ck = Checkpointer(tmp_path)
    ck.save(1, {"a": torch.zeros(4), "b": np.zeros(3, np.int32)},
            blocking=True)
    with pytest.raises(ValueError, match="dtype mismatch for \\['a'\\]"):
        ck.restore({"a": torch.zeros(4, dtype=torch.float64),
                    "b": np.zeros(3, np.int32)}, verify=verify)
    with pytest.raises(ValueError, match="dtype mismatch for \\['b'\\]"):
        ck.restore({"a": torch.zeros(4), "b": np.zeros(3, np.int64)},
                   verify=verify)
    got, _ = ck.restore({"a": torch.ones(4), "b": np.ones(3, np.int32)},
                        verify=verify)
    assert torch.equal(got["a"], torch.zeros(4)) and not got["b"].any()


def test_flymc_chain_resume_is_exact(tmp_path):
    """A checkpoint and restart resume the exact Markov chain: the θ
    trajectory is bitwise the uninterrupted run's."""
    data = logistic_data(jr.key(0, device=CPU), n=200, d=3, device=CPU)
    model = GLMModel.logistic(data, prior_scale=2.0, device=CPU)
    spec = model.flymc_spec(kernel="rwmh", capacity=128, cand_capacity=128,
                            q_db=0.1)
    state, _, spec = model.init_chain(spec, torch.zeros(3),
                                      jr.key(1, device=CPU), step_size=0.1)
    s_ref, ref = state, []
    for _ in range(30):
        s_ref, _ = flymc.flymc_step(spec, model.data, model.stats, s_ref)
        ref.append(s_ref.sampler.theta)

    s = state
    for _ in range(15):
        s, _ = flymc.flymc_step(spec, model.data, model.stats, s)
    ck = Checkpointer(tmp_path)
    ck.save(15, s._asdict(), blocking=True)
    restored, _ = ck.restore(_zeros(s._asdict()))
    s2, out = flymc.FlyMCState(**restored), []
    for _ in range(15):
        s2, _ = flymc.flymc_step(spec, model.data, model.stats, s2)
        out.append(s2.sampler.theta)
    assert torch.equal(torch.stack(ref[15:]), torch.stack(out))


def _tiny_firefly():
    """Undersized buffers: the init grow loop takes capacity 8 → 32 before
    the first sample, so every checkpoint of this chain holds an
    overflow-grown state."""
    data = logistic_data(jr.key(0, device=CPU), n=150, d=3, device=CPU)
    model = GLMModel.logistic(data, prior_scale=2.0, device=CPU)
    return api.firefly(model, kernel="rwmh", capacity=8, cand_capacity=8,
                       q_db=0.1, resample_fraction=0.5, num_warmup=5,
                       device=CPU)


@pytest.mark.parametrize("num_chains", [1, 2])
def test_driver_checkpoint_roundtrip_is_bitwise(tmp_path, num_chains):
    """Run half, save the final state, restore it into a freshly built
    algorithm at capacity 8 (the saved buffers are grown to 32), resume
    with ``init_state``: θ of the two halves is bitwise the uninterrupted
    run's."""
    key = jr.key(1, device=CPU)
    k_steps = jr.split(key)[1]  # a resume passes the chain key
    kw = dict(chunk_size=10, num_chains=num_chains, device=CPU)
    full = api.sample(_tiny_firefly(), key, 40, **kw)
    half = api.sample(_tiny_firefly(), key, 20, **kw)
    assert half.final_state.sampler.aux.shape[-1] > 8  # overflow-grown

    ck = Checkpointer(tmp_path)
    ck.save(20, half.final_state._asdict(), blocking=True)
    restored, _ = ck.restore(_zeros(half.final_state._asdict()))
    resumed = api.sample(_tiny_firefly(), k_steps, 20,
                         init_state=flymc.FlyMCState(**restored), **kw)
    assert torch.equal(full.theta[:, :20], half.theta)
    assert torch.equal(full.theta[:, 20:], resumed.theta)


# -------------------------------------------------------------- integrity


def test_manifest_records_file_byte_crcs(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), blocking=True)
    man = ck.manifest(1)
    assert all(isinstance(m["crc32"], int) for m in man["leaves"])
    assert ck.verify(1) == []


def _two_step_dir():
    """A fresh directory with two intact checkpoints (steps 1 and 2)."""
    d = tempfile.mkdtemp(prefix="ckpt_prop_")
    ck = Checkpointer(d)
    ck.save(1, _tree(1), blocking=True)
    ck.save(2, _tree(2), blocking=True)
    return d


def _assert_refuses_and_falls_back(d):
    """After damage to step 2: verify reports it, an explicit restore
    raises, and an unpinned restore falls back to the intact step 1."""
    ck = Checkpointer(d)
    assert ck.verify(2) != []
    assert ck.latest_intact_step() == 1
    assert ck.last_skipped == [2]
    with pytest.raises(CheckpointCorruptError):
        ck.restore(_zeros(_tree()), step=2)
    restored, man = ck.restore(_zeros(_tree()))
    assert man["step"] == 1 and ck.last_skipped == [2]
    _assert_tree_equal(restored, _tree(1))


@settings(max_examples=25, deadline=None)
@given(leaf_frac=st.floats(0.0, 1.0), pos_frac=st.floats(0.0, 1.0),
       bit=st.integers(0, 7))
def test_any_single_bit_flip_is_refused(leaf_frac, pos_frac, bit):
    """Flip ANY single bit of ANY leaf file (npy magic, header padding or
    data): restore refuses the step and falls back."""
    d = _two_step_dir()
    leaves = sorted((Path(d) / "step_00000002").glob("leaf_*.npy"))
    target = leaves[min(int(leaf_frac * len(leaves)), len(leaves) - 1)]
    raw = bytearray(target.read_bytes())
    pos = min(int(pos_frac * len(raw)), len(raw) - 1)
    raw[pos] ^= 1 << bit
    target.write_bytes(bytes(raw))
    _assert_refuses_and_falls_back(d)


@settings(max_examples=10, deadline=None)
@given(frac=st.floats(0.0, 0.99))
def test_truncated_manifest_is_refused(frac):
    d = _two_step_dir()
    mpath = Path(d) / "step_00000002" / "manifest.json"
    raw = mpath.read_bytes()
    mpath.write_bytes(raw[: int(frac * len(raw))])
    _assert_refuses_and_falls_back(d)


@settings(max_examples=10, deadline=None)
@given(leaf_frac=st.floats(0.0, 1.0), keep_frac=st.floats(0.0, 0.99))
def test_truncated_leaf_is_refused(leaf_frac, keep_frac):
    d = _two_step_dir()
    leaves = sorted((Path(d) / "step_00000002").glob("leaf_*.npy"))
    target = leaves[min(int(leaf_frac * len(leaves)), len(leaves) - 1)]
    raw = target.read_bytes()
    target.write_bytes(raw[: int(keep_frac * len(raw))])
    _assert_refuses_and_falls_back(d)


def test_missing_leaf_is_refused():
    d = _two_step_dir()
    next(iter(sorted((Path(d) / "step_00000002").glob("leaf_*.npy")))).unlink()
    _assert_refuses_and_falls_back(d)


def test_all_steps_corrupt_refuses_loudly():
    d = _two_step_dir()
    for s in (1, 2):
        (Path(d) / f"step_{s:08d}" / "manifest.json").write_bytes(b"{tor")
    ck = Checkpointer(d)
    assert ck.latest_intact_step() is None
    with pytest.raises(CheckpointCorruptError):
        ck.restore(_zeros(_tree()))
    with pytest.raises(CheckpointCorruptError):
        ck.manifest()


def test_verify_off_still_checks_shapes(tmp_path):
    """verify=False skips the CRC checks; restore still checks shapes."""
    ck = Checkpointer(tmp_path)
    ck.save(1, {"a": torch.zeros(4)}, blocking=True)
    with pytest.raises(ValueError):
        ck.restore({"a": torch.zeros(5)}, verify=False)


# ------------------------------------------------- the reference's format


class _Pair(NamedTuple):
    w: object
    b: object


def _np_tree(seed=0):
    """A numpy tree with every container kind both flatteners share."""
    rng = np.random.default_rng(seed)
    return {
        "params": _Pair(rng.standard_normal((3, 4)).astype(np.float32),
                        rng.standard_normal(4).astype(np.float32)),
        "lanes": [rng.integers(0, 9, (2, 5)).astype(np.int32),
                  (rng.random(6) < 0.5, np.uint32(7))],
        "count": np.asarray(11, np.int64),
        "words": rng.integers(0, 2**32, (2, 2), dtype=np.uint64)
                    .astype(np.uint32),
    }


def test_reference_written_step_restores_bitwise_into_the_port(tmp_path):
    """A step the reference's checkpointer writes (a typed PRNG key among
    the leaves) restores into the port bitwise; the key leaf arrives as its
    raw uint32 words in the target's dtype (the port's int64 key words)."""
    tree = _np_tree(1)
    ref_tree = dict(tree, key=jax.random.key(5))
    RefCheckpointer(tmp_path).save(3, ref_tree, blocking=True)
    ck = Checkpointer(tmp_path)
    assert ck.verify(3) == []
    target = map_with_paths(
        lambda _, a: torch.zeros_like(torch.from_numpy(np.array(a))), tree)
    target["key"] = torch.zeros(2, dtype=torch.int64)
    restored, man = ck.restore(target)
    assert man["step"] == 3
    key = restored.pop("key")
    for (p, got), (_, want) in zip(flatten_with_paths(restored),
                                   flatten_with_paths(tree), strict=True):
        assert got.numpy().dtype == np.asarray(want).dtype, p
        np.testing.assert_array_equal(got.numpy(), want)
    assert key.dtype == torch.int64
    np.testing.assert_array_equal(
        key.numpy(),
        np.asarray(jax.random.key_data(jax.random.key(5))))
    np_restored, _ = ck.restore(tree)  # numpy targets stay numpy
    _assert_tree_equal(np_restored, tree)


def test_port_written_step_verifies_and_restores_in_the_reference(tmp_path):
    tree = _np_tree(2)
    port_tree = map_with_paths(lambda _, a: torch.from_numpy(np.array(a)),
                               tree)
    Checkpointer(tmp_path).save(4, port_tree, blocking=True)
    ref = RefCheckpointer(tmp_path)
    assert ref.verify(4) == []
    restored, man = ref.restore(jax.tree.map(jnp.zeros_like, tree))
    assert man["step"] == 4
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(tree),
                         strict=True):
        got, want = np.asarray(got), np.asarray(want)
        # jax without x64 holds an int64 leaf as int32 (the value fits)
        assert got.dtype == jax.dtypes.canonicalize_dtype(want.dtype)
        np.testing.assert_array_equal(got, want)


def test_manifests_and_kill_points_match_the_reference(tmp_path):
    """The same tree through both checkpointers: equal paths, shapes,
    dtypes and files; a same-step re-save passes the same kill points in
    the same order."""
    tree = _np_tree(3)
    seen = {}
    for name, cls in (("ref", RefCheckpointer), ("port", Checkpointer)):
        ck = cls(tmp_path / name)
        points = seen[name] = []
        ck._kill_hook = points.append
        ck.save(1, tree, blocking=True)
        ck.save(1, tree, blocking=True)  # parks the first copy
    want, got = (RefCheckpointer(tmp_path / "ref").manifest(1),
                 Checkpointer(tmp_path / "port").manifest(1))
    strip = lambda m: [{k: leaf[k] for k in ("path", "file", "shape",
                                              "dtype", "prng_key")}
                       for leaf in m["leaves"]]
    assert strip(got) == strip(want)
    assert seen["port"] == seen["ref"]
    assert sorted(set(seen["port"])) == sorted(KILL_POINTS)
    # The npy files are byte for byte the reference's.
    for leaf in want["leaves"]:
        assert ((tmp_path / "port" / "step_00000001" / leaf["file"])
                .read_bytes() ==
                (tmp_path / "ref" / "step_00000001" / leaf["file"])
                .read_bytes())


def test_dataclass_fields_and_none_flatten_as_the_reference_spells_them():
    opt = AdamWState(torch.zeros((), dtype=torch.int32),
                     {"w": torch.zeros(2)}, {"w": torch.ones(2)})
    paths = [p for p, _ in flatten_with_paths({"opt": opt, "none": None})]
    assert paths == ["['opt'].step", "['opt'].m['w']", "['opt'].v['w']"]
    back = map_with_paths(lambda _, t: t + 1, opt)
    assert type(back) is AdamWState and torch.equal(back.v["w"],
                                                    torch.full((2,), 2.0))
    assert torch.equal(opt.v["w"], torch.ones(2))  # the original is kept


# ------------------------------------------------------ the port's leaves


def test_async_save_stores_the_value_at_save_time(tmp_path):
    """An in-place write to a saved tensor after an async ``save`` returns
    (the writer held at its first kill point until then) does not reach
    the disk: the snapshot is a copy taken before ``save`` returns."""
    import threading

    ck = Checkpointer(tmp_path)
    go = threading.Event()
    ck._kill_hook = lambda p: go.wait(10) if p == "begin" else None
    tree = _tree(4)
    want = tree["a"].clone()
    ck.save(1, tree)
    tree["a"].add_(1.0)  # as a collector's in-place update would
    tree["nested"]["b"][0] = 99
    go.set()
    ck.wait()
    restored, _ = ck.restore(_zeros(tree))
    assert torch.equal(restored["a"], want)
    assert int(restored["nested"]["b"][0]) == 0


def test_host_values_round_trip_as_python_values(tmp_path):
    """Host ints, floats, bools and strs (a lane's job id and count, a
    collector's counters) come back as the same Python values and types,
    not as tensors; tuples, lists and None keep their kind."""
    tree = {"job_id": "robust-3", "count": 96, "rate": 0.25, "done": True,
            "carry": {"n": 7, "count": [3, 4], "shape": (5, 2),
                      "theta": torch.arange(6.0)},
            "absent": None}
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=True)
    target = {"job_id": "", "count": 0, "rate": 0.0, "done": False,
              "carry": {"n": 0, "count": [0, 0], "shape": (0, 0),
                        "theta": torch.zeros(6)}, "absent": None}
    restored, _ = ck.restore(target)
    _assert_tree_equal(restored, tree)  # types and values, leaf by leaf
    host = {k: v for k, v in restored.items() if k != "carry"}
    assert host == {k: v for k, v in tree.items() if k != "carry"}
    carry = restored["carry"]
    assert (carry["n"], carry["count"], carry["shape"]) == (7, [3, 4], (5, 2))
    assert type(carry["count"]) is list and type(carry["shape"]) is tuple


def test_bf16_round_trips_as_its_uint16_bits(tmp_path):
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    tree = {"w": x.to(torch.bfloat16), "m": x}
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=True)
    leaf = {m["path"]: m for m in ck.manifest(1)["leaves"]}["['w']"]
    assert leaf["dtype"] == "bfloat16"
    stored = np.load(tmp_path / "step_00000001" / leaf["file"])
    assert stored.dtype == np.uint16
    np.testing.assert_array_equal(
        stored, tree["w"].view(torch.int16).numpy().view(np.uint16))
    restored, _ = ck.restore(_zeros(tree))
    _assert_tree_equal(restored, tree)


def test_restore_places_leaves_on_the_asked_device(tmp_path, monkeypatch):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), blocking=True)
    restored, _ = ck.restore(_zeros(_tree()), device="cpu")
    assert all(t.device.type == "cpu"
               for _, t in flatten_with_paths(restored))
    with pytest.raises(NotImplementedError, match="item 7"):
        ck.restore(_zeros(_tree()), shardings={"a": None})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore(_zeros(_tree()), device="cuda")  # no silent CPU fallback


# ------------------------------------------------------------ the trainer


def test_train_reduced_resume_is_bitwise(tmp_path):
    """4 steps contiguous against 2 steps, a save, a fresh call that
    restores and 2 more: losses, final parameters, AdamW state and the
    batch generator's state are bitwise equal (the two runs' final
    checkpoints are byte for byte the same)."""
    kw = dict(batch=2, seq=17, warmup_steps=1, dtype=torch.float32,
              device=CPU, log_every=100, ckpt_every=2)
    whole, first = tmp_path / "whole", tmp_path / "split"
    m1, h1 = train_reduced("recurrentgemma-9b", steps=4, ckpt_dir=whole, **kw)
    _, ha = train_reduced("recurrentgemma-9b", steps=2, ckpt_dir=first, **kw)
    m2, hb = train_reduced("recurrentgemma-9b", steps=4, ckpt_dir=first, **kw)
    assert [h["step"] for h in hb] == [2, 3]
    assert [h["loss"] for h in h1] == [h["loss"] for h in ha + hb]
    for (n, p), (_, q) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(p, q), n
    a, b = Checkpointer(whole), Checkpointer(first)
    assert a.all_steps() == b.all_steps() == [2, 4]
    man = a.manifest(4)
    for leaf in man["leaves"]:  # params, AdamW m/v/step and the generator
        assert ((whole / "step_00000004" / leaf["file"]).read_bytes() ==
                (first / "step_00000004" / leaf["file"]).read_bytes()), \
            leaf["path"]
    opt_paths = [m["path"] for m in man["leaves"] if m["path"].startswith(
        "['opt']")]
    assert "['opt'].step" in opt_paths and len(opt_paths) == 1 + 2 * len(
        list(m1.parameters()))
    assert "['gen']" in [m["path"] for m in man["leaves"]]
