"""The rest of the port's ``api``: collectors, peeks, chunk hooks, the
health sentinel, thinning, the masked fold and the data-operand step.

Each new collector is held against :mod:`repro.api.collectors` on the same
stream of θ and StepStats: ``ThinnedTrace`` bitwise; ``BatchMeansESS``,
``PosteriorPredictive`` and ``RHat.peek`` within 1e-6 relative (float32
updates in another order). ``ChunkEvent.peek`` at each boundary is held
against the JAX driver's on the same chain (every θ decision's margin
asserted ≥ 1e-4 first) within 1e-5 relative. Within the port everything is
bitwise: peeking, the masked fold against a shorter solo run, the operand
form of the step against the closure form, and what ``tests/test_api.py``,
``tests/test_collectors.py`` and ``tests/test_chain_batching.py`` pin for
these surfaces.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import collectors as JC
from repro.core.flymc import StepStats as JStepStats
from repro.data import logistic_data as jax_logistic_data
from repro.models.bayes_glm import GLMModel as JGLMModel
from repro_torch import api, convert
from repro_torch import random as jr
from repro_torch.api import collectors as C
from repro_torch.api import driver as driver_lib
from repro_torch.core import diagnostics
from repro_torch.core import flymc as tflymc
from repro_torch.core.flymc import StepStats
from repro_torch.data import logistic_data
from repro_torch.models.bayes_glm import GLMModel, run_regular_mcmc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

CPU = "cpu"
N, D = 400, 4
REL = 1e-6


@pytest.fixture(scope="module")
def model():
    data = logistic_data(jr.key(0, device=CPU), n=N, d=D, separation=1.5,
                         device=CPU)
    return GLMModel.logistic(data, prior_scale=2.0, xi=1.5, device=CPU)


ENGINES = {"plain": dict(backend="jnp", z_backend="jnp"),
           "kernels": dict(backend="pallas", z_backend="fused")}


def _alg(model, cap=128, engine="kernels", **kw):
    kw = {"cand_capacity": cap, **ENGINES[engine], **kw}
    return api.firefly(model, kernel="rwmh", capacity=cap, q_db=0.1,
                       step_size=0.1, device=CPU, **kw)


@pytest.fixture(scope="module")
def alg(model):
    return _alg(model)


def _all_builtins(model):
    return {
        "full": api.FullTrace(),
        "thin": api.ThinnedTrace(4),
        "moments": api.OnlineMoments(),
        "rhat": api.RHat(),
        "ess": api.BatchMeansESS(num_batches=8),
        "pp": api.PosteriorPredictive(x_eval=model.data.x[:7]),
        "queries": api.QueryBudget(),
    }


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(a, b)


def _sample(alg, key, n, **kw):
    return api.sample(alg, jr.key(key, device=CPU), n, device=CPU, **kw)


# ---------------------------------------------------------------------------
# Each new collector against the JAX package on one stream
# ---------------------------------------------------------------------------


def _stream(k=2, s=43, d=3, seed=0):
    rng = np.random.default_rng(seed)
    theta = (5.0 + rng.standard_normal((k, s, d)).cumsum(1) * 0.3).astype(
        np.float32)
    stats = dict(n_bright=rng.integers(0, 50, (k, s)),
                 lik_queries=rng.integers(0, 1000, (k, s)),
                 accept_prob=rng.random((k, s)).astype(np.float32),
                 overflow=np.zeros((k, s), bool),
                 joint_lp=rng.standard_normal((k, s)).astype(np.float32))
    return theta, stats


def _jax_fold(col, theta, stats, upto):
    """The JAX collector's carry after ``upto`` updates of each chain,
    stacked with a leading chain axis."""
    k, s, d = theta.shape
    pos = jax.ShapeDtypeStruct((d,), jnp.float32)
    st = JStepStats(*(jax.ShapeDtypeStruct((), jnp.asarray(stats[f]).dtype)
                      for f in JStepStats._fields))
    update = jax.jit(col.update)
    carries = []
    for c in range(k):
        carry = col.init(s, pos, st)
        for t in range(upto):
            carry = update(carry, jnp.asarray(theta[c, t]), JStepStats(
                *(jnp.asarray(stats[f][c, t]) for f in JStepStats._fields)))
        carries.append(carry)
    return jax.tree.map(lambda *ls: jnp.stack(ls), *carries)


def _port_fold(col, theta, stats, upto):
    k, s, d = theta.shape
    th = torch.from_numpy(theta)
    st = {f: torch.from_numpy(np.asarray(stats[f])) for f in StepStats._fields}
    pos0 = torch.zeros(k, d)
    info0 = StepStats(*(torch.zeros_like(st[f][:, 0]) for f in StepStats._fields))
    carry = col.init(s, pos0, info0)
    for t in range(upto):
        carry = col.update(carry, th[:, t], StepStats(
            *(st[f][:, t] for f in StepStats._fields)))
    return carry


def _close(got, want, rel):
    if isinstance(want, dict):
        for key in want:
            _close(got[key], want[key], rel)
    elif want is None:
        assert got is None
    else:
        w = np.asarray(want, np.float64)
        g = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                       np.float64)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rel, atol=0)


def test_thinned_trace_matches_jax_bitwise():
    theta, stats = _stream()
    for thin, upto in ((4, 43), (1, 10), (5, 43), (50, 43)):
        j = JC.ThinnedTrace(thin).finalize(
            _jax_fold(JC.ThinnedTrace(thin), theta, stats, upto))
        t = C.ThinnedTrace(thin).finalize(
            _port_fold(C.ThinnedTrace(thin), theta, stats, upto))
        np.testing.assert_array_equal(t["theta"].numpy(),
                                      np.asarray(j["theta"]))
    with pytest.raises(ValueError):
        C.ThinnedTrace(0)


def test_batch_means_ess_matches_jax():
    """Within 1e-6 relative: τ and ESS from the same float32 carry
    arithmetic, finalized in float64."""
    theta, stats = _stream(s=64)
    for nb, upto in ((8, 64), (8, 37), (2, 64)):
        j = JC.BatchMeansESS(nb).finalize(
            _jax_fold(JC.BatchMeansESS(nb), theta, stats, upto))
        t = C.BatchMeansESS(nb).finalize(
            _port_fold(C.BatchMeansESS(nb), theta, stats, upto))
        _close(t, j, REL)
    with pytest.raises(ValueError):
        C.BatchMeansESS(1)


def test_posterior_predictive_matches_jax():
    theta, stats = _stream()
    x_eval = np.random.default_rng(3).standard_normal((9, 3)).astype(np.float32)
    j = JC.PosteriorPredictive(x_eval=x_eval)
    t = C.PosteriorPredictive(x_eval=torch.from_numpy(x_eval))
    _close(t.finalize(_port_fold(t, theta, stats, 43)),
           j.finalize(_jax_fold(j, theta, stats, 43)), REL)
    with pytest.raises(ValueError):
        C.PosteriorPredictive()


@pytest.mark.parametrize("upto", [1, 5, 21, 22, 30, 43])
def test_rhat_peek_matches_jax(upto):
    """Mid-run R̂ over the usable splits (inf while fewer than two), at
    every stage of the second split filling, within 1e-6 relative."""
    theta, stats = _stream()
    j = JC.RHat().peek(_jax_fold(JC.RHat(), theta, stats, upto))
    t = C.RHat().peek(_port_fold(C.RHat(), theta, stats, upto))
    assert t["splits_used"] == j["splits_used"]
    _close(t, j, REL)


# ---------------------------------------------------------------------------
# Peeks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_chains", [1, 2])
def test_peek_then_continue_is_bitwise(model, alg, num_chains):
    """Peeking every built-in collector at every boundary leaves the run
    bitwise one that never peeked."""
    ref = _sample(alg, 3, 48, chunk_size=16, num_chains=num_chains,
                  collectors=_all_builtins(model))
    peeked = {}

    def hook(ev):
        peeked[ev.committed] = {n: ev.peek(n) for n in _all_builtins(model)}
        return False

    tr = _sample(alg, 3, 48, chunk_size=16, num_chains=num_chains,
                 collectors=_all_builtins(model), on_chunk=hook)
    assert sorted(peeked) == [16, 32, 48]
    for name in ref.results:
        _eq(ref.results[name], tr.results[name])


def test_final_boundary_peek_matches_finalize(model, alg):
    last = {}

    def hook(ev):
        if ev.committed == 48:
            last.update({n: ev.peek(n) for n in _all_builtins(model)})
        return False

    tr = _sample(alg, 3, 48, chunk_size=16, collectors=_all_builtins(model),
                 on_chunk=hook)
    for name, res in tr.results.items():
        got = last[name]
        if isinstance(res, dict):
            common = set(res) & set(got)
            assert common
            res = {k: res[k] for k in common}
            got = {k: got[k] for k in common}
        _eq(res, got)


def test_peek_result_never_aliases_live_carry(model, alg):
    """Writing into a peeked buffer must not reach the run's results."""
    ref = _sample(alg, 5, 32, chunk_size=16,
                  collectors={"full": api.FullTrace()})

    def hook(ev):
        if ev.committed == 16:
            pk = ev.peek("full")
            assert torch.equal(pk["theta"][:, :16],
                               ref.results["full"]["theta"][:, :16])
            pk["theta"].fill_(float("nan"))
            pk["stats"].joint_lp.fill_(float("nan"))
        return False

    tr = _sample(alg, 5, 32, chunk_size=16,
                 collectors={"full": api.FullTrace()}, on_chunk=hook)
    _eq(ref.results["full"], tr.results["full"])


def test_module_peek_falls_back_to_finalize_on_a_clone():
    class Bare:  # the bare (init, update, finalize) protocol, no peek
        def init(self, num_samples, position, stats):
            return {"buf": position.new_zeros(2, 3), "n": [0]}

        def update(self, carry, position, stats):
            return carry

        def finalize(self, carry):
            carry["buf"].add_(1.0)
            carry["n"].append(1)
            return carry

    col = Bare()
    carry = col.init(4, torch.zeros(2, 3), None)
    out = C.peek(col, carry)
    assert float(out["buf"].sum()) == 6.0 and out["n"] == [0, 1]
    assert float(carry["buf"].sum()) == 0.0 and carry["n"] == [0]


# ---------------------------------------------------------------------------
# The driver: thin, on_chunk, health_check
# ---------------------------------------------------------------------------


def test_thinning(model, alg):
    full = _sample(alg, 4, 40, chunk_size=20)
    thinned = _sample(alg, 4, 40, chunk_size=20, thin=4)
    assert thinned.theta.shape == (1, 10, D)
    assert torch.equal(thinned.theta, full.theta[:, 3::4])
    assert thinned.stats.lik_queries.shape == (1, 40)  # stats stay per step
    odd = _sample(alg, 4, 43, chunk_size=17, thin=4)
    assert torch.equal(odd.theta, _sample(alg, 4, 43)
                       .theta[:, 3::4])


def test_thinned_trace_collector_matches_host_slice(alg):
    full = _sample(alg, 2, 43, chunk_size=17)
    thinned = _sample(alg, 2, 43, chunk_size=17,
                      collectors={"t": api.ThinnedTrace(4)})
    got = thinned.results["t"]["theta"]
    assert got.shape == (1, 43 // 4, D)
    assert torch.equal(got, full.theta[:, 3::4])
    tiny = _sample(alg, 2, 3, collectors={"t": api.ThinnedTrace(4)})
    assert tiny.results["t"]["theta"].shape == (1, 0, D)


def test_thin_kwarg_with_collectors_raises(alg):
    with pytest.raises(ValueError, match="ThinnedTrace"):
        _sample(alg, 0, 10, thin=2, collectors={"m": api.OnlineMoments()})
    with pytest.raises(ValueError):
        _sample(alg, 0, 10, thin=0)


@pytest.mark.parametrize("num_chains", [1, 2])
def test_on_chunk_early_stop_holds_only_the_committed_prefix(alg, num_chains):
    full = _sample(alg, 6, 48, chunk_size=16, num_chains=num_chains)
    seen = []

    def hook(ev):
        seen.append((ev.start, ev.size, ev.committed, ev.num_samples))
        assert torch.equal(ev.state.iteration,
                           torch.full((num_chains,), ev.committed))
        return ev.committed >= 32

    tr = _sample(alg, 6, 48, chunk_size=16, num_chains=num_chains,
                 on_chunk=hook)
    assert seen == [(0, 16, 16, 48), (16, 16, 32, 48)]
    assert torch.equal(tr.theta, full.theta[:, :32])
    for a, b in zip(tr.stats, full.stats):
        assert torch.equal(a, b[:, :32])
    assert tr.total_queries == int(full.stats.lik_queries[:, :32].sum())
    # streaming collectors simply saw fewer updates
    col = _sample(alg, 6, 48, chunk_size=16, num_chains=num_chains,
                  on_chunk=lambda ev: ev.committed >= 32,
                  collectors={"m": api.OnlineMoments(cov=False)})
    assert (col.results["m"]["count"] == 32).all()
    np.testing.assert_array_equal(col.results["m"]["mean"],
                                  C.OnlineMoments(cov=False).finalize(
                                      _moments_of(full.theta[:, :32]))["mean"])


def _moments_of(theta):
    col = C.OnlineMoments(cov=False)
    carry = col.init(theta.shape[1], theta[:, 0], None)
    for t in range(theta.shape[1]):
        carry = col.update(carry, theta[:, t], None)
    return carry


def test_health_check_raises_before_the_fold():
    """A dataset poisoned at the first boundary: the second chunk is
    non-finite, so the run raises there, and the carry still holds exactly
    the first chunk (the fold never ran)."""
    data = logistic_data(jr.key(0, device=CPU), n=N, d=D, separation=1.5,
                         device=CPU)
    model = GLMModel.logistic(data, prior_scale=2.0, device=CPU)
    alg = _alg(model)
    clean = _sample(alg, 7, 32, chunk_size=16)
    events = []

    def hook(ev):
        events.append(ev)
        alg.data.x[:, 0] = float("nan")  # poison in place for what follows
        return False

    with pytest.raises(api.NonFiniteError, match="committed prefix of 16"):
        _sample(alg, 7, 32, chunk_size=16, health_check=True,
                collectors={"t": api.FullTrace()}, on_chunk=hook)
    (ev,) = events
    held = ev.peek("t")
    assert torch.equal(held["theta"][:, :16], clean.theta[:, :16])
    assert not held["theta"][:, 16:].any()
    assert ev._carries["t"]["n"] == 16


def test_health_check_off_and_healthy_runs_are_unchanged(alg):
    a = _sample(alg, 8, 32, chunk_size=16)
    b = _sample(alg, 8, 32, chunk_size=16, health_check=True)
    assert torch.equal(a.theta, b.theta)


def test_finite_lanes():
    a = torch.ones(3, 4)
    a[1, 2] = float("inf")
    b = torch.ones(5, 3)
    b[4, 0] = float("nan")
    ints = torch.zeros(3, dtype=torch.int64)
    assert api.finite_lanes([a, ints]).tolist() == [True, False, True]
    assert api.finite_lanes([b], lane_axis=1).tolist() == [False, True, True]
    assert api.finite_lanes([a, b.T]).tolist() == [False, False, True]
    assert api.finite_lanes([ints]) is None


def test_at_most_one_host_read_per_chunk(model, monkeypatch):
    """One host read a chunk, with the health check folded into it: besides
    the chunks' reads only the init-overflow check and the final query
    total read the device."""
    alg = _alg(model, cap=256)
    _sample(alg, 2, 8, chunk_size=8)
    calls = {"n": 0}
    for name in ("__bool__", "tolist", "item"):
        real = getattr(torch.Tensor, name)

        def counting(self, *a, _real=real, **kw):
            calls["n"] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    _sample(alg, 2, 128, chunk_size=32, health_check=True)
    assert calls["n"] <= 128 // 32 + 2, calls["n"]


# ---------------------------------------------------------------------------
# The masked fold, the operand form, output_structs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_chains", [1, 2])
def test_masked_fold_equals_a_solo_run_of_max_count(model, alg, num_chains):
    """Folding 48 committed steps with ``max_count=40`` skips the overshoot:
    every carry is bitwise a solo run of 40 samples (collectors sized for
    40, as a serve group sizes them for max_samples)."""
    colls = {n: c for n, c in _all_builtins(model).items()}
    ref = _sample(alg, 9, 40, chunk_size=16, num_chains=num_chains,
                  collectors=colls)
    full = _sample(alg, 9, 48, chunk_size=16, num_chains=num_chains,
                   collectors={"full": api.FullTrace()}).results["full"]
    pos0, info0 = alg.output_structs(
        _init_state(alg, jr.key(9, device=CPU), num_chains))
    carries = {n: c.init(40, pos0, info0) for n, c in colls.items()}
    fold = driver_lib.make_collector_fold(colls, max_count=40)
    count = 0
    steps = [(full["theta"][:, t], StepStats(*(a[:, t] for a in full["stats"])))
             for t in range(48)]
    for start in range(0, 48, 16):
        carries, count = fold(carries, count, steps[start:start + 16])
    assert count == 40
    for n, c in colls.items():
        _eq(c.finalize(carries[n]), ref.results[n])
    plain = driver_lib.make_collector_fold(colls)
    again = {n: c.init(48, pos0, info0) for n, c in colls.items()}
    again = plain(again, steps)
    assert again["full"]["n"] == 48


def _init_state(alg, key, num_chains):
    ks = jr.split(key)
    keys = jr.split(ks[0], num_chains) if num_chains > 1 else ks[0][None]
    return alg.init(keys, alg.default_position.expand(num_chains, -1).clone())


@pytest.mark.parametrize("engine", list(ENGINES))
def test_step_data_is_bitwise_the_closure_form(model, engine):
    """The operand form on copies of the data and statistics gives the
    closure form's bits, step after step; ``step_chains_data`` is the same
    callable (the port's step is chain-batched)."""
    alg = _alg(model, cap=64, engine=engine)
    assert alg.step_chains_data is alg.step_data
    assert alg.data is model.data
    data = type(alg.data)(*(a.clone() for a in alg.data))
    stats = type(alg.stats)(*(a.clone() for a in alg.stats))
    chain_keys = jr.split(jr.key(11, device=CPU), 2)
    a = b = _init_state(alg, jr.key(10, device=CPU), 2)
    for i in range(12):
        keys = jr.fold_in(chain_keys, i)
        a, sa = alg.step(keys, a)
        b, sb = alg.step_data(keys, b, data, stats)
        _eq(tuple(a), tuple(b))
        _eq(tuple(sa), tuple(sb))


def test_output_structs_match_a_real_step(model, alg):
    for a in (alg, api.regular_mcmc(model, device=CPU)):
        st = _init_state(a, jr.key(1, device=CPU), 2)
        pos, info = a.output_structs(st)
        new, real = a.step(jr.split(jr.key(2, device=CPU), 2), st)
        assert pos.shape == a.position_of(new).shape
        assert pos.dtype == a.position_of(new).dtype
        for s, r in zip(info, real):
            assert s.shape == r.shape and s.dtype == r.dtype
            assert not s.any()


# ---------------------------------------------------------------------------
# Re-pins of tests/test_collectors.py and tests/test_chain_batching.py
# ---------------------------------------------------------------------------


def test_default_path_is_fulltrace_bitwise(alg):
    default = _sample(alg, 1, 50, chunk_size=16)
    explicit = _sample(alg, 1, 50, chunk_size=16,
                       collectors={"trace": api.FullTrace()})
    assert explicit.theta is None and explicit.stats is None
    assert torch.equal(default.theta, explicit.results["trace"]["theta"])
    _eq(tuple(default.stats), tuple(explicit.results["trace"]["stats"]))


def test_batch_means_ess_matches_offline_and_geyer(alg):
    tr = _sample(alg, 5, 512, chunk_size=128,
                 collectors={"e": api.BatchMeansESS(num_batches=16),
                             "full": api.FullTrace()})
    off = tr.results["full"]["theta"][0].double().numpy()
    res = tr.results["e"]
    expected = diagnostics.batch_means_ess(off, num_batches=16)
    np.testing.assert_allclose(res["ess"][0], expected, rtol=1e-3)
    geyer = diagnostics.effective_sample_size(off)
    assert 0.1 < res["ess"][0] / geyer < 10.0


def test_posterior_predictive_matches_offline(model, alg):
    x_eval = model.data.x[:9]
    tr = _sample(alg, 6, 200, chunk_size=64,
                 collectors={"pp": api.PosteriorPredictive(x_eval=x_eval),
                             "full": api.FullTrace()})
    off = tr.results["full"]["theta"][0]
    expected = torch.sigmoid(off @ x_eval.T).mean(0).numpy()
    np.testing.assert_allclose(tr.results["pp"]["mean_prob"][0], expected,
                               rtol=0, atol=1e-5)
    assert int(tr.results["pp"]["count"][0]) == 200


def test_all_collectors_bitwise_invariant_to_capacity_overflow(model):
    big = _sample(_alg(model, cap=N), 12, 48, chunk_size=16, num_chains=2,
                  collectors=_all_builtins(model))
    small = _sample(_alg(model, cap=128, cand_capacity=4), 12, 48,
                    chunk_size=16, num_chains=2,
                    collectors=_all_builtins(model))
    assert small.algorithm.spec.cand_capacity > 4  # grew mid-run
    assert small.steps_run > 48  # and re-ran chunks
    for n in big.results:
        _eq(big.results[n], small.results[n])


def test_collectors_bitwise_invariant_to_chunk_size(model, alg):
    a = _sample(alg, 13, 40, chunk_size=40, collectors=_all_builtins(model))
    b = _sample(alg, 13, 40, chunk_size=7, collectors=_all_builtins(model))
    for n in a.results:
        _eq(a.results[n], b.results[n])


def test_collectors_only_trace_fields_are_none(alg):
    tr = _sample(alg, 0, 20, collectors={"m": api.OnlineMoments(),
                                         "q": api.QueryBudget()})
    assert tr.theta is None and tr.stats is None
    assert tr.total_queries == tr.results["q"]
    assert _sample(alg, 0, 20, collectors={}).results == {}


def test_validate_collectors_rejects_bad_inputs(alg):
    with pytest.raises(TypeError):
        _sample(alg, 0, 4, collectors=[api.FullTrace()])
    with pytest.raises(TypeError):
        _sample(alg, 0, 4, collectors={1: api.FullTrace()})
    with pytest.raises(TypeError, match="protocol"):
        _sample(alg, 0, 4, collectors={"x": object()})


def test_collectors_work_with_regular_mcmc(model):
    base = api.regular_mcmc(model, kernel="rwmh", step_size=0.1, device=CPU)
    tr = _sample(base, 14, 64, chunk_size=32, num_chains=2,
                 collectors={"thin": api.ThinnedTrace(2),
                             "ess": api.BatchMeansESS(num_batches=4),
                             "full": api.FullTrace()})
    full = tr.results["full"]["theta"]
    assert torch.equal(tr.results["thin"]["theta"], full[:, 1::2])
    assert np.isfinite(tr.results["ess"]["ess"]).all()


def test_multi_chain_collectors_equal_per_chain_runs(model, alg):
    """Chain batching: each chain of a 2-chain run, collectors included,
    equals that chain run alone from its own keys."""
    colls = lambda: {"thin": api.ThinnedTrace(3),
                     "ess": api.BatchMeansESS(num_batches=4),
                     "pp": api.PosteriorPredictive(x_eval=model.data.x[:5])}
    key = jr.key(15, device=CPU)
    both = api.sample(alg, key, 36, num_chains=2, chunk_size=12,
                      collectors=colls(), device=CPU)
    k_init, k_steps = jr.split(key)
    init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
    for c in range(2):
        st = alg.init(init_keys[c:c + 1], alg.default_position[None])
        one = api.sample(alg, chain_keys[c], 36, init_state=st, chunk_size=12,
                         collectors=colls(), device=CPU)
        assert torch.equal(one.results["thin"]["theta"][0],
                           both.results["thin"]["theta"][c])
        np.testing.assert_array_equal(one.results["pp"]["mean_prob"][0],
                                      both.results["pp"]["mean_prob"][c])
        np.testing.assert_array_equal(one.results["ess"]["tau"][0],
                                      both.results["ess"]["tau"][c])


# ---------------------------------------------------------------------------
# The deprecated shims (tests/test_api.py's run_chain pins)
# ---------------------------------------------------------------------------


def test_legacy_run_chain_shim_matches_sample(model, alg):
    spec = alg.spec
    key = jr.key(16, device=CPU)
    theta0 = alg.default_position
    state, setup_q, spec2 = model.init_chain(spec, theta0, key, step_size=0.1)
    assert setup_q == int(state.bright.num[0]) and spec2.capacity >= setup_q
    samples, trace_dicts, total_q, _ = model.run_chain(spec2, state, 30)
    ref = api.sample(api.algorithm_from_spec(spec2, model.data, model.stats),
                     state.rng[0], 30, init_state=state, device=CPU)
    assert torch.equal(torch.stack(samples), ref.theta[0])
    assert total_q == ref.total_queries
    assert [d["lik_queries"] for d in trace_dicts] == \
        ref.stats.lik_queries[0].tolist()
    # the collect= host loop keys and grows exactly as the driver: with a
    # candidate buffer of 8 it overflows mid-run and re-runs those steps
    small = dataclasses.replace(spec2, cand_capacity=8)
    host, host_dicts, host_q, grown = tflymc.run_chain(
        small, model.data, model.stats, state, 30,
        collect=lambda s: s.sampler.theta[0].clone())
    assert grown.cand_capacity > 8
    assert torch.equal(torch.stack(host), ref.theta[0])
    assert host_q == total_q and host_dicts == trace_dicts


def test_resume_offset_also_fixes_the_legacy_host_loop(model, alg):
    state, _, spec = model.init_chain(alg.spec, alg.default_position,
                                      jr.key(17, device=CPU))
    take = lambda s: s.sampler.theta[0].clone()
    full, *_ = tflymc.run_chain(spec, model.data, model.stats, state, 20,
                                collect=take)
    ref = api.sample(api.algorithm_from_spec(spec, model.data, model.stats),
                     state.rng[0], 20, init_state=state, device=CPU)
    assert torch.equal(torch.stack(full), ref.theta[0])
    first = api.sample(api.algorithm_from_spec(spec, model.data, model.stats),
                       state.rng[0], 8, init_state=state, device=CPU)
    mid = first.final_state._replace(rng=state.rng)  # the chain's key
    rest, *_ = tflymc.run_chain(spec, model.data, model.stats, mid, 12,
                                collect=take)
    assert torch.equal(torch.stack(rest), ref.theta[0, 8:])


def test_run_regular_mcmc_shim(model):
    theta0 = torch.zeros(D)
    samples, queries = run_regular_mcmc(model, theta0, jr.key(18, device=CPU),
                                        25, step_size=0.05)
    ref = api.sample(api.regular_mcmc(model, step_size=0.05, device=CPU),
                     jr.key(18, device=CPU), 25, init_position=theta0,
                     device=CPU)
    assert torch.equal(torch.stack(samples), ref.theta[0])
    assert queries == [N] * 25


# ---------------------------------------------------------------------------
# ChunkEvent.peek against the JAX driver on the same chain
# ---------------------------------------------------------------------------


def test_chunk_event_peeks_match_the_jax_driver():
    """The same chain in both packages (plain engines, MAP-free logistic
    model, 2 chains, 48 steps): every θ decision's margin ≥ 1e-4, equal
    decisions, and at each boundary of 16 the peeks of R̂, the moments and
    the thinned trace within 1e-5 relative of the JAX driver's."""
    from test_torch_serve_jax import _decisions, _jax_margin_fn

    jdata = jax_logistic_data(jax.random.key(0), n=N, d=D, separation=1.5)
    jmodel = JGLMModel.logistic(jdata, prior_scale=2.0, xi=1.5)
    jalg = japi.firefly(jmodel, kernel="rwmh", capacity=128,
                        cand_capacity=128, q_db=0.1, step_size=0.1)
    jcolls = lambda: {"rhat": JC.RHat(), "moments": JC.OnlineMoments(),
                      "thin": JC.ThinnedTrace(4)}
    key = jax.random.key(19)
    jpeeks, states = {}, []

    def jhook(ev):
        states.append(ev.state)
        if ev.committed % 16 == 0:
            jpeeks[ev.committed] = {n: ev.peek(n) for n in jcolls()}
        return False

    jtr = japi.sample(jalg, key, 48, num_chains=2, chunk_size=1,
                      collectors={**jcolls(), "full": JC.FullTrace()},
                      on_chunk=jhook)
    k_init, k_steps = jax.random.split(key)
    chain_keys = jax.random.split(k_steps, 2)
    init = jax.jit(jalg.batched_init())(
        jax.random.split(k_init, 2), jnp.zeros((2, D)))
    signed = _jax_margin_fn(jalg)
    per_step = [init] + states[:-1]
    m = np.array([[float(signed(jax.tree.map(lambda l: l[c], st),
                                jax.random.fold_in(chain_keys[c], i)))
                   for i, st in enumerate(per_step)] for c in range(2)])
    jtheta = np.asarray(jtr.results["full"]["theta"])
    theta0 = np.zeros((2, D), np.float32)
    assert np.array_equal(m > 0, _decisions(jtheta, theta0))
    if not np.abs(m).min() >= 1e-4:
        pytest.fail(f"an accept test is within {np.abs(m).min():.3g} of its "
                    "edge; decisions cannot be compared on this seed")

    d = jax.device_get(jdata)
    tmodel = GLMModel.logistic(convert.glm_data(d.x, d.t, d.xi, device=CPU),
                               prior_scale=2.0, xi=1.5, device=CPU)
    talg = _alg(tmodel, engine="plain")
    tcolls = {"rhat": api.RHat(), "moments": api.OnlineMoments(),
              "thin": api.ThinnedTrace(4), "full": api.FullTrace()}
    tpeeks = {}

    def thook(ev):
        tpeeks[ev.committed] = {n: ev.peek(n) for n in jcolls()}
        return False

    ttr = _sample(talg, 19, 48, num_chains=2, chunk_size=16,
                  collectors=tcolls, on_chunk=thook)
    got = ttr.results["full"]["theta"].numpy()
    assert np.array_equal(_decisions(got, theta0), _decisions(jtheta, theta0))
    np.testing.assert_allclose(got, jtheta, rtol=0,
                               atol=1e-5 * np.abs(jtheta).max())
    assert sorted(tpeeks) == sorted(jpeeks) == [16, 32, 48]
    for b in (16, 32, 48):
        t, j = tpeeks[b], jpeeks[b]
        _close(t["rhat"], j["rhat"], 1e-5)
        _close(t["moments"]["mean"], j["moments"]["mean"], 1e-5)
        np.testing.assert_allclose(t["thin"]["theta"].numpy(),
                                   np.asarray(j["thin"]["theta"]), rtol=0,
                                   atol=1e-5 * np.abs(jtheta).max())
