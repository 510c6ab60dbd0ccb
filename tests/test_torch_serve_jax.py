"""The port's sampling service against the JAX package, on the CPU.

Each job of :func:`benchmarks._util.job_mix` (the sizes of
``tests/test_serve.py``), run solo in the port on the plain engines (the
reference ``Job``'s default), against ``repro.api.sample`` of
``repro.serve.job.build_algorithm(job)`` over the whole run; then the
port's packed results against the JAX ``Service``'s. Every θ accept
decision's margin |log u − log ratio| is asserted ≥ 1e-4 before decisions
are compared; accept decisions must be equal and θ within 1e-5 of its
largest value (the packages' normals differ by a few ulps,
``repro_torch.random``). Bright counts and query counts must be equal, and
R̂ within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import collectors as JC
from repro.core import brightness as jbrightness
from repro.core import flymc as jflymc
from repro.serve import Service as JService
from repro.serve import job as jjob_lib
from repro_torch.serve import Service
from test_torch_serve import CHUNK, MAX, _jax_mix, mix, solo

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

MARGIN = 1e-4
THETA_TOL = 1e-5

JAX_MIX = _jax_mix()  # the same jobs and data as mix() carries across


def _jax_margin_fn(alg):
    """jit(state, key) -> log ratio − log u of the next RWMH θ decision of
    one chain, keyed as the JAX driver keys it."""
    spec = alg.spec

    @jax.jit
    def signed(state, key):
        key_theta = jax.random.split(key, 3)[0]
        k_prop, k_acc = jax.random.split(key_theta)
        idx, mask = jbrightness.bright_buffer(state.bright, spec.capacity)
        f = jflymc.make_joint_logpost(spec, alg.data, alg.stats, idx, mask)
        th = state.sampler.theta
        eta = jnp.exp(state.log_step) * jax.random.normal(k_prop, th.shape,
                                                          th.dtype)
        log_ratio = f(th + eta)[0] - state.sampler.lp
        return log_ratio - jnp.log(jax.random.uniform(k_acc, (),
                                                       state.sampler.lp.dtype))

    return signed


def _decisions(theta, theta0):
    """(K, S) accept decisions of a trace: did θ move at each step."""
    prev = np.concatenate([theta0[:, None], theta[:, :-1]], axis=1)
    return np.any(theta != prev, axis=tuple(range(2, theta.ndim)))


_JAX_SOLO = {}


def jax_solo(jjob, steps=MAX):
    """The JAX solo run of a mix job over ``steps`` iterations: θ trace,
    stats, each step's signed decision margin, and the initial θ."""
    if (jjob.job_id, steps) in _JAX_SOLO:
        return _JAX_SOLO[(jjob.job_id, steps)]
    alg = jjob_lib.build_algorithm(jjob)
    k = jjob.num_chains
    key = jax.random.key(jjob.seed)
    k_init, k_steps = jax.random.split(key)
    chain_keys = jax.random.split(k_steps, k) if k > 1 else k_steps[None]
    states = []

    def hook(ev):
        states.append(ev.state)
        return False

    tr = japi.sample(alg, key, steps, num_chains=k, chunk_size=1,
                     collectors={"trace": JC.FullTrace()}, on_chunk=hook)
    if k > 1:
        init = jax.jit(alg.batched_init())(
            jax.random.split(k_init, k),
            jnp.broadcast_to(alg.default_position,
                             (k,) + alg.default_position.shape))
    else:
        init = jax.tree.map(lambda l: l[None],
                            jax.jit(alg.init)(k_init, alg.default_position))
    per_step = [init] + [s if k > 1 else jax.tree.map(lambda l: l[None], s)
                         for s in states[:-1]]
    signed = _jax_margin_fn(alg)
    margins = np.array([[float(signed(
        jax.tree.map(lambda l: l[c], st),
        jax.random.fold_in(chain_keys[c], i))) for i, st in enumerate(per_step)]
        for c in range(k)])
    out = {"theta": np.asarray(tr.results["trace"]["theta"]),
           "stats": jax.device_get(tr.results["trace"]["stats"]),
           "margins": margins,
           "theta0": np.asarray(jax.device_get(init.sampler.theta))}
    _JAX_SOLO[(jjob.job_id, steps)] = out
    return out


def _held_to_jax(theta, stats, ref, label):
    """The port's (K, S, ...) θ and StepStats against a JAX solo run."""
    m = ref["margins"]
    decided = _decisions(ref["theta"], ref["theta0"])
    # the margin formula must reproduce the reference's own decisions
    assert np.array_equal(m > 0, decided), label
    if not np.abs(m).min() >= MARGIN:
        pytest.fail(f"{label}: an accept test is within {np.abs(m).min():.3g}"
                    f" of its edge (< {MARGIN}); decisions cannot be compared"
                    " across the packages on this seed")
    got = theta.numpy()
    assert np.array_equal(_decisions(got, ref["theta0"]), decided), label
    scale = np.abs(ref["theta"]).max()
    np.testing.assert_allclose(got, ref["theta"], rtol=0,
                               atol=THETA_TOL * scale, err_msg=label)
    for name in ("n_bright", "lik_queries"):
        np.testing.assert_array_equal(
            getattr(stats, name).numpy(),
            np.asarray(getattr(ref["stats"], name)), err_msg=label)


@pytest.mark.parametrize("i", range(5))
def test_solo_port_run_matches_jax(i):
    """Each job of the mix on the plain engines (the reference Job's
    default), solo in both packages over the whole run."""
    jjob = JAX_MIX[i]
    ref = jax_solo(jjob)
    tr = solo(mix("plain")[i])["trace"]
    _held_to_jax(tr["theta"], tr["stats"], ref, jjob.job_id)


def test_packed_results_match_the_jax_service():
    """The port's packed JobResults against the JAX Service's on the mix:
    the same accept decisions, θ within 1e-5 of its largest value, equal
    bright counts and queries, R̂ within 1e-4 relative."""
    jsvc = JService(slot_budget=16, chunk_size=CHUNK)
    jjobs = JAX_MIX
    for j in jjobs:
        jsvc.submit(j)
    jres = jsvc.run(max_steps=MAX // CHUNK + 4)
    svc = Service(slot_budget=16, chunk_size=CHUNK, device="cpu")
    for j in mix("plain"):
        svc.submit(j)
    res = svc.run(max_steps=MAX // CHUNK + 4)
    for jjob in jjobs:
        ref = jax_solo(jjob)
        jr_ = jres[jjob.job_id].results
        # the JAX service is bitwise its own solo run
        np.testing.assert_array_equal(np.asarray(jr_["trace"]["theta"]),
                                      ref["theta"])
        r = res[jjob.job_id].results
        _held_to_jax(r["trace"]["theta"], r["trace"]["stats"],
                     dict(ref, theta=np.asarray(jr_["trace"]["theta"])),
                     jjob.job_id)
        np.testing.assert_allclose(r["rhat"]["r_hat"], jr_["rhat"]["r_hat"],
                                   rtol=1e-4)
