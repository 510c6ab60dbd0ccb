"""Port parity for the pseudo-marginal special case (paper §5): the joint
(θ, z) MH update with z ~ Bernoulli(½), chain-batched.

One step against ``repro.core.pseudo_marginal``; the joint density summed
over every z is the full-data posterior; and the chain's θ-marginal is the
full-data posterior, computed on a grid.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import pseudo_marginal as jpm
from repro.data import logistic_data as jax_logistic_data
from repro.models.bayes_glm import GLMModel as JGLMModel
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.core import pseudo_marginal as pm
from repro_torch.data import logistic_data
from repro_torch.models.bayes_glm import GLMModel

CPU = "cpu"


def test_init_and_step_match_jax_per_chain():
    n, d = 40, 3
    jmodel = JGLMModel.logistic(jax_logistic_data(jax.random.key(0), n=n, d=d),
                                prior_scale=1.0, xi=1.5)
    args = (jmodel.bound, jmodel.log_prior, jmodel.data, jmodel.stats)
    dn = jax.device_get(jmodel.data)
    model = GLMModel.logistic(convert.glm_data(dn.x, dn.t, dn.xi, CPU),
                              prior_scale=1.0, xi=1.5, device=CPU)
    targs = (model.bound, model.log_prior, model.data, model.stats)
    seeds = (1, 2, 3, 4)
    th0 = np.random.default_rng(0).normal(size=(len(seeds), d)) * 0.1
    th0 = th0.astype(np.float32)
    jstates = [jpm.init(*args, jnp.asarray(th0[c]), jax.random.key(s))
               for c, s in enumerate(seeds)]
    words = np.stack([np.asarray(jax.random.key_data(jax.random.key(s)))
                      for s in seeds])
    state = pm.init(*targs, torch.from_numpy(th0),
                    convert.key_words(words, CPU, batched=True))
    for c, js in enumerate(jstates):
        np.testing.assert_array_equal(state.z[c].numpy(), js.z)
        np.testing.assert_allclose(float(state.lp[c]), float(js.lp), rtol=1e-5)
        np.testing.assert_array_equal(state.rng[c].numpy(),
                                      np.asarray(jax.random.key_data(js.rng)))
    step = jax.jit(lambda s: jpm.step(*args, s, 0.3))
    for _ in range(3):  # three steps, each from the reference's state
        new, acc = pm.step(*targs, state, 0.3)
        outs = [step(js) for js in jstates]
        for c, (js, (ref, ref_acc)) in enumerate(zip(jstates, outs)):
            k_theta, k_z, k_acc, _ = jax.random.split(js.rng, 4)
            th_p = js.theta + 0.3 * jax.random.normal(k_theta, js.theta.shape)
            z_p = jax.random.bernoulli(k_z, 0.5, js.z.shape)
            lp_p = jpm.joint_log_density(*args, th_p, z_p)
            log_u = jnp.log(jax.random.uniform(k_acc, ()))
            assert abs(float(log_u - (lp_p - js.lp))) > 1e-4  # not knife-edge
            assert bool(acc[c]) == bool(ref_acc)
            np.testing.assert_allclose(new.theta[c].numpy(), ref.theta,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(new.z[c].numpy(), ref.z)
            np.testing.assert_allclose(float(new.lp[c]), float(ref.lp),
                                       rtol=1e-5)
        jstates = [o[0] for o in outs]
        state = pm.PMState(
            torch.from_numpy(np.stack([np.asarray(s.theta) for s in jstates])),
            torch.from_numpy(np.stack([np.asarray(s.z) for s in jstates])),
            torch.from_numpy(np.stack([np.asarray(s.lp) for s in jstates])),
            convert.key_words(np.stack([np.asarray(jax.random.key_data(s.rng))
                                        for s in jstates]), CPU, batched=True),
        )


def test_joint_density_marginalizes_exactly():
    """Summed over all 2^N z (one chain each), the joint density is the
    full-data posterior up to a constant that does not depend on θ."""
    n, d = 6, 2
    data = logistic_data(jr.key(3, device=CPU), n=n, d=d, device=CPU)
    model = GLMModel.logistic(data, prior_scale=1.0, xi=1.0, device=CPU)
    zs = torch.tensor(list(itertools.product([False, True], repeat=n)))
    for seed in range(3):
        theta = jr.normal(jr.key(10 + seed, device=CPU), (d,))
        lps = pm.joint_log_density(model.bound, model.log_prior, model.data,
                                   model.stats, theta.expand(len(zs), d), zs)
        marginal = torch.logsumexp(lps.double(), 0).item()
        full = model.full_log_posterior(theta[None]).item()
        np.testing.assert_allclose(marginal, full, rtol=1e-4, atol=1e-3)


def test_chain_marginal_is_the_full_posterior():
    """512 chains batched: the pooled θ moments equal the full-data
    posterior's, computed on a grid. Tiny N, as in the reference's test:
    the estimator's variance grows with N and the chain sticks."""
    n, d, k, steps, burn = 8, 2, 512, 3000, 1000
    data = logistic_data(jr.key(0, device=CPU), n=n, d=d, separation=1.5,
                         device=CPU)
    model = GLMModel.logistic(data, prior_scale=2.0, xi=1.5, device=CPU)
    args = (model.bound, model.log_prior, model.data, model.stats)

    g = torch.linspace(-8.0, 8.0, 401, dtype=torch.float64)
    grid = torch.cartesian_prod(g, g).float()
    lp = model.full_log_posterior(grid).double()
    w = torch.softmax(lp, 0)
    mean = (w[:, None] * grid.double()).sum(0)
    std = torch.sqrt((w[:, None] * (grid.double() - mean) ** 2).sum(0))

    state = pm.init(*args, torch.zeros(k, d), jr.split(jr.key(2, device=CPU), k))
    out, acc = [], 0.0
    for i in range(steps):
        state, accepted = pm.step(*args, state, 0.6)
        if i >= burn:
            out.append(state.theta)
            acc += float(accepted.float().mean())
    th = torch.stack(out, 1).double()  # (K, T, D)
    assert acc / (steps - burn) > 0.005
    chain_means = th.mean(1)  # independent chains: their means are i.i.d.
    se = chain_means.std(0) / k**0.5
    pooled = chain_means.mean(0)
    assert bool(((pooled - mean).abs() < 4 * se).all()), (pooled, mean, se)
    np.testing.assert_allclose(th.reshape(-1, d).std(0).numpy(), std.numpy(),
                               rtol=0.1)
