"""The port's CUDA kernels on the card: each against its plain version, and
the exactness contracts of a short chain run on the device.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one;
this file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch import random as jr
from repro_torch.data import logistic_data
from repro_torch.kernels.bright_glm import ops as bops
from repro_torch.kernels.bright_glm.ref import bright_glm_ref
from repro_torch.kernels.z_update import ops as zops
from repro_torch.kernels.z_update.ref import z_candidates_ref
from repro_torch.models.bayes_glm import GLMModel

pytestmark = pytest.mark.cuda
KW = {"logistic": {}, "student_t": {"nu": 4.0, "sigma": 1.5}, "softmax": {}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bright_inputs(family, n, d, k, c, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    if family == "softmax":
        t = torch.randint(0, 3, (n,), generator=g)
        xi = torch.randn(n, 3, generator=g)
        theta = 0.5 * torch.randn(k, 3, d, generator=g)
    else:
        t = (torch.randn(n, generator=g).sign() if family == "logistic"
             else 2 * torch.randn(n, generator=g))
        xi = t.abs() + 5.0 + torch.rand(n, generator=g)  # away from tightness
        theta = 0.5 * torch.randn(k, d, generator=g) / d**0.5
    arr = torch.stack([torch.randperm(n, generator=g) for _ in range(k)])
    arr = arr.to(torch.int32)
    nb = torch.randint(0, c, (k,), generator=g)
    return [a.to(dev) for a in (x, t, xi)] + [arr.to(dev), nb.to(dev),
                                              theta.to(dev)]


@pytest.mark.parametrize("family", ["logistic", "student_t", "softmax"])
@pytest.mark.parametrize("n,d,c", [(500, 7, 24), (3000, 51, 512)])
def test_bright_glm_kernel_matches_plain(dev, family, n, d, c):
    x, t, xi, arr, nb, theta = _bright_inputs(family, n, d, 2, c, dev)
    idx = arr[:, :c]  # a strided view, as the step passes it
    before = bops.launch_count
    delta, total = bops.bright_glm(x, t, xi, idx, nb, theta, family=family,
                                   **KW[family])
    torch.cuda.synchronize()
    assert bops.launch_count == before + 1
    d_ref, t_ref = bright_glm_ref(x, t, xi, idx, nb, theta, family=family,
                                  **KW[family])
    torch.testing.assert_close(delta, d_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, t_ref, rtol=1e-5, atol=1e-5)


def test_bright_glm_gradient_on_card(dev):
    x, t, xi, arr, nb, theta = _bright_inputs("logistic", 800, 9, 2, 64, dev)
    th = theta.clone().requires_grad_(True)
    _, total = bops.bright_glm(x, t, xi, arr[:, :64], nb, th)
    (g,) = torch.autograd.grad(total.sum(), th)
    cpu = [a.cpu() for a in (x, t, xi, arr[:, :64], nb, theta)]
    th_c = cpu[-1].clone().requires_grad_(True)
    _, total_c = bops.bright_glm(*cpu[:-1], th_c)
    (g_c,) = torch.autograd.grad(total_c.sum(), th_c)
    torch.testing.assert_close(g.cpu(), g_c, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,frac,q_db,cap", [
    (5000, 0.1, 0.05, 64), (70001, 0.0, 0.01, 4096), (2049, 0.5, 1e-9, 8),
])
def test_z_candidates_kernel_matches_plain_bitwise(dev, n, frac, q_db, cap):
    g = torch.Generator().manual_seed(n)
    arr = torch.stack([torch.randperm(n, generator=g) for _ in range(2)])
    arr = arr.to(torch.int32).to(dev)
    num = torch.tensor([int(frac * n), 0], device=dev)
    kw = torch.randint(0, 2**32, (2, 2), generator=g).to(dev)
    before = zops.launch_count
    cand, count = zops.z_candidates(arr, num, kw, q_db, cap)
    torch.cuda.synchronize()
    assert zops.launch_count == before + 1
    c_ref, n_ref = z_candidates_ref(arr, num, kw, q_db, cap)
    assert torch.equal(cand, c_ref) and torch.equal(count, n_ref)


def _run(model, cap, key, n_iter, **kw):
    alg = api.firefly(model, kernel="rwmh", capacity=cap, cand_capacity=cap,
                      q_db=0.02, step_size=0.05, adapt_target="auto",
                      num_warmup=20, device="cuda")
    return api.sample(alg, key, n_iter, device="cuda", **kw)


def test_chain_on_card_is_capacity_and_batching_invariant(dev):
    data = logistic_data(jr.key(0), n=3000, d=9)
    model = GLMModel.logistic(data)
    tuned = model.map_tuned(model.map_estimate(jr.key(1), steps=100))
    key = jr.key(7)
    b0, z0 = bops.launch_count, zops.launch_count
    big = _run(tuned, 512, key, 40, num_chains=2)
    assert bops.launch_count - b0 == 2 * big.steps_run + big.inits_run
    assert zops.launch_count - z0 == big.steps_run
    small = _run(tuned, 8, key, 40, num_chains=2, chunk_size=10)
    assert small.steps_run > 40
    assert torch.equal(big.theta, small.theta)
    k_init, k_steps = jr.split(key)
    init_keys, chain_keys = jr.split(k_init, 2), jr.split(k_steps, 2)
    alg = big.algorithm
    for c in range(2):
        st = alg.init(init_keys[c:c + 1], alg.default_position[None])
        one = api.sample(alg, chain_keys[c], 40, init_state=st, device="cuda")
        assert torch.equal(one.theta[0], big.theta[c])
    assert np.isfinite(big.theta.cpu().numpy()).all()
