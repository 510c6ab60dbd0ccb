"""A check shared by the CPU tests and the card tests, free of JAX so that
``tests/test_torch_cuda.py`` can use it on a machine with only PyTorch."""

import torch

from repro_torch.core import bounds

BOUNDS = {
    "logistic": bounds.LogisticBound,
    "softmax": bounds.SoftmaxBound,
    "student_t": lambda: bounds.StudentTBound(nu=4.0, sigma=1.0),
}


def assert_bound_gradients_batch_invariant(family: str, d: int, device):
    """MALA's and HMC's batched == solo rests on autograd's gradient of the
    collapsed bound (a library sum over a broadcast axis) not changing with
    the chain count: one chain alone equals it beside 1, 2 or 7 others."""
    g = torch.Generator().manual_seed(d)
    n = 4 * d
    t = (torch.randint(0, 3, (n,), generator=g) if family == "softmax"
         else torch.randn(n, generator=g).sign())
    xi = (torch.randn(n, 3, generator=g) if family == "softmax"
          else torch.rand(n, generator=g) + 0.5)
    data = bounds.GLMData(torch.randn(n, d, generator=g).to(device),
                          t.to(device), xi.to(device))
    bound = BOUNDS[family]()
    stats = bound.suffstats(data)
    shape = (8, 3, d) if family == "softmax" else (8, d)
    theta = (0.3 * torch.randn(shape, generator=g)).to(device)

    def grad(th):
        th = th.clone().requires_grad_(True)
        (gr,) = torch.autograd.grad(bound.collapsed(th, stats).sum(), th)
        return gr

    solo = torch.cat([grad(theta[c:c + 1]) for c in range(8)])
    for k in (2, 3, 8):
        assert torch.equal(grad(theta[:k]), solo[:k])


def assert_softmax_collapsed_batch_invariant(kc: int, d: int, device):
    """The Böhning collapsed term at an LM head's shape (one 2-D matmul a
    chain): each chain's value and gradient alone equal them beside 1, 2 or
    4 others, bit for bit, with the statistics shared or each chain's own
    (the service's lane stacks)."""
    g = torch.Generator().manual_seed(kc + d)
    n = 2 * d
    x = torch.randn(n, d, generator=g)
    data = bounds.GLMData(x.to(device),
                          torch.randint(0, kc, (n,), generator=g).to(device),
                          (0.3 * torch.randn(n, kc, generator=g)).to(device))
    bound = bounds.SoftmaxBound()
    shared = bound.suffstats(data)
    own = bounds.CollapsedStats(*(a.expand((5,) + a.shape).clone()
                                  for a in shared))
    theta = (0.1 * torch.randn(5, kc, d, generator=g)).to(device)

    def value_and_grad(th, stats):
        th = th.clone().requires_grad_(True)
        v = bound.collapsed(th, stats)
        (gr,) = torch.autograd.grad(v.sum(), th)
        return v.detach(), gr

    solo = [value_and_grad(theta[c:c + 1], shared) for c in range(5)]
    want_v = torch.cat([v for v, _ in solo])
    want_g = torch.cat([gr for _, gr in solo])
    for k in (2, 3, 5):
        for stats in (shared, bounds.CollapsedStats(*(a[:k] for a in own))):
            v, gr = value_and_grad(theta[:k], stats)
            assert torch.equal(v, want_v[:k])
            assert torch.equal(gr, want_g[:k])
