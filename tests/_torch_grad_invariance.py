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
