"""The LM stack's parallelism primitives against the reference's.

* :func:`repro_torch.distributed.par.resolve` (through
  :func:`repro_torch.models.transformer.build_specs`) places every weight
  of every arch's reduced config as :func:`repro.models.transformer.
  build_specs` does (tp_dim, fsdp_dim, fsdp_axes, sync, local shape,
  replicas), on meshes (data 2, model 4), (pod 2, data 2, model 2) with and
  without ``exclude_fsdp=("pod",)``, and the production (16, 16). The
  reference stacks a pattern slot's layers on a leading group dimension;
  the port's layer g·P + s is that leaf with the dimension dropped.
* :func:`repro_torch.launch.elastic.plan_mesh` plans the reference's
  shapes (``tests/test_distributed_training.py:217-221`` and the pod
  split from 32 groups).
* On 2 gloo ranks, ``compressed_pmean`` gives the reference's int8 codes
  and error state exactly and its g_hat to float32 rounding, round after
  round (the reference in a subprocess with 2 emulated devices).
* Each collective's gradient on 4 gloo ranks equals autograd's through the
  plain unsharded function: all_gather (its backward a reduce-scatter),
  reduce_scatter (an all-gather), psum (identity: the true gradient, not
  the reference's psum-transpose), pmax (none), and the vocab-parallel
  cross-entropy (``fused_ce_shard``) against ``fused_ce`` on the whole
  head, a label of the other block included.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_lm_ranks as ranks
from repro.configs import get_reduced as jax_reduced
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.distributed.launch import run_ranks
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.launch import elastic
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import layer_kinds

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "dp2_mp4": ({"data": 2, "model": 4}, ()),
    "pod2_dp2_mp2": ({"pod": 2, "data": 2, "model": 2}, ()),
    "pod2_dp2_mp2_podless": ({"pod": 2, "data": 2, "model": 2}, ("pod",)),
    "production": ({"data": 16, "model": 16}, ()),
}


def _same(port, ref, sizes, drop):
    """A port WSpec against a reference WSpec with ``drop`` leading
    (stacked group) dimensions."""
    less = lambda d: None if d is None else d - drop
    assert port.shape == tuple(ref.shape[drop:])
    assert port.tp_dim == less(ref.tp_dim)
    assert port.fsdp_dim == less(ref.fsdp_dim)
    assert port.fsdp_axes == tuple(ref.fsdp_axes)
    assert port.sync == tuple(ref.sync)
    assert port.local_shape == tuple(ref.local_shape(sizes, "model")[drop:])
    assert port.replicas == ref.replicas(sizes)


def _walk(port, ref, sizes, drop, where):
    if isinstance(port, dict):
        assert set(port) == set(ref), where
        for k in port:
            _walk(port[k], ref[k], sizes, drop, f"{where}.{k}")
    else:
        _same(port, ref, sizes, drop)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_matches_reference_build_specs(arch, mesh):
    sizes, exclude = MESHES[mesh]
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    got = T.build_specs(cfg, sizes, "model", exclude)
    want = JT.build_specs(jcfg, sizes, "model", exclude_fsdp=exclude)
    for k in ("embed", "final_norm"):
        _walk(got[k], want[k], sizes, 0, k)
    p = len(cfg.block_pattern)
    n_groups = cfg.n_layers // p
    kinds = layer_kinds(cfg)
    for i, blk in enumerate(got["blocks"]):
        if i < n_groups * p:
            ref, drop = want["blocks"][f"slot{i % p}"], 1
        else:
            ref, drop = want[f"extra{i - n_groups * p}"], 0
        ref = {("mix" if (kinds[i], k) == ("attn", "attn") else k): v
               for k, v in ref.items()}
        _walk(blk, ref, sizes, drop, f"layer {i}")
    if cfg.family == "encdec":
        _walk(got["enc_norm"], want["enc_norm"], sizes, 0, "enc_norm")
        enc = {("mix" if k == "attn" else k): v
               for k, v in want["enc_blocks"].items()}
        for i, blk in enumerate(got["enc_blocks"]):
            _walk(blk, enc, sizes, 1, f"encoder layer {i}")


@pytest.mark.parametrize("n,mp,axes,shape", [
    (8, 4, ("data", "model"), (2, 4)),  # the reference test's
    (7, 4, ("data", "model"), (1, 4)),  # lost a device: one group
    (256, 16, ("data", "model"), (16, 16)),
    (512, 16, ("pod", "data", "model"), (2, 16, 16)),
    (496, 16, ("data", "model"), (31, 16)),  # 31 groups: no pod split
])
def test_plan_mesh_shapes(n, mp, axes, shape):
    m = elastic.plan_mesh(n, model_parallel=mp)
    assert (m.axis_names, m.shape) == (axes, shape)
    assert m.size == np.prod(shape) and m.rank is None
    with pytest.raises(ValueError):
        elastic.plan_mesh(3, model_parallel=4)
    assert make_production_mesh(multi_pod=True).shape == (2, 16, 16)


_COMPRESS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as PS
    from repro.optim.compression import compressed_pmean
    g = np.load(sys.argv[1])["g"]  # (rounds, 2, n)
    mesh = jax.make_mesh((2,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    def body(g, e):
        gh, en = compressed_pmean(g[0], e[0], ("pod",))
        return gh[None], en[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(PS("pod"),) * 2,
                              out_specs=(PS("pod"),) * 2, check_vma=False))
    err = jnp.zeros(g.shape[1:], jnp.float32)
    out = {}
    for i, gi in enumerate(g):
        gh, err = f(jnp.asarray(gi), err)
        out["g_hat%d" % i], out["err%d" % i] = np.asarray(gh), np.asarray(err)
    np.savez(sys.argv[2], **out)
""")


def test_compressed_pmean_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((3, 2, 1000))
         * np.array([1e-3, 1.0, 50.0])[:, None, None]).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _COMPRESS, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, env=env,
                   timeout=300, cwd=ROOT)
    ref = dict(np.load(tmp_path / "out.npz"))
    got = run_ranks(ranks.compress_rounds, 2, backend="gloo", device="cpu",
                    args=(dict(g=g),))
    for r, rounds in enumerate(got):
        err_prev = np.zeros(g.shape[-1], np.float32)
        for i, (q, scale, g_hat, err) in enumerate(rounds):
            want_err = ref[f"err{i}"][r]
            np.testing.assert_array_equal(err, want_err)
            # the reference's code, from its error state: gf − err' is
            # q·scale to a rounding, far inside half a step
            gf = g[i, r] + err_prev
            want_q = np.rint((gf - want_err) / np.float32(scale))
            np.testing.assert_array_equal(q, want_q.astype(np.int8))
            assert np.abs(q).max() <= 127
            np.testing.assert_allclose(g_hat, ref[f"g_hat{i}"][r], rtol=1e-6,
                                       atol=1e-6 * np.abs(g[i]).max())
            err_prev = err


@pytest.fixture(scope="module")
def grads():
    rng = np.random.default_rng(7)
    job = dict(x=rng.standard_normal((8, 6)).astype(np.float32),
               c=rng.standard_normal((4, 8, 6)).astype(np.float32),
               rows=rng.standard_normal((16, 8)).astype(np.float32),
               w=rng.standard_normal((8, 32)).astype(np.float32),
               labels=rng.integers(0, 32, 16).astype(np.int64))
    return job, run_ranks(ranks.collective_grads, 4, backend="gloo",
                          device="cpu", args=(job,))


def test_all_gather_gradient_is_a_reduce_scatter(grads):
    job, out = grads
    x = torch.tensor(job["x"], requires_grad=True)
    sum((torch.as_tensor(c) * x).sum() for c in job["c"]).backward()
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["all_gather"], x.grad[2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)


def test_reduce_scatter_gradient_is_an_all_gather(grads):
    job, out = grads
    xs = [torch.tensor(job["x"] * (r + 1), requires_grad=True)
          for r in range(4)]
    total = sum(xs)
    sum((torch.as_tensor(job["c"][r, 2 * r:2 * r + 2])
         * total[2 * r:2 * r + 2]).sum() for r in range(4)).backward()
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["reduce_scatter"], xs[r].grad,
                                   rtol=1e-6, atol=1e-6)


def test_psum_gradient_is_the_true_one(grads):
    """Σ_r x_r squared: each x_r's gradient is 2·Σ x, not the reference's
    psum-transpose (4× that on 4 devices)."""
    job, out = grads
    vs = [torch.tensor(job["x"][r], requires_grad=True) for r in range(4)]
    (sum(vs) ** 2).sum().backward()
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["psum"], vs[r].grad, rtol=1e-6)


def test_pmax_has_no_gradient(grads):
    job, out = grads
    want = np.max([job["x"][r] * (r + 1) for r in range(4)], axis=0)
    for o in out:
        m, tracked = o["pmax"]
        np.testing.assert_array_equal(m, want)
        assert not tracked


def test_vocab_parallel_ce_matches_the_whole_head(grads):
    """Two vocabulary blocks over ``model``: every rank's NLL is the whole
    head's, the blocks' dx sum to its dx and each block's dw is its slice
    of dw (labels fall in both blocks)."""
    job, out = grads
    rows = torch.tensor(job["rows"], requires_grad=True)
    w = torch.tensor(job["w"], requires_grad=True)
    nll = ce_ops.fused_ce(rows, w, torch.as_tensor(job["labels"]), chunk=8)
    nll.sum().backward()
    assert (job["labels"] < 16).any() and (job["labels"] >= 16).any()
    for r, o in enumerate(out):
        got_nll, _, dw = o["ce"]
        np.testing.assert_allclose(got_nll, nll.detach(), rtol=1e-6)
        i = r % 2  # its model index
        np.testing.assert_allclose(dw, w.grad[:, 16 * i:16 * (i + 1)],
                                   rtol=1e-5, atol=1e-6)
    dx = out[0]["ce"][1] + out[1]["ce"][1]
    np.testing.assert_allclose(dx, rows.grad, rtol=1e-5, atol=1e-6)
