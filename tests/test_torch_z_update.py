"""Port parity: repro_torch.kernels.z_update against the JAX kernel and its
reference, bitwise — candidates and counts, including overflow (count >
capacity), num = 0 and a small q_db. The CUDA kernel is held against the
plain version on the card (``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.z_update.ops import z_candidates as jax_z_candidates
from repro.kernels.z_update.ref import q_threshold_bits as jax_q_bits
from repro.kernels.z_update.ref import z_candidates_ref as jax_z_ref
from repro_torch.kernels.z_update import ops as tops
from repro_torch.kernels.z_update.ref import q_threshold_bits


def _case(n, k, num_frac, seed):
    rng = np.random.default_rng(seed)
    arr = np.stack([rng.permutation(n) for _ in range(k)]).astype(np.int32)
    num = (np.array([num_frac] * k) * n).astype(np.int64)
    num[-1] = 0 if k > 1 else num[-1]
    kw = rng.integers(-(2**31), 2**31, (k, 2), dtype=np.int64).astype(np.int32)
    return arr, num, kw


def _torch(arr, num, kw):
    return (torch.from_numpy(arr), torch.from_numpy(num),
            torch.from_numpy(kw.astype(np.int64) & 0xFFFFFFFF))


@pytest.mark.parametrize(
    "n,k,num_frac,q_db,cap",
    [
        (1500, 2, 0.1, 0.05, 128),  # normal
        (1500, 2, 0.0, 0.05, 16),  # overflow: count > cap, and num = 0
        (777, 1, 0.3, 1e-9, 8),  # tiny q_db: threshold 1, rarely a candidate
        (2000, 2, 0.5, 0.5, 1200),  # dense selection
    ],
)
def test_candidates_bitwise_vs_jax_kernel_and_ref(n, k, num_frac, q_db, cap):
    arr, num, kw = _case(n, k, num_frac, seed=n + cap)
    cand, count = tops.z_candidates(*_torch(arr, num, kw), q_db, cap)
    assert cand.shape == (k, cap) and cand.dtype == torch.int32
    for i in range(k):
        c_k, n_k = jax_z_candidates(jnp.asarray(arr[i]), jnp.int32(num[i]),
                                    jnp.asarray(kw[i]), q_db, cap, interpret=True)
        c_r, n_r = jax_z_ref(jnp.asarray(arr[i]), jnp.int32(num[i]),
                             jnp.asarray(kw[i]), q_db, cap)
        np.testing.assert_array_equal(cand[i].numpy(), np.asarray(c_k))
        np.testing.assert_array_equal(cand[i].numpy(), np.asarray(c_r))
        assert int(count[i]) == int(n_k) == int(n_r)
    if cap == 16:
        assert (count > cap).all()


def test_q_threshold_matches_reference():
    for q in (0.0, 1e-12, 1e-7, 0.01, 0.5, 1.0, 2.0):
        assert q_threshold_bits(q) == jax_q_bits(q)


def test_chain_batched_equals_per_chain():
    arr, num, kw = _case(1200, 3, 0.2, seed=9)
    ta, tn, tk = _torch(arr, num, kw)
    cand, count = tops.z_candidates(ta, tn, tk, 0.03, 64)
    for i in range(3):
        c1, n1 = tops.z_candidates(ta[i:i + 1], tn[i:i + 1], tk[i:i + 1], 0.03, 64)
        assert torch.equal(c1[0], cand[i]) and int(n1[0]) == int(count[i])


# Each bad operand, and what the refusal must name.
_FAULTS = {"arr_dtype": "arr", "arr_rank": "arr", "arr_stride": "arr",
           "num_dtype": "num", "num_shape": "num", "kw_shape": "key_words",
           "kw_dtype": "key_words", "kw_strided": "key_words",
           "capacity": "capacity", "empty": "empty"}


@pytest.mark.parametrize("fault", _FAULTS)
def test_kernel_path_refuses_bad_operands_before_launch(fault):
    """The card path's checks, run on CPU tensors (which pass its device
    checks), refuse each bad operand with a ValueError before the library is
    built or the look-back workspace is touched, naming the operand."""
    arr, num, kw = _torch(*_case(300, 2, 0.1, seed=4))
    cap = 16
    if fault == "arr_dtype":
        arr = arr.long()
    elif fault == "arr_rank":
        arr = arr[0]
    elif fault == "arr_stride":
        arr = arr.t().contiguous().t()
    elif fault == "num_dtype":
        num = num.int()
    elif fault == "num_shape":
        num = num[:1]
    elif fault == "kw_shape":
        kw = torch.cat([kw, kw[:, :1]], 1)
    elif fault == "kw_dtype":
        kw = kw.int()
    elif fault == "kw_strided":
        kw = kw.t().contiguous().t()
    elif fault == "capacity":
        cap = 0
    elif fault == "empty":
        arr, num, kw = arr[:0], num[:0], kw[:0]
    before = dict(tops._workspaces)
    with pytest.raises(ValueError, match=rf"^z_candidates: {_FAULTS[fault]} "):
        tops._launch(arr, num, kw, 0.05, cap)
    assert tops._workspaces == before
