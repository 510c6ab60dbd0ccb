"""Port parity: repro_torch.core.brightness against repro.core.brightness,
bitwise on shared inputs, with the port's chains batched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brightness as jb
from repro_torch.core import brightness as tb


def _flips(rng, js, n, c, s):
    """Darken mask over bright slots and dark candidates in arr order."""
    num = int(js.num)
    darken = rng.random(c) < 0.4
    dark = np.asarray(js.arr)[num:]
    m = min(len(dark), int(rng.integers(0, s + 1)))
    cand = np.full(s, n, np.int32)
    cand[:m] = dark[np.sort(rng.choice(len(dark), m, replace=False))]
    mask = np.zeros(s, bool)
    mask[:m] = rng.random(m) < 0.6
    return darken, cand, mask


@pytest.mark.parametrize("n,c,s", [(60, 16, 16), (200, 64, 32)])
def test_from_z_and_apply_flips_bitwise(n, c, s):
    rng = np.random.default_rng(n)
    for _ in range(20):
        # apply_flips' contract: the bright set fits the darken buffer.
        zs = [rng.permutation(n) < rng.integers(0, c + 1) for _ in range(2)]
        js = [jb.from_z(jnp.asarray(z)) for z in zs]
        ts = tb.from_z(torch.from_numpy(np.stack(zs)))
        for i, j in enumerate(js):
            np.testing.assert_array_equal(ts.arr[i].numpy(), np.asarray(j.arr))
            np.testing.assert_array_equal(ts.tab[i].numpy(), np.asarray(j.tab))
            assert int(ts.num[i]) == int(j.num)
        assert tb.check_invariants(ts)
        flips = [_flips(rng, j, n, c, s) for j in js]
        out = tb.apply_flips(
            ts, *(torch.from_numpy(np.stack([f[a] for f in flips])) for a in range(3))
        )
        assert tb.check_invariants(out)
        for i, (j, f) in enumerate(zip(js, flips)):
            ref = jb.apply_flips(j, *(jnp.asarray(a) for a in f))
            np.testing.assert_array_equal(out.arr[i].numpy(), np.asarray(ref.arr))
            np.testing.assert_array_equal(out.tab[i].numpy(), np.asarray(ref.tab))
            assert int(out.num[i]) == int(ref.num)
            z_ref = np.asarray(jb.z_of(ref))
            np.testing.assert_array_equal(tb.z_of(out)[i].numpy(), z_ref)


def test_bright_buffer_prefix_mask():
    z = torch.zeros(2, 10, dtype=torch.bool)
    z[0, [1, 4, 7]] = True
    st = tb.from_z(z)
    idx, mask = tb.bright_buffer(st, 4)
    assert idx[0, :3].tolist() == [1, 4, 7]
    assert mask.tolist() == [[True, True, True, False], [False] * 4]


def _assert_same(ts, i, js):
    np.testing.assert_array_equal(ts.arr[i].numpy(), np.asarray(js.arr))
    np.testing.assert_array_equal(ts.tab[i].numpy(), np.asarray(js.tab))
    assert int(ts.num[i]) == int(js.num)


@pytest.mark.parametrize("bright", [False, True])
def test_init_bitwise(bright):
    ts = tb.init(9, num_chains=3, bright=bright, device="cpu")
    for i in range(3):
        _assert_same(ts, i, jb.init(9, bright=bright))


def test_brighten_and_darken_swaps_bitwise():
    """Random O(1) swaps from random partitions, three chains at once, each
    move a no-op on some chains (already bright / already dark)."""
    n, k = 12, 3
    rng = np.random.default_rng(1)
    zs = [rng.random(n) < 0.4 for _ in range(k)]
    js = [jb.from_z(jnp.asarray(z)) for z in zs]
    ts = tb.from_z(torch.from_numpy(np.stack(zs)))
    for _ in range(60):
        datum = rng.integers(0, n, size=k)
        up = bool(rng.random() < 0.5)
        move_t, move_j = (tb.brighten, jb.brighten) if up else (tb.darken,
                                                                jb.darken)
        ts = move_t(ts, torch.from_numpy(datum))
        js = [move_j(j, jnp.int32(d)) for j, d in zip(js, datum)]
        assert tb.check_invariants(ts)
        for i, j in enumerate(js):
            _assert_same(ts, i, j)
    for z_all in (np.zeros(n, bool), np.ones(n, bool)):  # the edges
        t_edge = tb.from_z(torch.from_numpy(np.stack([z_all] * k)))
        for move_t in (tb.brighten, tb.darken):
            out = move_t(t_edge, torch.arange(k))
            assert tb.check_invariants(out)


def test_batch_update_is_from_z():
    rng = np.random.default_rng(2)
    z = rng.random((2, 30)) < 0.3
    ts = tb.batch_update(tb.init(30, 2, device="cpu"), torch.from_numpy(z))
    for i in range(2):
        _assert_same(ts, i, jb.batch_update(jb.init(30), jnp.asarray(z[i])))


@pytest.mark.parametrize("capacity", [1, 5, 20, 33])  # 33 > N: padded
def test_dark_buffer_bitwise(capacity):
    n = 20
    rng = np.random.default_rng(capacity)
    zs = [rng.random(n) < p for p in (0.0, 0.3, 0.9, 1.0)]
    ts = tb.from_z(torch.from_numpy(np.stack(zs)))
    idx, mask = tb.dark_buffer(ts, capacity)
    for i, z in enumerate(zs):
        j_idx, j_mask = jb.dark_buffer(jb.from_z(jnp.asarray(z)), capacity)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(j_mask))
