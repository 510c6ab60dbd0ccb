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
