"""Port parity: the counter-hash PRNG is bit-exact against cogview_tpu."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cogview_tpu.ops import hash_prng as jh
from cogview_tpu_torch.ops import hash_prng as th

torch.set_num_threads(1)

M32 = 2 ** 32
EDGE = np.array([0, 1, 2, 3, 255, 65535, 65536, 12345678, 2 ** 31 - 1, 2 ** 31,
                 2 ** 32 - 3, 2 ** 32 - 2, 2 ** 32 - 1], np.uint32)


def _grid():
    rng = np.random.RandomState(0)
    a = np.concatenate([EDGE, rng.randint(0, M32, 19, dtype=np.uint64).astype(np.uint32)])
    c0, c1, c2 = np.meshgrid(a, a[::-1], a[::3], indexing="ij")
    return c0.ravel(), c1.ravel(), c2.ravel()


def _t(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def test_fmix32_bit_exact():
    x = np.concatenate([EDGE, np.random.RandomState(1).randint(
        0, M32, 4000, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jh.fmix32(jnp.asarray(x)))
    got = th.fmix32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B1, 2 ** 32 - 1])
def test_hash_u32_and_uniform_bit_exact(seed):
    c0, c1, c2 = _grid()
    want = np.asarray(jh.hash_u32(jnp.uint32(seed), c0, c1, c2))
    got = th.hash_u32(seed, _t(c0), _t(c1), _t(c2)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    wu = np.asarray(jh.hash_uniform(jnp.uint32(seed), c0, c1, c2))
    gu = th.hash_uniform(seed, _t(c0), _t(c1), _t(c2)).numpy()
    assert gu.dtype == np.float32
    np.testing.assert_array_equal(gu.view(np.uint32), wu.view(np.uint32))
    assert (gu > 0).all() and (gu < 1).all()


def _fmix32_inverse(y: int) -> int:
    """Inverse of fmix32 on Python ints (xor-shifts and odd multipliers)."""
    y ^= y >> 16
    y = (y * pow(0x846CA68B, -1, M32)) % M32
    y ^= (y >> 15) ^ (y >> 30)
    y = (y * pow(0x7FEB352D, -1, M32)) % M32
    y ^= y >> 16
    return y


def test_hash_uniform_clamps_below_one():
    """A seed whose hash has all top 24 bits set: (2^24 - 1 + 0.5) * 2^-24
    rounds to 1.0 in float32, and both packages must clamp it."""
    seed = _fmix32_inverse(0xFFFFFFAB)
    assert int(th.hash_u32(seed, 0, 0, 0)) == 0xFFFFFFAB
    bits = np.float32(2 ** 24 - 1)
    assert (bits + np.float32(0.5)) * np.float32(2.0 ** -24) == np.float32(1.0)
    want = np.float32(jh.hash_uniform(jnp.uint32(seed), 0, 0, 0))
    got = th.hash_uniform(seed, 0, 0, 0).item()
    assert np.float32(got) == want == np.float32(1.0 - 2.0 ** -24)


def test_seed_from_key_data_matches_jax():
    from cogview_tpu.utils.rng import rbg_key
    import jax

    for s in (0, 3, 1234):
        key = rbg_key(s)
        words = np.asarray(jax.random.key_data(key)).reshape(-1)
        assert th.seed_from_key_data(words) == int(jh.seed_from_key(key))
