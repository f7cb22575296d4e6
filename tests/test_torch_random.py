"""The port's threefry random numbers (xgboost_tpu_torch/utils/random.py)
against jax.random: the Threefry-2x32 hash on Random123's known answers and
on JAX's own, and bits, uniform and bernoulli draws bitwise for several
keys and odd lengths, in the counter layout of
jax_threefry_partitionable=True, which the test reads from JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import prng as jax_prng

from xgboost_tpu_torch.utils import random as R

SEEDS = [0, 1, 42, 7919, 123456789, 2**31 - 1]
LENGTHS = [1, 3, 1023, 1024, 2049]


def test_counter_layout_is_partitionable():
    """The port hashes the iota of the shape, the layout JAX uses when
    jax_threefry_partitionable is on (its default from 0.5)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    y0, y1 = R.threefry2x32(key, torch.tensor([ctr[0]]),
                            torch.tensor([ctr[1]]))
    assert (int(y0), int(y1)) == want
    j = jax_prng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                               jnp.asarray(ctr, jnp.uint32))
    assert tuple(int(v) for v in np.asarray(j)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_prngkey(seed):
    assert R.prng_key(seed) == tuple(
        int(v) for v in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_match_jax(seed, n):
    key, jkey = R.prng_key(seed), jax.random.PRNGKey(seed)
    bits = R.random_bits(key, n).numpy().astype(np.uint32)
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(jkey,
                                                                   (n,))))
    u = R.uniform(key, n).numpy()
    ju = np.asarray(jax.random.uniform(jkey, (n,)))
    np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
    for p in (0.1, 0.5, 0.8, 0.999):
        np.testing.assert_array_equal(
            R.bernoulli(key, p, n).numpy(),
            np.asarray(jax.random.bernoulli(jkey, p, (n,))))
