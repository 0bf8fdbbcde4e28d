"""The port's threefry functions (``utils/prng.py``) against ``jax.random``
of the installed jax, bit for bit: keys, folded keys, split keys and float32
uniforms, so the port draws the JAX package's shots from the same seeds."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu_torch.utils import prng

SEEDS = [0, 7, 2**31 - 1]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [1, 2, 0x5EED, 1000])
def test_fold_in_matches_jax(seed, data):
    got = prng.fold_in(prng.PRNGKey(seed), data)
    np.testing.assert_array_equal(got.numpy(), _words(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 3, 16])
def test_split_matches_jax(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    np.testing.assert_array_equal(got.numpy(), _words(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(512,), (300,), (1,), (3, 5)])
def test_uniform_matches_jax_bit_for_bit(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    got = prng.uniform(prng.fold_in(prng.PRNGKey(seed), 3), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_batched_keys_match_vmapped_jax():
    """Per-individual keys [P, 2] as the samplers use them: split, folded
    probe keys and uniforms row by row, as ``jax.vmap`` draws them."""
    keys_ref = jax.random.split(jax.random.PRNGKey(11), 6)
    probe_ref = jax.vmap(lambda k: jax.random.fold_in(jax.random.fold_in(k, 4), 2))(keys_ref)
    frac_ref = jax.vmap(lambda k: jax.random.uniform(k, (64,), jnp.float32))(probe_ref)
    keys = prng.split(prng.PRNGKey(11), 6)
    probe = prng.fold_in(prng.fold_in(keys, 4), 2)
    np.testing.assert_array_equal(probe.numpy(), _words(probe_ref))
    np.testing.assert_array_equal(prng.uniform(probe, (64,)).numpy(), np.asarray(frac_ref))


def test_seed_outside_the_key_range_is_refused():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
