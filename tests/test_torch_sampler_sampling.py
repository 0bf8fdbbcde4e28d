"""The port's flat sampler and shot CVaR (``sim/sampling.py``,
``sim/expectation.py``) against the JAX package's, with equal keys.

On dyadic probability vectors every running sum is exact in any order, so
the draws must be equal; on random vectors the two cumsums may round a
boundary differently, so at least 99.5% of draws must be equal (the JAX
package's own bar for two samplers of one stream).  Shot CVaR agrees to
1e-6 absolute (float32 sums of O(1) energies)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.sim import expectation as jax_expectation
from queasars_tpu.sim import sampling as jax_sampling
from queasars_tpu_torch.sim import expectation, sampling
from queasars_tpu_torch.utils import prng


def _dyadic(n_qubits, seed):
    """A probability vector of multiples of 2^-12 (exact partial sums)."""
    rng = np.random.default_rng(seed)
    weights = rng.integers(0, 4, size=1 << n_qubits).astype(np.float64)
    weights[rng.integers(0, 1 << n_qubits)] += 1
    scale = 2.0 ** -12
    units = np.floor(weights / weights.sum() / scale)
    units[np.argmax(units)] += 1 / scale - units.sum()
    return (units * scale).astype(np.float32)


def _random(n_qubits, seed):
    rng = np.random.default_rng(seed)
    p = rng.random(1 << n_qubits) ** 4
    return (p / p.sum()).astype(np.float32)


@pytest.mark.parametrize("n_qubits", [4, 8, 12])
@pytest.mark.parametrize("shots", [512, 300])
def test_sample_indices_exact_on_dyadic_probabilities(n_qubits, shots):
    probs = _dyadic(n_qubits, n_qubits + shots)
    assert probs.sum() == 1.0
    want = np.asarray(jax_sampling.sample_indices(jax.random.PRNGKey(shots), jnp.asarray(probs), shots))
    got = sampling.sample_indices(prng.PRNGKey(shots), torch.tensor(probs), shots)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_qubits", [6, 10, 12])
def test_sample_indices_on_random_probabilities(n_qubits):
    probs = _random(n_qubits, n_qubits)
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(4)]
    want = np.stack([np.asarray(jax_sampling.sample_indices(k, jnp.asarray(probs), 2048)) for k in keys])
    port_keys = torch.stack([prng.fold_in(prng.PRNGKey(3), i) for i in range(4)])
    got = sampling.sample_indices(port_keys, torch.tensor(probs).expand(4, -1), 2048)
    assert (got.numpy() == want).mean() >= 0.995


@pytest.mark.parametrize("n_qubits", [5, 9])
def test_counts_and_empirical_probs_match_jax(n_qubits):
    probs = _dyadic(n_qubits, 1)
    key, port_key = jax.random.PRNGKey(9), prng.PRNGKey(9)
    counts = sampling.sample_counts(port_key, torch.tensor(probs), 1000)
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jax_sampling.sample_counts(key, jnp.asarray(probs), 1000))
    )
    assert int(counts.sum()) == 1000
    np.testing.assert_array_equal(
        sampling.empirical_probs(port_key, torch.tensor(probs), 1000).numpy(),
        np.asarray(jax_sampling.empirical_probs(key, jnp.asarray(probs), 1000)),
    )


def test_quasi_distribution_matches_jax():
    probs = _dyadic(6, 2)
    assert sampling.quasi_distribution(probs) == jax_sampling.quasi_distribution(probs)


@pytest.mark.parametrize("alpha", [1.0, 0.5, 0.13])
@pytest.mark.parametrize("shots", [512, 300])
def test_cvar_from_shot_energies_matches_jax(alpha, shots):
    rng = np.random.default_rng(shots)
    energies = rng.normal(size=(5, shots)).astype(np.float32)
    want = np.asarray(
        jax_expectation.cvar_expectation_from_shot_energies(jnp.asarray(energies), jnp.float32(alpha))
    )
    got = expectation.cvar_expectation_from_shot_energies(torch.tensor(energies), alpha)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_shot_cvar_equals_counts_cvar():
    """The shot-multiset CVaR equals the exact-distribution CVaR over the
    counts of the same shots (1e-6: summation order only)."""
    rng = np.random.default_rng(4)
    table = torch.tensor(rng.normal(size=64).astype(np.float32))
    probs = torch.tensor(_random(6, 4))
    keys = prng.split(prng.PRNGKey(1), 3)
    idx = sampling.sample_indices(keys, probs.expand(3, -1), 512)
    counts = sampling.sample_counts(keys, probs.expand(3, -1), 512)
    order = torch.argsort(table, stable=True)
    np.testing.assert_allclose(
        expectation.cvar_expectation_from_shot_energies(table[idx], 0.5).numpy(),
        expectation.cvar_expectation_from_probs(counts.float() / 512, table[order], order, 0.5).numpy(),
        atol=1e-6, rtol=0,
    )
