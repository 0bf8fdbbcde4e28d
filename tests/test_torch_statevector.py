"""The port's plain statevector engine and expectations against the JAX
package's engine (no kernels involved).  Amplitudes and probabilities to
1e-5 absolute; CVaR energies to 1e-5 * max|table|."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation
from queasars_tpu.sim import statevector as jsv
from queasars_tpu.sim.expectation import cvar_expectation_from_probs as jax_cvar
from queasars_tpu_torch.interop import genome_tensors_from_numpy
from queasars_tpu_torch.sim import statevector as tsv
from queasars_tpu_torch.sim.expectation import cvar_expectation_from_probs


def _packed(n_qubits, seed, layers=3, pop=4):
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=layers + 1)
    packed.layer_mask[-1, 1] = False
    return packed


@pytest.mark.parametrize("n_qubits", [7, 9])
def test_simulate_circuits_matches_jax_engine(n_qubits):
    p = _packed(n_qubits, seed=n_qubits)
    genome = (p.gate_types, p.controls, p.angles, p.layer_mask)
    want = np.asarray(jsv.simulate_circuits(*genome, n_qubits))
    got = tsv.simulate_circuits(*genome_tensors_from_numpy(*genome), n_qubits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_shared_and_per_individual_initial_states_match_jax_engine():
    n = 7
    p = _packed(n, seed=3)
    genome = (p.gate_types, p.controls, p.angles, p.layer_mask)
    rng = np.random.default_rng(0)
    init = rng.normal(size=(4, 2, 1 << n)).astype(np.float32)
    init /= np.sqrt((init**2).sum(axis=(1, 2), keepdims=True))
    tensors = genome_tensors_from_numpy(*genome)
    for start in (init, init[0]):
        want = np.asarray(jsv.probabilities(*genome, n, jnp.asarray(start)))
        got = tsv.probabilities(*tensors, n, torch.from_numpy(start))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_apply_circuit_complex_form_matches_jax():
    n = 7
    p = _packed(n, seed=8, pop=1)
    genome = (p.gate_types[0], p.controls[0], p.angles[0], p.layer_mask[0])
    want = np.asarray(jsv.apply_circuit(*genome, n))
    got = tsv.apply_circuit(*genome_tensors_from_numpy(*genome), n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cvar_expectation_matches_jax():
    rng = np.random.default_rng(2)
    probs = rng.random(size=(3, 128)).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    table = (rng.normal(size=128) * 20).astype(np.float32)
    order = np.argsort(table, kind="stable").astype(np.int32)
    for alpha in (0.1, 0.5, 1.0):
        want = np.asarray(jax_cvar(probs, table[order], order, jnp.float32(alpha)))
        got = cvar_expectation_from_probs(
            torch.from_numpy(probs), torch.from_numpy(table[order]), torch.from_numpy(order).long(),
            alpha,
        )
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(table).max())
