"""Plain versions of the port's slot kernels against the JAX package's Pallas
kernels, run in interpret mode on the CPU as tests/test_pallas_kernels.py
runs them.

Tolerances: probabilities and state amplitudes to 1e-5 absolute, energies
to 1e-5 * max|table| (the gate bench.py applies on the TPU).  Inputs are
made from numpy seeds and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation
from queasars_tpu.sim.pallas_kernels import (
    pallas_energies_exact,
    pallas_population_probs,
    pallas_population_states,
)
from queasars_tpu_torch.interop import energy_table_from_numpy, genome_tensors_from_numpy
from queasars_tpu_torch.sim import slot_kernels as sk


def _genomes(n_qubits, layers, pop, seed, min_layers=None):
    """Seeded genomes with one padded layer masked off and CU3 slots."""
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=min_layers)
    mask = packed.layer_mask.copy()
    mask[0, -1] = False
    assert (packed.gate_types == 3).any()
    return packed.gate_types, packed.controls, packed.angles, mask


def _random_states(pop, n_qubits, seed):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(pop, 2, 1 << n_qubits)).astype(np.float32)
    return states / np.sqrt((states**2).sum(axis=(1, 2), keepdims=True))


def test_population_states_plain_matches_pallas():
    n = 8
    genome = _genomes(n, 3, 4, seed=2)
    want = np.asarray(pallas_population_states(*genome, n, interpret=True))
    got = sk.population_states(*genome_tensors_from_numpy(*genome), n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_population_probs_plain_matches_pallas_from_initial_states():
    n = 7
    genome = _genomes(n, 2, 4, seed=5)
    initial = _random_states(4, n, seed=5)
    want = np.asarray(
        pallas_population_probs(*genome, n, interpret=True, initial=jnp.asarray(initial))
    )
    got = sk.population_probs(*genome_tensors_from_numpy(*genome), n, torch.from_numpy(initial))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n_qubits,with_initial", [(8, False), (10, True)])
def test_energies_exact_plain_matches_pallas(n_qubits, with_initial):
    """n=8 takes the Pallas probs fallback, n=10 its in-kernel contraction."""
    genome = _genomes(n_qubits, 3, 5, seed=n_qubits, min_layers=4)
    rng = np.random.default_rng(n_qubits)
    table = (rng.normal(size=1 << n_qubits) * 50.0).astype(np.float32)
    initial = _random_states(5, n_qubits, seed=1) if with_initial else None
    want = np.asarray(
        pallas_energies_exact(
            *genome, jnp.asarray(table), n_qubits, interpret=True,
            initial=None if initial is None else jnp.asarray(initial),
        )
    )
    got = sk.energies_exact(
        *genome_tensors_from_numpy(*genome), energy_table_from_numpy(table), n_qubits,
        None if initial is None else torch.from_numpy(initial),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(table).max())


def test_cpu_tensors_take_the_plain_versions_without_counting_launches():
    n = 7
    genome = genome_tensors_from_numpy(*_genomes(n, 2, 3, seed=9))
    table = torch.linspace(-1.0, 1.0, 1 << n)
    sk.reset_launch_counts()
    states = sk.population_states(*genome, n)
    torch.testing.assert_close(
        sk.energies_exact(*genome, table, n),
        ((states[:, 0] ** 2 + states[:, 1] ** 2) * table).sum(-1),
    )
    torch.testing.assert_close(
        sk.population_probs(*genome, n), states[:, 0] ** 2 + states[:, 1] ** 2
    )
    assert all(count == 0 for count in sk.launch_counts.values())


def test_tensors_off_cpu_and_cuda_are_refused():
    n = 7
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*_genomes(n, 2, 3, seed=9))
    with pytest.raises(ValueError, match="CUDA device"):
        sk.population_states(gt, ctrl, ang.to("meta"), mask, n)
