"""The port's folded last-layer NFT sweep (its launcher, running the plain
versions on the CPU) against the JAX package's
``nft_layer_sweep_folded_launch``, whose folded Pallas kernels run in
interpret mode, as tests/test_fold_sweep.py runs them.

Sweeps are compared through the JAX evaluator's energies at the returned
angles, not as raw angles (a flat coordinate makes the raw shift arbitrary
up to pi), at ``rtol=atol=1e-4`` as the JAX tests compare its routes; the
recycled energies must match the evaluator at the returned angles to the
same tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation
from queasars_tpu.optim.sweep_kernel_launch import nft_layer_sweep_folded_launch as jax_launch
from queasars_tpu.paulis import PauliSum
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator
from queasars_tpu_torch.interop import energy_table_from_numpy, genome_tensors_from_numpy
from queasars_tpu_torch.optim.sweep_kernel_launch import nft_layer_sweep_folded_launch


def _operator(n_qubits, seed=7):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(6):
        z = int(rng.integers(1, 1 << n_qubits))
        label = "".join("Z" if (z >> q) & 1 else "I" for q in range(n_qubits))[::-1]
        parts.append(PauliSum.from_label(label, float(rng.normal())))
    return PauliSum.sum(parts)


def test_folded_sweep_plain_matches_jax_through_the_evaluator():
    n, pop, maxiter, reset = 8, 4, 9, 4
    population = EVQEPopulation.random_population(n, 3, pop, True, random_seed=17)
    packed = PackedPopulation.pack(list(population.individuals))
    last = packed.layer_mask.sum(axis=1).astype(np.int32) - 1
    coords = np.zeros((pop, 3 * n, 2), np.int32)
    n_free = np.zeros(pop, np.int32)
    for i in range(pop):
        c = packed.layer_param_coordinates(i, -1)[:, 1:3]
        coords[i, : len(c)] = c
        n_free[i] = len(c)
    active = n_free > 0
    active[1] = False
    evaluator = StatevectorExpectationEvaluator(_operator(n, seed=3))
    table = np.array(evaluator._table)
    a_ref, e_ref = jax_launch(
        packed.gate_types, packed.controls, packed.angles, packed.layer_mask, last, coords,
        n_free, active, table, n_qubits=n, maxiter=maxiter, reset_interval=reset,
    )
    gt, ctrl, ang, mask = genome_tensors_from_numpy(
        packed.gate_types, packed.controls, packed.angles, packed.layer_mask
    )
    a_got, e_got = nft_layer_sweep_folded_launch(
        gt, ctrl, ang, mask, torch.from_numpy(last).long(), torch.from_numpy(coords),
        torch.from_numpy(n_free), torch.from_numpy(active), energy_table_from_numpy(table),
        n_qubits=n, maxiter=maxiter, reset_interval=reset,
    )

    def energies_at(layer_angles):
        merged = packed.angles.copy()
        merged[np.arange(pop), last] = np.asarray(layer_angles)
        return np.asarray(evaluator.evaluate_packed(packed, angles=merged))

    np.testing.assert_allclose(energies_at(a_got), energies_at(a_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(e_got.numpy(), energies_at(a_got), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(a_got[1].numpy(), packed.angles[1, last[1]])
