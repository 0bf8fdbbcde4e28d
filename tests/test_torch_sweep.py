"""The port's plain last-layer NFT sweep against the JAX package's
``pallas_nft_layer_sweep`` run in interpret mode on the CPU.

Sweeps are compared through energies, not raw angles: angles are ambiguous
by pi on flat coordinates, and the Pallas kernel's polynomial atan2
(~2e-6 error) against torch.atan2 can flip a branch there.  Tolerance:
1e-5 * max|table| on final energies, re-evaluated through the JAX engine.
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation
from queasars_tpu.sim.pallas_kernels import pallas_nft_layer_sweep
from queasars_tpu.sim.statevector import probabilities, simulate_circuits
from queasars_tpu_torch.sim import slot_kernels as sk


def _sweep_problem(n_qubits=7, pop=5, layers=3, seed=4):
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals))
    last = packed.layer_mask.sum(axis=1).astype(np.int32) - 1
    rows = np.arange(pop)
    coords = np.zeros((pop, 3 * n_qubits, 2), np.int32)
    n_free = np.zeros(pop, np.int32)
    for i in range(pop):
        c = packed.layer_param_coordinates(i, -1)[:, 1:3]
        coords[i, : len(c)] = c
        n_free[i] = len(c)
    active = n_free > 0
    active[1] = False
    prefix_mask = packed.layer_mask & (np.arange(packed.max_layers)[None, :] < last[:, None])
    prefix = np.array(
        simulate_circuits(packed.gate_types, packed.controls, packed.angles, prefix_mask, n_qubits)
    )
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=1 << n_qubits) * 10.0).astype(np.float32)
    layer = (
        packed.gate_types[rows, last], packed.controls[rows, last], packed.angles[rows, last],
    )
    return packed, last, layer, coords, n_free, active, prefix, table


def _energies(packed, last, layer_angles, table):
    angles = packed.angles.copy()
    angles[np.arange(len(last)), last] = layer_angles
    probs = np.asarray(
        probabilities(packed.gate_types, packed.controls, angles, packed.layer_mask, packed.n_qubits)
    )
    return probs @ table


def test_nft_layer_sweep_plain_matches_pallas():
    packed, last, layer, coords, n_free, active, prefix, table = _sweep_problem()
    n, maxiter, reset = packed.n_qubits, 9, 4
    assert (layer[0] == 3).any(), "the swept layers should hold a CU3 slot"
    a_ref, z_ref = pallas_nft_layer_sweep(
        *layer, coords, n_free, active, jnp.asarray(prefix), jnp.asarray(table),
        n, maxiter, reset, interpret=True,
    )
    a_got, z_got = sk.nft_layer_sweep(
        torch.from_numpy(layer[0]), torch.from_numpy(layer[1]), torch.from_numpy(layer[2]),
        torch.from_numpy(coords), torch.from_numpy(n_free), torch.from_numpy(active),
        torch.from_numpy(prefix), torch.from_numpy(table), n, maxiter, reset,
    )
    tol = 1e-5 * np.abs(table).max()
    e_ref = _energies(packed, last, np.asarray(a_ref), table)
    e_got = _energies(packed, last, a_got.numpy(), table)
    np.testing.assert_allclose(e_got, e_ref, atol=tol)
    np.testing.assert_allclose(z_got.numpy(), np.asarray(z_ref), atol=tol)
    # the recycled z is the exact energy at the final angles (last layer)
    np.testing.assert_allclose(z_got.numpy(), e_got, atol=tol)
    # an inactive individual keeps its angles; the sweep lowered the rest
    np.testing.assert_array_equal(a_got[1].numpy(), layer[2][1])
    start = _energies(packed, last, layer[2], table)
    assert np.all(e_got[active] <= start[active] + tol)
