"""The port's evaluator and batched NFT against the JAX package's, on the
same packed population and operator (n=7..8, CPU).

The port always runs the fused route (prefix cache, sweep kernel's plain
version, fused slots); the JAX package on the CPU runs its jnp scan for the
same math.  Results are compared as energies re-evaluated through the JAX
evaluator, to 1e-5 * max|table| (float rounding differs at the ulp level;
angles themselves are ambiguous by pi on flat coordinates).
"""

from __future__ import annotations

import numpy as np
import pytest

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.optim.nft import BatchedNFT as JaxNFT
from queasars_tpu.optim.nft import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu_torch.interop import packed_population_from_numpy
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator


def _operators(n_qubits, seed=7, terms=8):
    rng = np.random.default_rng(seed)
    labels, coeffs = [], []
    for _ in range(terms):
        z = int(rng.integers(1, 1 << n_qubits))
        labels.append("".join("Z" if (z >> q) & 1 else "I" for q in range(n_qubits))[::-1])
        coeffs.append(float(rng.normal()))
    ours = PauliSum.sum([PauliSum.from_label(l, c) for l, c in zip(labels, coeffs)])
    ref = JaxPauliSum.sum([JaxPauliSum.from_label(l, c) for l, c in zip(labels, coeffs)])
    return ours, ref


def _problem(n_qubits=7, pop=5, layers=3, seed=11):
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    q = JaxPacked.pack(list(population.individuals), min_layers=4)
    p = packed_population_from_numpy(
        q.gate_types, q.controls, q.angles, q.layer_mask, q.param_mask, q.n_params, q.n_qubits
    )
    return p, q


def _last_layer_coords(packed):
    coords_list = [packed.layer_param_coordinates(i, -1) for i in range(packed.n_individuals)]
    k_max = max(c.shape[0] for c in coords_list)
    coords = np.zeros((packed.n_individuals, k_max, 3), np.int32)
    n_free = np.zeros(packed.n_individuals, np.int32)
    for i, c in enumerate(coords_list):
        coords[i, : c.shape[0]] = c
        n_free[i] = c.shape[0]
    return coords, n_free


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_evaluator_matches_jax(alpha):
    op, op_ref = _operators(8)
    p, q = _problem(8)
    got = StatevectorExpectationEvaluator(op, alpha=alpha, device="cpu").evaluate_packed(p)
    want = JaxEvaluator(op_ref, alpha=alpha).evaluate_packed(q)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(op_ref.coeffs).sum())


@pytest.mark.parametrize("alpha", [1.0, 0.4])
def test_last_layer_search_matches_jax(alpha):
    """alpha=1 runs the sweep kernel's plain version, CVaR the prefix scan."""
    op, op_ref = _operators(7)
    p, q = _problem(7)
    coords, n_free = _last_layer_coords(p)
    active = n_free > 0
    active[2] = False
    last = p.layer_mask.sum(axis=1).astype(np.int32) - 1
    evaluator = StatevectorExpectationEvaluator(op, alpha=alpha, device="cpu")
    a, e, n_evals = BatchedNFT(NFTConfig(maxiter=9, reset_interval=4)).minimize(
        evaluator, p, coords, n_free, active, last_layer=last
    )
    ref = JaxEvaluator(op_ref, alpha=alpha)
    a_ref, e_ref, n_ref = JaxNFT(JaxNFTConfig(maxiter=9, reset_interval=4, cache_prefix=False)).minimize(
        ref, q, coords, n_free, active, last_layer=last
    )
    tol = 1e-5 * np.abs(op_ref.coeffs).sum()
    assert n_evals == n_ref
    np.testing.assert_allclose(
        ref.evaluate_packed(q, angles=a), ref.evaluate_packed(q, angles=a_ref), atol=tol
    )
    np.testing.assert_allclose(e, e_ref, atol=tol)
    np.testing.assert_array_equal(a[2], q.angles[2])
    for i in range(p.n_individuals):
        for layer in range(p.max_layers):
            if layer != last[i]:
                np.testing.assert_array_equal(a[i, layer], q.angles[i, layer])


def test_fused_slot_search_matches_jax():
    op, op_ref = _operators(7, seed=3)
    p, q = _problem(7, seed=5)
    pop, slots = p.n_individuals, 3
    real = p.layer_mask.sum(axis=1)
    k_max = 3 * p.n_qubits
    coords = np.zeros((pop, slots, k_max, 3), np.int32)
    n_free = np.zeros((pop, slots), np.int32)
    slot_layers = np.full((pop, slots), p.max_layers, np.int32)
    for i in range(pop):
        for s in range(min(slots, real[i])):
            layer = (s * 2 + i) % real[i]
            c = p.layer_param_coordinates(i, layer)
            coords[i, s, : len(c)] = c
            n_free[i, s] = len(c)
            slot_layers[i, s] = layer
    active = n_free > 0
    cfg = dict(maxiter=5, reset_interval=3)
    a, e, n = BatchedNFT(NFTConfig(**cfg)).minimize_slots(
        StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active, slot_layers
    )
    ref = JaxEvaluator(op_ref)
    a_ref, e_ref, n_ref = JaxNFT(JaxNFTConfig(cache_prefix=True, **cfg)).minimize_slots(
        ref, q, coords, n_free, active, slot_layers
    )
    tol = 1e-5 * np.abs(op_ref.coeffs).sum()
    assert n == n_ref
    np.testing.assert_allclose(
        ref.evaluate_packed(q, angles=a), ref.evaluate_packed(q, angles=a_ref), atol=tol
    )
    np.testing.assert_allclose(e, e_ref, atol=tol)


def test_full_circuit_search_without_prefix_matches_jax():
    op, op_ref = _operators(7, seed=9)
    p, q = _problem(7, seed=2)
    coords = np.stack([p.param_coordinates(i)[:6] for i in range(p.n_individuals)])
    n_free = np.full(p.n_individuals, 6, np.int32)
    active = np.ones(p.n_individuals, bool)
    a, e, _ = BatchedNFT(NFTConfig(maxiter=7)).minimize(
        StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active
    )
    ref = JaxEvaluator(op_ref)
    a_ref, e_ref, _ = JaxNFT(JaxNFTConfig(maxiter=7)).minimize(ref, q, coords, n_free, active)
    tol = 1e-5 * np.abs(op_ref.coeffs).sum()
    np.testing.assert_allclose(
        ref.evaluate_packed(q, angles=a), ref.evaluate_packed(q, angles=a_ref), atol=tol
    )
    np.testing.assert_allclose(e, e_ref, atol=tol)
