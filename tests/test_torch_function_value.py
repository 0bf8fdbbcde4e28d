"""The port's black-box bitstring objective (``BitstringFunctionEvaluator``)
and ``compute_minimum_function_value`` against the JAX package's (n=8, CPU).

Both packages draw each round's shots from equal threefry keys,
``split(fold_in(PRNGKey(seed), c), P)``, and add their running sums in one
order, so they draw the same shots from equal probabilities.  The two
statevector engines round differently (probabilities differ by up to
~1e-7), so a draw within that distance of a bin boundary may land in the
neighbouring bin: at least 99.5% of draws must be equal and every other one
a boundary draw, as ``tests/test_torch_sampler_evaluator.py`` measures
them.  Where an individual's draws all agree, its counts are equal and its
value equals the JAX package's to float64 rounding (1e-12 * max|f|: the
port sums over the observed states only); a flipped draw may move it by at
most 2 * max|f| / (alpha * shots).  The objective runs once per distinct
observed state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.sim.evaluators import BitstringFunctionEvaluator as JaxEvaluator
from queasars_tpu.sim.sampling import sample_indices as jax_sample_indices
from queasars_tpu.sim.statevector import probabilities as jax_probabilities
from queasars_tpu.solver import ConfiguredSampler as JaxConfiguredSampler
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu.utils.bitstring_evaluation import BitstringEvaluator as JaxBitstringEvaluator
from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.sim.evaluators import BitstringFunctionEvaluator, observed_frequencies
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.solver import (
    ConfiguredSampler,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.utils import BitstringEvaluator, prng
from tests.test_torch_solver import SETTINGS, _structures

N_QUBITS = 8
SHOTS = 128
SEED = 4
#: a seeded objective over the 2^8 bitstrings, most significant qubit first
VALUES = np.random.default_rng(11).normal(size=1 << N_QUBITS) * 3.0


class CountingFunction:
    """f(bitstring) = VALUES[int(bitstring, 2)], counting its calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, bitstring):
        self.calls.append(bitstring)
        return float(VALUES[int(bitstring, 2)])


def _population(pkg_population, pkg_packed):
    population = pkg_population.random_population(N_QUBITS, 3, 6, True, random_seed=2)
    return pkg_packed.pack(list(population.individuals))


def _round_draws(packed, jax_packed, call):
    """Port and JAX draws [P, SHOTS] of evaluation round ``call`` and the
    share of equal draws (every other draw must be a boundary draw)."""
    import chip_smoke
    from queasars_tpu_torch.sim.evaluators import packed_tensors
    from queasars_tpu_torch.sim.statevector import probabilities

    keys = prng.split(prng.fold_in(prng.PRNGKey(SEED), call), packed.n_individuals)
    ref_keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), call),
                                packed.n_individuals)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(ref_keys))
    q = jax_packed
    ref_probs = np.asarray(jax_probabilities(q.gate_types, q.controls, q.angles, q.layer_mask,
                                             q.n_qubits))
    ref_idx = np.stack([np.asarray(jax_sample_indices(k, jnp.asarray(pr), SHOTS))
                        for k, pr in zip(ref_keys, ref_probs)])
    probs = probabilities(*packed_tensors(packed), N_QUBITS)
    idx = sample_indices(keys, probs, SHOTS)
    share, not_boundary = chip_smoke.draw_agreement(
        torch.tensor(ref_probs), prng.uniform(keys, (SHOTS,)), idx, torch.tensor(ref_idx))
    assert share >= 0.995 and not_boundary == 0, (share, not_boundary)
    return keys, probs, idx.numpy(), ref_idx


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_bitstring_evaluator_matches_jax_over_successive_calls(alpha):
    packed = _population(EVQEPopulation, PackedPopulation)
    jax_packed = _population(JaxPopulation, JaxPacked)
    function = CountingFunction()
    ours = BitstringFunctionEvaluator(BitstringEvaluator(N_QUBITS, function), SHOTS, alpha,
                                      seed=SEED, device="cpu")
    theirs = JaxEvaluator(JaxBitstringEvaluator(N_QUBITS, CountingFunction()), SHOTS, alpha,
                          seed=SEED)
    scale = float(np.abs(VALUES).max())
    seen = set()
    for call in (1, 2, 3):
        keys, probs, idx, ref_idx = _round_draws(packed, jax_packed, call)
        got = ours.evaluate_packed(packed)
        want = np.asarray(theirs.evaluate_packed(jax_packed))
        assert ours._counter == theirs._counter == call
        flips = (idx != ref_idx).sum(axis=1)
        allowed = 1e-12 * scale + flips * 2 * scale / (alpha * SHOTS)
        assert np.all(np.abs(got - want) <= allowed), (got - want, flips)
        # counts: equal wherever an individual's draws all agree
        observed, frequencies = observed_frequencies(keys, probs, SHOTS)
        dense = np.zeros((packed.n_individuals, 1 << N_QUBITS), np.float32)
        dense[:, observed.numpy()] = frequencies.numpy()
        ref_counts = np.stack([np.bincount(r, minlength=1 << N_QUBITS) for r in ref_idx])
        agree = flips == 0
        np.testing.assert_array_equal(
            dense[agree], ref_counts[agree].astype(np.float32) * np.float32(1.0 / SHOTS))
        seen |= set(idx.ravel().tolist())
    # the function ran once per distinct observed state, memoised across calls
    assert len(function.calls) == len(set(function.calls)) == len(seen)


def test_energies_recomputed_on_the_host_from_the_frequencies():
    """The evaluator's values are the float64 expectation and CVaR of the
    frequencies it reads back, computed the reference's way
    (expectation_calculation.py:14-32, state by state)."""
    packed = _population(EVQEPopulation, PackedPopulation)
    for alpha in (1.0, 0.5):
        evaluator = BitstringFunctionEvaluator(
            BitstringEvaluator(N_QUBITS, CountingFunction()), SHOTS, alpha, seed=SEED,
            device="cpu")
        probs = evaluator.probabilities(packed)
        keys = prng.split(prng.fold_in(prng.PRNGKey(SEED), 1), packed.n_individuals)
        got = evaluator.energies_from_probabilities(probs, keys)
        observed, frequencies = observed_frequencies(keys, probs, SHOTS)
        for p in range(packed.n_individuals):
            pairs = sorted(
                (float(VALUES[s]), float(w))
                for s, w in zip(observed.tolist(), frequencies[p].tolist()) if w > 0
            )
            remaining, total = alpha, 0.0
            for value, weight in pairs:
                take = min(weight, max(remaining, 0.0))
                total += take * value
                remaining -= weight
            assert abs(total / alpha - got[p]) <= 1e-12 * float(np.abs(VALUES).max())
        assert np.all(frequencies.sum(dim=1).numpy() == 1.0)


FUNCTION_SETTINGS = {
    **{k: v for k, v in SETTINGS.items() if k not in ("configured_sampler", "max_generations")},
    "configured_estimator": None, "distribution_alpha_tail": 0.5, "max_generations": 2,
    "use_tournament_selection": True, "tournament_size": 2,
}


def test_function_value_solve_matches_jax():
    ours = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_sampler=ConfiguredSampler(shots=SHOTS, seed=SEED),
        optimizer=BatchedNFT(NFTConfig(maxiter=3)), device="cpu", **FUNCTION_SETTINGS,
    )).compute_minimum_function_value(BitstringEvaluator(N_QUBITS, CountingFunction()))
    theirs = JaxSolver(JaxConfig(
        configured_sampler=JaxConfiguredSampler(shots=SHOTS, seed=SEED),
        optimizer=JaxNFT(JaxNFTConfig(maxiter=3)), **FUNCTION_SETTINGS,
    )).compute_minimum_function_value(JaxBitstringEvaluator(N_QUBITS, CountingFunction()))
    assert ours.generations == theirs.generations == 2
    assert _structures(ours) == _structures(theirs)
    assert ours.circuit_evaluations == theirs.circuit_evaluations
    scale = float(np.abs(VALUES).max())
    # a flipped boundary draw moves a value by at most 2 max|f| / (alpha shots)
    tol = 2 * scale / (0.5 * SHOTS)
    for got, want in zip(ours.population_evaluation_results, theirs.population_evaluation_results):
        np.testing.assert_allclose(got.expectation_values, want.expectation_values, atol=tol)
    assert abs(ours.eigenvalue - theirs.eigenvalue) <= tol
    assert sum(ours.eigenstate.values()) == pytest.approx(1.0)
    assert all(abs(w * SHOTS - round(w * SHOTS)) < 1e-6 for w in ours.eigenstate.values())
