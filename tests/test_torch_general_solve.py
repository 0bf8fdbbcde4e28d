"""The general-operator path end to end: a seeded TFIM sampler solve of the
port against the JAX package's, with the slice's settings scaled down
(6 qubits, population 6, 2 generations; five-point NFT, 512 shots,
tournament selection of size 2, ``pack_min_layers`` 4).

(1) The port alone against the JAX package alone: the genome structure of
generation 1 is identical and its population energies agree to
1e-5 * sum|c| (equal grouped shots from equal keys), and the final
distribution's counts sum to the shots.  Later generations are not
required to match: a boundary draw inside an NFT step may steer them apart.

(2) The host call order over every generation: the port's driver and
operators replayed with the JAX package's sampler evaluator and optimizer
doing the numbers give the JAX solver's structures and energies exactly.

(3) What the driver builds: an exact-estimator solve of a general operator
runs its parameter search through the per-slot loop (the fused slot search
refuses it, as the JAX package's does) and matches the JAX solve in
generation 1, an estimator with ``precision > 0`` solves through the
grouped sampler, and the sampler's ``shot_allocation`` reaches the main and
the aux evaluators.
"""

from __future__ import annotations

import numpy as np

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.problems.spin_chains import transverse_field_ising as jax_tfim
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import ConfiguredSampler as JaxConfiguredSampler
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    ConfiguredSampler,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.solver import driver
from tests.test_torch_solver import SETTINGS, _structures

N = 6
TFIM = dict(coupling=1.0, field=0.9)
GENERAL = {
    **{k: v for k, v in SETTINGS.items() if k != "configured_sampler"},
    "configured_estimator": None, "use_tournament_selection": True, "tournament_size": 2,
}
NFT = dict(maxiter=4, reset_interval=3, five_point=True)


def _port_solver(optimizer, sampler=None, **overrides):
    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_sampler=sampler or ConfiguredSampler(shots=512, seed=0),
        optimizer=optimizer, device="cpu", **{**GENERAL, **overrides},
    ))


def _jax_solver(optimizer):
    return JaxSolver(JaxConfig(
        configured_sampler=JaxConfiguredSampler(shots=512, seed=0), optimizer=optimizer,
        use_pallas=True, **GENERAL,
    ))


class JaxSamplerNumbers(JaxSampler):
    """The JAX package's sampler evaluator with the two members the port's
    driver reads."""

    device = "cpu"

    def initial_states(self, pop):
        return None


def _shots_sum(result, shots=512):
    counts = np.array(list(result.eigenstate.values())) * shots
    np.testing.assert_allclose(counts, np.round(counts), atol=1e-6)
    return round(counts.sum())


def test_tfim_sampler_solve_matches_jax_in_generation_one():
    op, op_ref = transverse_field_ising(N, **TFIM), jax_tfim(N, **TFIM)
    ours = _port_solver(BatchedNFT(NFTConfig(**NFT))).compute_minimum_eigenvalue(op)
    ref = _jax_solver(JaxNFT(JaxNFTConfig(cache_prefix=True, **NFT))).compute_minimum_eigenvalue(op_ref)
    assert ours.generations == ref.generations == 2
    assert _structures(ours)[0] == _structures(ref)[0]
    np.testing.assert_allclose(
        ours.population_evaluation_results[0].expectation_values,
        ref.population_evaluation_results[0].expectation_values,
        atol=1e-5 * float(np.abs(op_ref.coeffs).sum()), rtol=0,
    )
    assert ours.eigenvalue < 0 and ref.eigenvalue < 0
    assert _shots_sum(ours) == _shots_sum(ref) == 512


def test_host_call_order_with_the_jax_numerics():
    """Every generation's structures and energies of the JAX solver, from
    the port's driver and operators with the JAX numerics."""
    op_ref = jax_tfim(N, **TFIM)
    optimizer = JaxNFT(JaxNFTConfig(cache_prefix=True, **NFT))
    ref = _jax_solver(optimizer).compute_minimum_eigenvalue(op_ref)
    replay = _port_solver(optimizer)._solve_by_evolution(
        JaxSamplerNumbers(op_ref, shots=512, seed=0), None)
    assert _structures(replay) == _structures(ref)
    assert replay.circuit_evaluations == ref.circuit_evaluations
    for got, want in zip(replay.population_evaluation_results, ref.population_evaluation_results):
        np.testing.assert_array_equal(got.expectation_values, want.expectation_values)
    assert replay.eigenvalue == ref.eigenvalue


def test_exact_estimator_solve_of_a_general_operator_is_refused(monkeypatch):
    """The fused slot search refuses this solve (``minimize_slots`` returns
    None for a general operator's exact objective), so its parameter search
    runs the per-slot loop; generation 1 matches the JAX solve, which takes
    the same loop, to 1e-5 * sum|c|."""
    op, op_ref = transverse_field_ising(N, **TFIM), jax_tfim(N, **TFIM)
    fused_results = []
    fused = BatchedNFT.minimize_slots

    def spy(self, *args, **kwargs):
        fused_results.append(fused(self, *args, **kwargs))
        return fused_results[-1]

    monkeypatch.setattr(BatchedNFT, "minimize_slots", spy)
    ours = _port_solver(
        BatchedNFT(NFTConfig(**NFT)), configured_estimator=ConfiguredEstimator(),
        parameter_search_probability=1.0,
    ).compute_minimum_eigenvalue(op)
    ref = JaxSolver(JaxConfig(
        configured_sampler=JaxConfiguredSampler(shots=512, seed=0),
        optimizer=JaxNFT(JaxNFTConfig(**NFT)),
        **{**GENERAL, "configured_estimator": JaxEstimator(), "parameter_search_probability": 1.0},
    )).compute_minimum_eigenvalue(op_ref)
    assert fused_results and all(result is None for result in fused_results)
    assert ours.generations == ref.generations == 2
    assert _structures(ours)[0] == _structures(ref)[0]
    assert ours.circuit_evaluations[0] == ref.circuit_evaluations[0]
    np.testing.assert_allclose(
        ours.population_evaluation_results[0].expectation_values,
        ref.population_evaluation_results[0].expectation_values,
        atol=1e-5 * float(np.abs(op_ref.coeffs).sum()), rtol=0,
    )
    assert ours.eigenvalue < 0 and _shots_sum(ours) == 512


def test_estimator_with_precision_solves_through_grouped_sampling():
    result = _port_solver(
        BatchedNFT(NFTConfig(**NFT)), configured_estimator=ConfiguredEstimator(precision=0.05),
    ).compute_minimum_eigenvalue(transverse_field_ising(N, **TFIM))
    assert result.generations == 2 and np.isfinite(result.eigenvalue) and result.eigenvalue < 0
    assert _shots_sum(result) == 512


def test_shot_allocation_reaches_the_main_and_aux_evaluators(monkeypatch):
    built = []

    class Recording(driver.SamplerExpectationEvaluator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(driver, "SamplerExpectationEvaluator", Recording)
    op = transverse_field_ising(N, **TFIM)
    sampler = ConfiguredSampler(shots=300, seed=2, shot_allocation="proportional")
    result = _port_solver(BatchedNFT(NFTConfig(maxiter=2, five_point=True)), sampler,
                          max_generations=1).compute_minimum_eigenvalue(op, aux_operators=[op])
    assert len(built) == 2
    for evaluator in built:
        assert evaluator.shot_allocation == "proportional"
        assert evaluator._group_shots is not None and sum(evaluator._group_shots) == 300
    assert len(result.aux_operators_evaluated) == 1
