"""The port's MoG-VQE pieces against the JAX package's (CPU): NSGA-II
sorting, crowding distances and Pareto fronts on seeded objectives with
ties, the selection operator's draws, and a 3-qubit Heisenberg MoG-VQE
solve, replayed through the port's host modules with the JAX numerics
(every generation equal) and run on the port's numerics (generation 1 to
1e-5 * sum|c|)."""

from __future__ import annotations

import numpy as np
import pytest

from queasars_tpu.evolve import MultiObjectiveEVQESelection as JaxSelection
from queasars_tpu.evolve import crowding_distance as jax_crowding_distance
from queasars_tpu.evolve import non_dominated_sort as jax_non_dominated_sort
from queasars_tpu.evolve import pareto_front as jax_pareto_front
from queasars_tpu.evolve.base import OperatorContext as JaxContext
from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.problems.spin_chains import heisenberg_chain as jax_heisenberg
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu.solver import MoGVQEMinimumEigensolver as JaxMoG
from queasars_tpu.solver import result_pareto_front as jax_result_pareto_front
from queasars_tpu_torch.evolve import (
    MultiObjectiveEVQESelection,
    crowding_distance,
    non_dominated_sort,
    pareto_front,
)
from queasars_tpu_torch.evolve.base import OperatorContext
from queasars_tpu_torch.genome import EVQEPopulation
from queasars_tpu_torch.interop import individual_to_plain
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.problems.spin_chains import heisenberg_chain
from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    EVQEMinimumEigensolverConfiguration,
    MoGVQEMinimumEigensolver,
    result_pareto_front,
)
from tests.test_torch_solver import SETTINGS, _structures


def _objectives(seed, pop, columns):
    """Seeded objectives on a coarse grid, so that ties and duplicates
    occur."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(pop, columns)).astype(float) + (
        rng.integers(0, 2, size=(pop, columns)) * 0.5
    )


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("columns", [2, 3])
def test_sorting_and_crowding_equal_jax(seed, columns):
    objectives = _objectives(seed, 9 + seed, columns)
    fronts = non_dominated_sort(objectives)
    assert fronts == jax_non_dominated_sort(objectives)
    assert sorted(i for front in fronts for i in front) == list(range(len(objectives)))
    for front in fronts:
        np.testing.assert_array_equal(
            crowding_distance(objectives, front), jax_crowding_distance(objectives, front)
        )


def _plain(front):
    return [(individual_to_plain(ind), energy, gates) for ind, energy, gates in front]


@pytest.mark.parametrize("seed", range(3))
def test_pareto_front_equals_jax(seed):
    ours = EVQEPopulation.random_population(3, 3, 10, True, random_seed=seed).individuals
    theirs = JaxPopulation.random_population(3, 3, 10, True, random_seed=seed).individuals
    rng = np.random.default_rng(seed)
    energies = list(np.round(rng.normal(size=10), 1))
    energies[3] = energies[7]  # a tie
    want = [(individual_to_plain(ind), e, g) for ind, e, g in jax_pareto_front(theirs, energies)]
    assert _plain(pareto_front(ours, energies)) == want


@pytest.mark.parametrize("layer_penalty", [0.0, 0.5])
def test_selection_draws_equal_jax(layer_penalty):
    op = heisenberg_chain(3)
    op_ref = jax_heisenberg(3)
    reports = []

    def run(selection, context, evaluator, population):
        counts = []
        out = selection.apply_operator(population, context(
            circuit_evaluator=evaluator, result_callback=reports.append,
            circuit_evaluation_count_callback=counts.append,
        ))
        return [individual_to_plain(ind) for ind in out.individuals], counts

    got = run(MultiObjectiveEVQESelection(layer_penalty, random_seed=4), OperatorContext,
              StatevectorExpectationEvaluator(op, device="cpu"),
              EVQEPopulation.random_population(3, 3, 12, True, random_seed=2))
    want = run(JaxSelection(layer_penalty, random_seed=4), JaxContext, JaxEvaluator(op_ref),
               JaxPopulation.random_population(3, 3, 12, True, random_seed=2))
    assert got == want
    np.testing.assert_allclose(reports[0].expectation_values, reports[1].expectation_values,
                               atol=1e-5 * float(np.abs(op_ref.coeffs).sum()), rtol=0)


MOG = {
    **{k: v for k, v in SETTINGS.items() if k != "configured_sampler"},
    "configured_sampler": None, "selection_alpha_penalty": 0.0, "selection_beta_penalty": 0.0,
    "population_size": 8, "max_generations": 3,
}
NFT = dict(maxiter=4, reset_interval=3, five_point=True)


class JaxNumbers(JaxEvaluator):
    """The JAX package's evaluator with the two members the port's driver
    reads."""

    device = "cpu"

    def initial_states(self, pop):
        return None


def _solvers(optimizer, jax_optimizer):
    ours = MoGVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(), optimizer=optimizer, device="cpu", **MOG))
    ref = JaxMoG(JaxConfig(configured_estimator=JaxEstimator(), optimizer=jax_optimizer, **MOG))
    return ours, ref


def test_mog_vqe_host_call_order_with_the_jax_numerics():
    op_ref = jax_heisenberg(3)
    optimizer = JaxNFT(JaxNFTConfig(**NFT))
    ours, theirs = _solvers(optimizer, optimizer)
    ref = theirs.compute_minimum_eigenvalue(op_ref)
    replay = ours._solve_by_evolution(JaxNumbers(op_ref), None)
    assert replay.generations == ref.generations == 3
    assert _structures(replay) == _structures(ref)
    assert replay.circuit_evaluations == ref.circuit_evaluations
    for got, want in zip(replay.population_evaluation_results, ref.population_evaluation_results):
        np.testing.assert_array_equal(got.expectation_values, want.expectation_values)
    assert replay.eigenvalue == ref.eigenvalue
    want_front = [(individual_to_plain(i), e, g) for i, e, g in jax_result_pareto_front(ref)]
    assert _plain(result_pareto_front(replay)) == want_front


def test_mog_vqe_solve_matches_jax_in_generation_one():
    op, op_ref = heisenberg_chain(3), jax_heisenberg(3)
    ours, theirs = _solvers(BatchedNFT(NFTConfig(**NFT)), JaxNFT(JaxNFTConfig(**NFT)))
    got = ours.compute_minimum_eigenvalue(op)
    ref = theirs.compute_minimum_eigenvalue(op_ref)
    assert _structures(got)[0] == _structures(ref)[0]
    np.testing.assert_allclose(
        got.population_evaluation_results[0].expectation_values,
        ref.population_evaluation_results[0].expectation_values,
        atol=1e-5 * float(np.abs(op_ref.coeffs).sum()), rtol=0,
    )
    front = result_pareto_front(got)
    energies = [e for _, e, _ in front]
    gates = [g for _, _, g in front]
    assert front and energies == sorted(energies) and gates == sorted(gates, reverse=True)
    assert energies[0] == got.population_evaluation_results[-1].best_expectation_value
    assert got.eigenvalue >= float(np.linalg.eigvalsh(op.to_dense_matrix())[0]) - 1e-5
