"""The committed solve-trajectory fixtures (``tests/fixtures/
solve_trajectories.json``, written by the JAX package's solver) replayed
through the port's host modules: driver, operators, genome, packing and the
per-slot parameter-search loop, with the JAX package's evaluator and
optimizer doing the numbers.

The fixtures' solves run the JAX package's CPU route, where the prefix
cache resolves off, ``EVQEParameterSearch`` takes the per-slot loop and
selection evaluates the population itself (no energy reuse); so does the
replay.  Each configuration (canonical and qiskit parameter
orders) must give the fixture's per-generation bests, eigenvalue and
evaluation counts exactly, as ``tests/test_trajectory_fixtures.py`` holds
the JAX solve.  The fixtures' 4-qubit operator has degenerate levels, so
the port's own float rounding may pick other tournament winners after
generation 1; the JAX numerics keep those decisions.
"""

from __future__ import annotations

import json

import pytest

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.paulis import pauli_z_string as jax_z_string
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu_torch.genome.parameter_order import parameter_order
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from tests.test_trajectory_fixtures import CASES, FIXTURE_PATH


class JaxNumbers(JaxEvaluator):
    """The JAX package's evaluator with the two members the port's driver
    reads."""

    device = "cpu"

    def initial_states(self, pop):
        return None


def _replay(order: str, seed: int) -> dict:
    """The fixture's configuration (tests/test_trajectory_fixtures.py:_solve)
    on the port's solver."""
    hamiltonian = JaxPauliSum.sum([jax_z_string(q, 4) * float(q + 1) for q in range(4)])
    solver = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        configured_sampler=None,
        optimizer=JaxNFT(JaxNFTConfig(maxiter=8)),
        optimizer_n_circuit_evaluations=None,
        max_generations=3,
        max_circuit_evaluations=None,
        termination_criterion=None,
        random_seed=seed,
        population_size=6,
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1,
        parameter_search_probability=0.4,
        topological_search_probability=0.5,
        layer_removal_probability=0.1,
        use_tournament_selection=True,
        tournament_size=2,
        parameter_order=order,
        reuse_selection_energies=False,
        device="cpu",
    ))
    with parameter_order(order):
        result = solver._solve_by_evolution(JaxNumbers(hamiltonian), None)
    return {
        "parameter_order": order,
        "seed": seed,
        "best_per_generation": [
            gen.best_expectation_value for gen in result.population_evaluation_results
        ],
        "eigenvalue": result.eigenvalue,
        "circuit_evaluations": result.circuit_evaluations,
    }


@pytest.mark.parametrize("index", range(len(CASES)))
def test_fixture_trajectory_replays_through_the_port(index):
    with open(FIXTURE_PATH) as fh:
        want = json.load(fh)[index]
    order, seed = CASES[index]
    assert (want["parameter_order"], want["seed"]) == (order, seed)
    assert _replay(order, seed) == want
