"""The port's EVQE solve against the JAX package's.

(1) A 7-qubit JSSP solve (population 6, 2 generations, NFT maxiter 4)
against the JAX solver with ``use_pallas=True`` and ``QUEASARS_MXU=0`` (the
slot-kernel route the port follows; on the CPU the JAX package runs that
route's math on its jnp engine).  The genome structure of every generation
must be identical, and every generation's energies must agree to
1e-4 * max|table|: the two routes round differently at the ulp level inside
each NFT step, and those differences compound over the steps of a solve.

(2) The committed structural-trajectory fixture, replayed through the
port's host modules.
"""

from __future__ import annotations

import json
import os

import numpy as np

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.paulis import pauli_z_string as jax_z_string
from queasars_tpu.problems.jssp import JSSPDomainWallHamiltonianEncoder as JaxEncoder
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu_torch.genome import parameter_order
from queasars_tpu_torch.interop import individual_to_plain
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)

SETTINGS = dict(
    configured_sampler=None,
    optimizer_n_circuit_evaluations=None,
    max_generations=2,
    max_circuit_evaluations=None,
    termination_criterion=None,
    random_seed=0,
    population_size=6,
    speciation_genetic_distance_threshold=2,
    selection_alpha_penalty=0.1,
    selection_beta_penalty=0.1,
    parameter_search_probability=0.5,
    topological_search_probability=0.5,
    layer_removal_probability=0.2,
    pack_min_layers=4,
)


def _structures(result):
    return [
        [individual_to_plain(ind)["layers"] for ind in evaluation.population.individuals]
        for evaluation in result.population_evaluation_results
    ]


def test_solve_matches_jax_slot_kernel_route(monkeypatch):
    monkeypatch.setenv("QUEASARS_MXU", "0")
    instance = dict(
        instance_name="t7", n_jobs=2, n_machines=2, relative_op_amount=0.5,
        op_duration={1: 0.5, 2: 0.5}, random_seed=0,
    )
    h = JSSPDomainWallHamiltonianEncoder(
        random_job_shop_scheduling_instance(**instance), makespan_limit=5
    ).get_problem_hamiltonian()
    h_ref = JaxEncoder(jax_random_instance(**instance), makespan_limit=5).get_problem_hamiltonian()
    assert h.n_qubits == 7

    ours = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        optimizer=BatchedNFT(NFTConfig(maxiter=4)), device="cpu", **SETTINGS,
    )).compute_minimum_eigenvalue(h)
    ref = JaxSolver(JaxConfig(
        configured_estimator=JaxEstimator(),
        optimizer=JaxNFT(JaxNFTConfig(maxiter=4)), use_pallas=True, **SETTINGS,
    )).compute_minimum_eigenvalue(h_ref)

    assert _structures(ours) == _structures(ref)
    assert ours.circuit_evaluations == ref.circuit_evaluations
    tol = 1e-4 * np.abs(jax_table(h_ref)).max()
    for got, want in zip(ours.population_evaluation_results, ref.population_evaluation_results):
        np.testing.assert_allclose(got.expectation_values, want.expectation_values, atol=tol)
    np.testing.assert_allclose(ours.eigenvalue, ref.eigenvalue, atol=tol)
    best = max(ours.eigenstate, key=ours.eigenstate.get)
    assert best == max(ref.eigenstate, key=ref.eigenstate.get)


def test_pinned_structural_trajectory():
    """tests/fixtures/structural_trajectory.json, written by the JAX
    package's solver, replayed through the port's host modules (driver,
    operators, genome, packing) with the JAX package's evaluator and
    optimizer doing the numbers.  The fixture's 4-qubit operator has
    exactly degenerate energies, so its tournaments are decided at the ulp
    level; the JAX numerics keep those decisions, and the fixture then pins
    the port's ``random.Random`` call order and genome edits.  The port has
    only the fused parameter search, so the JAX optimizer runs its fused
    ``minimize_slots`` (``cache_prefix=True``) in place of the per-slot loop
    that wrote the fixture; the trajectory is the same."""

    class JaxNumbers(JaxEvaluator):
        device = "cpu"

        def initial_states(self, pop):
            return None

    n_qubits = 4
    hamiltonian = JaxPauliSum.sum(
        [jax_z_string(q, n_qubits) * float(q + 1) for q in range(n_qubits)]
    )
    settings = dict(SETTINGS, max_generations=3, random_seed=77, pack_min_layers=None)
    solver = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        optimizer=JaxNFT(JaxNFTConfig(maxiter=4, cache_prefix=True)),
        use_tournament_selection=True, tournament_size=2, parameter_order="qiskit",
        reuse_selection_energies=False, device="cpu", **settings,
    ))
    with parameter_order("qiskit"):
        result = solver._solve_by_evolution(JaxNumbers(hamiltonian), None)
    structures = [
        [
            [[[code for code, _ in layer], [partner for _, partner in layer]]
             for layer in individual_to_plain(individual)["layers"]]
            for individual in evaluation.population.individuals
        ]
        for evaluation in result.population_evaluation_results
    ]
    with open(os.path.join(os.path.dirname(__file__), "fixtures", "structural_trajectory.json")) as fh:
        assert structures == json.load(fh)
