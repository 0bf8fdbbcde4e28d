"""The port's full-state checkpoints: a resumed solve equals the
uninterrupted one bit for bit, and a checkpoint moves between the port and
the JAX package in both directions.

Within the port: the exact path, the sampler's shot stream, the estimator's
precision-noise stream, a population-only file and QNEAT.  Across packages:
the JAX package (``use_pallas=True``, ``QUEASARS_MXU=0``: the slot-kernel
route the port follows on the CPU) writes a checkpoint after generation 2 of
a 3-generation 7-qubit JSSP solve; the port resumes it to generation 3, and against the
JAX package's uninterrupted run the genome structures and the evaluation
ledger are equal and the energies agree to 1e-4 * max|table|, the bar of
``tests/test_torch_solver.py`` (the two routes round differently at the ulp
level inside each NFT step).  The JAX package's ``load_checkpoint`` reads a
checkpoint the port wrote into equal fields.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.problems.jssp import JSSPDomainWallHamiltonianEncoder as JaxEncoder
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu.solver.checkpoint import load_checkpoint as jax_load_checkpoint
from queasars_tpu_torch.genome.serialization import EVQEPopulationJSONEncoder, load_population
from queasars_tpu_torch.interop import individual_to_plain
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance
from queasars_tpu_torch.problems.qubo import qubo_hamiltonian
from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    ConfiguredSampler,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
    QNEATMinimumEigensolver,
    QNEATMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.solver.checkpoint import load_checkpoint, restore_evaluator_state


def make_config(**overrides):
    settings = dict(
        configured_estimator=ConfiguredEstimator(),
        configured_sampler=None,
        optimizer=BatchedNFT(NFTConfig(maxiter=10)),
        optimizer_n_circuit_evaluations=None,
        max_generations=3,
        max_circuit_evaluations=None,
        termination_criterion=None,
        random_seed=0,
        population_size=6,
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1,
        parameter_search_probability=0.3,
        topological_search_probability=0.4,
        layer_removal_probability=0.05,
        use_tournament_selection=True,
        tournament_size=2,
        device="cpu",
    )
    settings.update(overrides)
    return EVQEMinimumEigensolverConfiguration(**settings)


def _hamiltonian():
    return PauliSum.sum([pauli_z_string(q, 3) for q in range(3)])


def _trajectory(result):
    return [
        (gen.expectation_values, gen.best_expectation_value)
        for gen in result.population_evaluation_results
    ]


def _crash_and_resume(tmp_path, total, crash_at, **overrides):
    """(the uninterrupted solve, the solve resumed after ``crash_at``
    generations) of the port on the 3-qubit Z sum."""
    hamiltonian = _hamiltonian()
    path = os.path.join(tmp_path, "state.json")
    uninterrupted = EVQEMinimumEigensolver(
        make_config(max_generations=total, **overrides)
    ).compute_minimum_eigenvalue(hamiltonian)
    EVQEMinimumEigensolver(
        make_config(max_generations=crash_at, checkpoint_path=path, **overrides)
    ).compute_minimum_eigenvalue(hamiltonian)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    resumed = EVQEMinimumEigensolver(
        make_config(max_generations=total, resume_from_checkpoint=path, **overrides)
    ).compute_minimum_eigenvalue(hamiltonian)
    return uninterrupted, resumed


@pytest.mark.parametrize("stream", ["exact", "sampler", "precision"])
def test_resume_reproduces_the_uninterrupted_trajectory(tmp_path, stream):
    overrides = {
        "exact": {},
        "sampler": dict(configured_estimator=None,
                        configured_sampler=ConfiguredSampler(shots=128, seed=9)),
        "precision": dict(configured_estimator=ConfiguredEstimator(precision=0.05, seed=3)),
    }[stream]
    uninterrupted, resumed = _crash_and_resume(tmp_path, 4, 2, **overrides)
    assert resumed.generations == uninterrupted.generations == 4
    assert _trajectory(resumed) == _trajectory(uninterrupted)
    assert resumed.eigenvalue == uninterrupted.eigenvalue
    assert resumed.eigenstate == uninterrupted.eigenstate
    assert resumed.best_individual == uninterrupted.best_individual
    assert resumed.circuit_evaluations == uninterrupted.circuit_evaluations


def test_population_only_file_loads_and_restarts(tmp_path):
    hamiltonian = _hamiltonian()
    path = os.path.join(tmp_path, "state.json")
    result = EVQEMinimumEigensolver(
        make_config(checkpoint_path=path)
    ).compute_minimum_eigenvalue(hamiltonian)
    population = load_population(path)
    assert len(population.individuals) == 6
    only = os.path.join(tmp_path, "population.json")
    with open(only, "w") as fh:
        json.dump(population, fh, cls=EVQEPopulationJSONEncoder)
    state = load_checkpoint(only)
    assert state.population.individuals == population.individuals
    assert state.n_generations == 0 and state.operator_rngs == [] and state.evaluator == {}
    resumed = EVQEMinimumEigensolver(
        make_config(max_generations=1, resume_from_checkpoint=only, random_seed=1)
    ).compute_minimum_eigenvalue(hamiltonian)
    assert resumed.generations == 1
    assert resumed.eigenvalue <= result.eigenvalue + 1e-6


def test_qneat_resume_reproduces_the_uninterrupted_trajectory(tmp_path):
    operator, _ = qubo_hamiltonian(np.array([[1.0, -2.0], [0.0, 1.0]]))
    path = os.path.join(tmp_path, "qneat_state.json")

    def config(max_generations, checkpoint=None, resume=None):
        return QNEATMinimumEigensolverConfiguration(
            configured_estimator=ConfiguredEstimator(),
            configured_sampler=ConfiguredSampler(shots=512, seed=0),
            max_generations=max_generations, max_circuit_evaluations=None,
            termination_criterion=None, random_seed=5, population_size=8,
            optimizer=BatchedNFT(NFTConfig(maxiter=4)),
            checkpoint_path=checkpoint, resume_from_checkpoint=resume, device="cpu",
        )

    full = QNEATMinimumEigensolver(config(5)).compute_minimum_eigenvalue(operator)
    QNEATMinimumEigensolver(config(3, checkpoint=path)).compute_minimum_eigenvalue(operator)
    with open(path) as fh:
        assert "qneat_population_individuals" in json.load(fh)["population"]
    resumed = QNEATMinimumEigensolver(
        config(5, checkpoint=path, resume=path)
    ).compute_minimum_eigenvalue(operator)
    assert _trajectory(resumed) == _trajectory(full)
    assert resumed.eigenvalue == full.eigenvalue
    assert resumed.best_individual == full.best_individual
    assert resumed.circuit_evaluations == full.circuit_evaluations


def test_version_one_noise_state_is_refused():
    evaluator = StatevectorExpectationEvaluator(_hamiltonian(), precision=0.05, device="cpu")
    with pytest.raises(ValueError, match="different noise law"):
        restore_evaluator_state(evaluator, {"counter": 3, "noise_rng": {"state": {"state": 1}}})
    restore_evaluator_state(evaluator, {"counter": 5})
    assert evaluator._counter == 5


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

INSTANCE = dict(instance_name="t7", n_jobs=2, n_machines=2, relative_op_amount=0.5,
                op_duration={1: 0.5, 2: 0.5}, random_seed=0)
SETTINGS = dict(
    configured_sampler=None, optimizer_n_circuit_evaluations=None,
    max_circuit_evaluations=None, termination_criterion=None, random_seed=0,
    population_size=6, speciation_genetic_distance_threshold=2, selection_alpha_penalty=0.1,
    selection_beta_penalty=0.1, parameter_search_probability=0.5,
    topological_search_probability=0.5, layer_removal_probability=0.2, pack_min_layers=4,
)


def _jax_solve(generations, **kwargs):
    hamiltonian = JaxEncoder(jax_random_instance(**INSTANCE), makespan_limit=5).get_problem_hamiltonian()
    return JaxSolver(JaxConfig(
        configured_estimator=JaxEstimator(), optimizer=JaxNFT(JaxNFTConfig(maxiter=4)),
        use_pallas=True, max_generations=generations, **SETTINGS, **kwargs,
    )).compute_minimum_eigenvalue(hamiltonian), hamiltonian


def _port_solve(generations, **kwargs):
    hamiltonian = JSSPDomainWallHamiltonianEncoder(
        random_job_shop_scheduling_instance(**INSTANCE), makespan_limit=5
    ).get_problem_hamiltonian()
    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(), optimizer=BatchedNFT(NFTConfig(maxiter=4)),
        max_generations=generations, device="cpu", **SETTINGS, **kwargs,
    )).compute_minimum_eigenvalue(hamiltonian)


def _structures(result):
    return [
        [individual_to_plain(ind)["layers"] for ind in evaluation.population.individuals]
        for evaluation in result.population_evaluation_results
    ]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's uninterrupted 3-generation solve and the last
    checkpoint it wrote: after the pipeline pass of generation 2 (the third
    pass stops at its selection, before a checkpoint)."""
    path = str(tmp_path_factory.mktemp("jax") / "state.json")
    mp = pytest.MonkeyPatch()
    mp.setenv("QUEASARS_MXU", "0")
    try:
        full, hamiltonian = _jax_solve(3, checkpoint_path=path)
    finally:
        mp.undo()
    assert jax_load_checkpoint(path).n_generations == 2
    return full, hamiltonian, path


def test_jax_checkpoint_resumes_in_the_port(jax_runs, monkeypatch):
    monkeypatch.setenv("QUEASARS_MXU", "0")
    full, hamiltonian, path = jax_runs
    resumed = _port_solve(3, resume_from_checkpoint=path)
    assert resumed.generations == full.generations == 3
    assert _structures(resumed) == _structures(full)
    assert resumed.circuit_evaluations == full.circuit_evaluations
    tol = 1e-4 * np.abs(jax_table(hamiltonian)).max()
    for got, want in zip(resumed.population_evaluation_results,
                         full.population_evaluation_results):
        np.testing.assert_allclose(got.expectation_values, want.expectation_values, atol=tol)
    # the first two generations are the JAX package's, carried over
    assert _trajectory(resumed)[:2] == _trajectory(full)[:2]
    np.testing.assert_allclose(resumed.eigenvalue, full.eigenvalue, atol=tol)


def test_port_checkpoint_loads_in_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setenv("QUEASARS_MXU", "0")
    path = os.path.join(tmp_path, "state.json")
    _port_solve(3, checkpoint_path=path)
    ours, theirs = load_checkpoint(path), jax_load_checkpoint(path)
    assert theirs.n_generations == ours.n_generations == 2
    assert theirs.n_circuit_evaluations == ours.n_circuit_evaluations
    assert theirs.best_expectation_value == ours.best_expectation_value
    assert individual_to_plain(theirs.best_individual) == individual_to_plain(ours.best_individual)
    assert [individual_to_plain(i) for i in theirs.population.individuals] == \
        [individual_to_plain(i) for i in ours.population.individuals]
    assert [(e.expectation_values, e.best_expectation_value)
            for e in theirs.population_evaluations] == \
        [(e.expectation_values, e.best_expectation_value) for e in ours.population_evaluations]
    assert theirs.operator_rngs == ours.operator_rngs
    assert theirs.evaluator == ours.evaluator
