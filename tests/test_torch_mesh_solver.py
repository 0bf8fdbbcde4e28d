"""Mesh-integrated solves of the port (``mesh`` / ``n_devices``), after the
JAX package's ``tests/test_mesh_solver.py``.

Seeded EVQE solves on one CPU block and on eight are bit-identical with the
exact estimator, the sampler, SPSA, estimator precision noise and gradient
descent, and with a population smaller than the mesh; so are MoG-VQE and
QNEAT solves.  The first generation of the port's 8-block solve agrees
with the JAX package's 8-device solve as ``tests/test_torch_solver.py``
holds the unsharded one (equal genome structures, energies to 1e-4 *
max|table|).  A checkpoint written under an 8-block mesh resumes on one
block to the uninterrupted trajectory and loads in the JAX package.  Every
case in which the JAX package shards amplitudes builds the
amplitude-sharded evaluator (``tests/test_torch_amp_solve.py`` runs it).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.parallel import population_mesh as jax_population_mesh
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.problems.jssp import JSSPDomainWallHamiltonianEncoder as JaxEncoder
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu.solver.checkpoint import load_checkpoint as jax_load_checkpoint
from queasars_tpu_torch.interop import individual_to_plain
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.optim.gradient import BatchedGradientDescent, GradientDescentConfig
from queasars_tpu_torch.optim.spsa import BatchedSPSA, SPSAConfig
from queasars_tpu_torch.parallel import population_mesh
from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    ConfiguredSampler,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
    MoGVQEMinimumEigensolver,
    QNEATMinimumEigensolver,
    QNEATMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.solver.checkpoint import load_checkpoint

N_QUBITS = 4


def cpu_mesh(blocks: int):
    return population_mesh(devices=["cpu"] * blocks)


def _hamiltonian(n=N_QUBITS):
    return PauliSum.sum([pauli_z_string(q, n) * float(q + 1) for q in range(n)])


def _configuration(blocks, *, sampler=False, optimizer=None, generations=3, precision=None,
                   **overrides):
    settings = dict(
        configured_estimator=None if sampler else ConfiguredEstimator(precision=precision, seed=7),
        configured_sampler=ConfiguredSampler(shots=256, seed=5) if sampler else None,
        optimizer=optimizer or BatchedNFT(NFTConfig(maxiter=6)),
        optimizer_n_circuit_evaluations=None,
        max_generations=generations,
        max_circuit_evaluations=None,
        termination_criterion=None,
        random_seed=11,
        population_size=10,
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1,
        parameter_search_probability=0.5,
        topological_search_probability=0.7,
        layer_removal_probability=0.3,
        use_tournament_selection=True,
        tournament_size=2,
        mesh=cpu_mesh(blocks) if blocks else None,
        device="cpu",
    )
    settings.update(overrides)
    return EVQEMinimumEigensolverConfiguration(**settings)


def _solve(blocks, **kwargs):
    return EVQEMinimumEigensolver(_configuration(blocks, **kwargs)).compute_minimum_eigenvalue(
        _hamiltonian())


def _assert_identical_trajectories(result_a, result_b):
    assert result_a.generations == result_b.generations
    for gen_a, gen_b in zip(
        result_a.population_evaluation_results, result_b.population_evaluation_results
    ):
        assert gen_a.expectation_values == gen_b.expectation_values
        assert gen_a.best_individual == gen_b.best_individual
    assert result_a.eigenvalue == result_b.eigenvalue
    assert result_a.best_individual == result_b.best_individual
    assert result_a.circuit_evaluations == result_b.circuit_evaluations
    assert result_a.eigenstate == result_b.eigenstate


SOLVES = {
    "estimator": dict(),
    "sampler": dict(sampler=True),
    "spsa": dict(optimizer=BatchedSPSA(SPSAConfig(maxiter=4, learning_rate=0.1,
                                                  perturbation=0.2)), generations=2),
    "precision": dict(precision=0.05, generations=2),
    "gradient": dict(optimizer=BatchedGradientDescent(GradientDescentConfig(maxiter=4)),
                     generations=2),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_bit_identical_on_1_and_8_blocks(case):
    result_1 = _solve(1, **SOLVES[case])
    result_8 = _solve(8, **SOLVES[case])
    _assert_identical_trajectories(result_1, result_8)


def test_bitstring_function_solve_bit_identical_on_1_and_8_blocks():
    """The black-box bitstring objective: the blocks draw the shots, the
    host evaluates the whole population's observed states."""
    from queasars_tpu_torch.utils.bitstring_evaluation import BitstringEvaluator

    def weight(bits: str) -> float:
        return float(sum((q + 1) * (1 if b == "1" else -1) for q, b in enumerate(bits)))

    results = [
        EVQEMinimumEigensolver(_configuration(blocks, sampler=True, generations=2))
        .compute_minimum_function_value(BitstringEvaluator(N_QUBITS, weight))
        for blocks in (1, 8)
    ]
    _assert_identical_trajectories(*results)


def test_calibrated_spsa_and_population_smaller_than_the_mesh():
    """SPSA calibrating its rates per individual, and a population of 3 on
    8 blocks (padding fills whole blocks with masked individuals)."""
    spsa = BatchedSPSA(SPSAConfig(maxiter=3, calibration_steps=2))
    _assert_identical_trajectories(_solve(1, optimizer=spsa, generations=2),
                                   _solve(8, optimizer=spsa, generations=2))
    small = dict(population_size=3, optimizer=BatchedNFT(NFTConfig(maxiter=4)), generations=2,
                 random_seed=2)
    _assert_identical_trajectories(_solve(1, **small), _solve(8, **small))


def test_mesh_solve_reaches_the_ground_state_energy():
    """The Z chain's ground energy is -sum(q + 1) = -10."""
    result = _solve(8, generations=4)
    assert result.eigenvalue < -6.0


def test_n_devices_on_the_cpu_equals_the_explicit_mesh():
    explicit = _solve(4, generations=2)
    shorthand = EVQEMinimumEigensolver(
        _configuration(None, generations=2, n_devices=4)).compute_minimum_eigenvalue(
        _hamiltonian())
    _assert_identical_trajectories(explicit, shorthand)


def test_mog_vqe_and_qneat_bit_identical_on_1_and_8_blocks():
    mog = [MoGVQEMinimumEigensolver(_configuration(blocks, generations=2))
           .compute_minimum_eigenvalue(_hamiltonian()) for blocks in (1, 8)]
    _assert_identical_trajectories(*mog)

    def qneat(blocks):
        return QNEATMinimumEigensolver(QNEATMinimumEigensolverConfiguration(
            configured_estimator=ConfiguredEstimator(), configured_sampler=None,
            max_generations=2, max_circuit_evaluations=None, termination_criterion=None,
            random_seed=3, population_size=6, optimizer=BatchedNFT(NFTConfig(maxiter=4)),
            mesh=cpu_mesh(blocks), device="cpu",
        )).compute_minimum_eigenvalue(_hamiltonian())

    _assert_identical_trajectories(qneat(1), qneat(8))


@pytest.mark.parametrize("path", ["estimator", "sampler"])
def test_checkpoint_written_under_a_mesh_resumes_in_either_package(tmp_path, path):
    checkpoint = os.path.join(tmp_path, "state.json")
    sampler = path == "sampler"
    full = _solve(8, sampler=sampler, generations=4)
    _solve(8, sampler=sampler, generations=2, checkpoint_path=checkpoint)
    resumed = _solve(1, sampler=sampler, generations=4, resume_from_checkpoint=checkpoint)
    _assert_identical_trajectories(full, resumed)
    ours, theirs = load_checkpoint(checkpoint), jax_load_checkpoint(checkpoint)
    assert theirs.n_generations == ours.n_generations
    assert theirs.n_circuit_evaluations == ours.n_circuit_evaluations
    assert theirs.evaluator == ours.evaluator
    assert [e.expectation_values for e in theirs.population_evaluations] == \
        [e.expectation_values for e in ours.population_evaluations]


SETTINGS = dict(
    configured_sampler=None,
    optimizer_n_circuit_evaluations=None,
    max_generations=1,
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
    reuse_selection_energies=True,
)


def test_first_generation_matches_the_jax_8_device_solve():
    """The 7-qubit JSSP solve of ``tests/test_torch_solver.py`` on 8 blocks
    against the JAX package's on its 8 devices: both run the fused
    multi-slot search (``cache_prefix=True``) and reuse the selection
    energies, so the first generation takes the same path in both."""
    instance = dict(
        instance_name="t7", n_jobs=2, n_machines=2, relative_op_amount=0.5,
        op_duration={1: 0.5, 2: 0.5}, random_seed=0,
    )
    h = JSSPDomainWallHamiltonianEncoder(
        random_job_shop_scheduling_instance(**instance), makespan_limit=5
    ).get_problem_hamiltonian()
    h_ref = JaxEncoder(jax_random_instance(**instance), makespan_limit=5).get_problem_hamiltonian()
    ours = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        optimizer=BatchedNFT(NFTConfig(maxiter=4, cache_prefix=True)), device="cpu",
        mesh=cpu_mesh(8), **SETTINGS,
    )).compute_minimum_eigenvalue(h)
    ref = JaxSolver(JaxConfig(
        configured_estimator=JaxEstimator(),
        optimizer=JaxNFT(JaxNFTConfig(maxiter=4, cache_prefix=True)),
        mesh=jax_population_mesh(8), **SETTINGS,
    )).compute_minimum_eigenvalue(h_ref)
    (got,), (want,) = ours.population_evaluation_results, ref.population_evaluation_results
    assert ([individual_to_plain(i)["layers"] for i in got.population.individuals]
            == [individual_to_plain(i)["layers"] for i in want.population.individuals])
    assert ours.circuit_evaluations == ref.circuit_evaluations
    tol = 1e-4 * np.abs(jax_table(h_ref)).max()
    np.testing.assert_allclose(got.expectation_values, want.expectation_values, atol=tol)
    np.testing.assert_allclose(ours.eigenvalue, ref.eigenvalue, atol=tol)


def test_amplitude_sharding_cases_raise():
    """Every case in which the JAX package shards amplitudes takes the
    amplitude-sharded evaluator (it no longer raises): ``shard_amplitudes=
    True`` with a mesh (EVQE, MoG-VQE), None with a mesh above 20 qubits
    (EVQE, QNEAT; the evaluator is built, the 21-qubit solve is not run),
    with the (pop, amp) factorization of the driver's rule; without a mesh,
    or at 20 qubits by default, the unsharded evaluator stays."""
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
    from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator
    from queasars_tpu_torch.solver.driver import EvolvingAnsatzMinimumEigensolver

    built = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the 21-qubit tables: many small ops under parallel workers
    try:

        def capture(self, evaluator, aux_evaluators, initial_state):
            built.append(evaluator)
            raise StopIteration

        def evaluator_of(solver, operator):
            with pytest.MonkeyPatch.context() as patch:
                patch.setattr(EvolvingAnsatzMinimumEigensolver, "_solve", capture)
                with pytest.raises(StopIteration):
                    solver.compute_minimum_eigenvalue(operator)
            return built.pop()

        sharded = evaluator_of(EVQEMinimumEigensolver(
            _configuration(2, shard_amplitudes=True)), _hamiltonian())
        assert isinstance(sharded, AmplitudeShardedExpectationEvaluator)
        assert (sharded.n_pop_devices, sharded.n_amp_devices) == (2, 1)
        wide = evaluator_of(EVQEMinimumEigensolver(_configuration(2)), _hamiltonian(21))
        assert isinstance(wide, AmplitudeShardedExpectationEvaluator)
        assert (wide.n_pop_devices, wide.n_amp_devices) == (1, 2)
        assert isinstance(evaluator_of(MoGVQEMinimumEigensolver(
            _configuration(4, shard_amplitudes=True, amp_devices=4)), _hamiltonian()),
            AmplitudeShardedExpectationEvaluator)
        qneat = evaluator_of(QNEATMinimumEigensolver(QNEATMinimumEigensolverConfiguration(
            configured_estimator=ConfiguredEstimator(), configured_sampler=None,
            max_generations=1, max_circuit_evaluations=None, termination_criterion=None,
            mesh=cpu_mesh(2), device="cpu",
        )), _hamiltonian(21))
        assert isinstance(qneat, AmplitudeShardedExpectationEvaluator)
        assert qneat.n_amp_devices == 2
        for config, n in ((_configuration(None, shard_amplitudes=True), N_QUBITS),
                          (_configuration(2), 20)):
            assert isinstance(evaluator_of(EVQEMinimumEigensolver(config), _hamiltonian(n)),
                              StatevectorExpectationEvaluator)
        one = EVQEMinimumEigensolver(_configuration(2, shard_amplitudes=True, amp_devices=2))
        two = EVQEMinimumEigensolver(_configuration(2, shard_amplitudes=True, amp_devices=1))
        assert (_trajectory_of(one.compute_minimum_eigenvalue(_hamiltonian()))
                == _trajectory_of(two.compute_minimum_eigenvalue(_hamiltonian())))
    finally:
        torch.set_num_threads(threads)


def _trajectory_of(result):
    return ([list(g.expectation_values) for g in result.population_evaluation_results],
            result.eigenvalue, result.circuit_evaluations)