"""Amplitude-sharded solves of the port against the JAX package's: EVQE,
MoG-VQE and QNEAT through the driver (``shard_amplitudes=True`` on a mesh
of ``["cpu"] * 8`` factored by ``amp_devices``), and QAOA over an
amplitude mesh.

- A seeded EVQE solve, a MoG-VQE solve and a QNEAT solve give the JAX
  package's first generation (equal genome structures, energies to 1e-4 *
  max|table|, the tolerance ``tests/test_torch_solver.py`` holds) and
  ledger.
- Whole EVQE trajectories (exact estimator, and the sampler with CVaR)
  are bit-identical on the 8x1, 4x2, 2x4 and 1x8 factorizations.
- QAOA's sharded energies and autograd gradients equal the JAX package's
  ``make_sharded_qaoa_energies_fn`` and ``jax.grad`` to 1e-5 (relative to
  the largest) and are bit-identical on 1, 2, 4 and 8 amplitude cells; a
  cut QAOA solve, exact and sampled, reports the JAX package's best
  bitstring and energies.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.parallel import population_mesh as jax_population_mesh
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.paulis import pauli_z_string as jax_z
from queasars_tpu.paulis.diagonal import diagonal_terms as jax_terms
from queasars_tpu.sim.qaoa import make_sharded_qaoa_energies_fn
from queasars_tpu.sim.sharded_evaluator import amplitude_mesh as jax_amplitude_mesh
from queasars_tpu.sim.sharded_statevector import build_device_table as jax_device_table
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxEVQE
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxEVQEConfig
from queasars_tpu.solver import MoGVQEMinimumEigensolver as JaxMoG
from queasars_tpu.solver import QNEATMinimumEigensolver as JaxQNEAT
from queasars_tpu.solver import QNEATMinimumEigensolverConfiguration as JaxQNEATConfig
from queasars_tpu.solver.qaoa import QAOAConfiguration as JaxQAOAConfig
from queasars_tpu.solver.qaoa import QAOAMinimumEigensolver as JaxQAOA
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.parallel import population_mesh
from queasars_tpu_torch.parallel.amplitude import amplitude_mesh
from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
from queasars_tpu_torch.paulis.diagonal import diagonal_terms
from queasars_tpu_torch.sim.qaoa import sharded_qaoa_energies
from queasars_tpu_torch.sim.sharded_statevector import build_device_table
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    ConfiguredSampler,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
    MoGVQEMinimumEigensolver,
    QNEATMinimumEigensolver,
    QNEATMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.solver.qaoa import QAOAConfiguration, QAOAMinimumEigensolver

N = 8
CELLS = ["cpu"] * 8

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's many small torch operations on one thread: under
    the suite's parallel workers, torch's intra-op pool on every worker
    oversubscribes the cores and multiplies these tests' time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _operator(cls, z_string, n=N):
    rng = np.random.default_rng(4)
    pairs = [rng.choice(n, size=2, replace=False) for _ in range(6)]
    weights = rng.normal(size=6)
    return cls.sum([z_string(q, n) * (float(q + 1) / n) for q in range(n)]
                   + [z_string(int(a), n) @ z_string(int(b), n) * float(w)
                      for (a, b), w in zip(pairs, weights)])


def _evqe_settings(sampler=False, generations=2, maxiter=4):
    return dict(
        optimizer_n_circuit_evaluations=None, max_generations=generations,
        max_circuit_evaluations=None, termination_criterion=None, random_seed=7,
        population_size=6, speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.05, selection_beta_penalty=0.05,
        parameter_search_probability=0.4, topological_search_probability=0.4,
        layer_removal_probability=0.1, use_tournament_selection=True, tournament_size=2,
        shard_amplitudes=True, distribution_alpha_tail=0.5 if sampler else 1.0,
    )


def _port_evqe(amp_devices, sampler=False, generations=2, solver=EVQEMinimumEigensolver,
               **extra):
    config = EVQEMinimumEigensolverConfiguration(
        configured_estimator=None if sampler else ConfiguredEstimator(),
        configured_sampler=ConfiguredSampler(shots=128, seed=3) if sampler else None,
        optimizer=BatchedNFT(NFTConfig(maxiter=4)), mesh=population_mesh(devices=CELLS),
        amp_devices=amp_devices, device="cpu", **_evqe_settings(sampler, generations), **extra)
    return solver(config).compute_minimum_eigenvalue(_operator(PauliSum, pauli_z_string))


def _jax_evqe(amp_devices, generations=1, solver=JaxEVQE, **extra):
    config = JaxEVQEConfig(
        configured_estimator=JaxEstimator(), configured_sampler=None,
        optimizer=JaxNFT(JaxNFTConfig(maxiter=4)), mesh=jax_population_mesh(8),
        amp_devices=amp_devices, **_evqe_settings(False, generations), **extra)
    return solver(config).compute_minimum_eigenvalue(_operator(JaxPauliSum, jax_z))


def _first_generation(result):
    gen = result.population_evaluation_results[0]
    return ([repr(ind.layers) for ind in gen.population.individuals],
            np.asarray(gen.expectation_values, dtype=np.float64))


def _assert_first_generation_equal(ours, theirs):
    (layers, energies), (layers_ref, energies_ref) = (_first_generation(ours),
                                                      _first_generation(theirs))
    assert layers == layers_ref
    scale = float(np.abs(_operator(PauliSum, pauli_z_string).coeffs).sum())
    np.testing.assert_allclose(energies, energies_ref, atol=1e-4 * scale)
    assert ours.circuit_evaluations[0] == theirs.circuit_evaluations[0]


@pytest.mark.parametrize("solver", ["evqe", "mog"])
def test_sharded_solve_matches_jax(solver):
    port, ref = ((EVQEMinimumEigensolver, JaxEVQE) if solver == "evqe"
                 else (MoGVQEMinimumEigensolver, JaxMoG))
    _assert_first_generation_equal(_port_evqe(4, generations=1, solver=port),
                                   _jax_evqe(4, solver=ref))


def test_sharded_qneat_matches_jax():
    settings = dict(configured_sampler=None, max_generations=1, max_circuit_evaluations=None,
                    termination_criterion=None, random_seed=7, population_size=6,
                    add_gate_probability=0.6, pack_min_layers=3, shard_amplitudes=True,
                    amp_devices=2)
    ours = QNEATMinimumEigensolver(QNEATMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(), mesh=population_mesh(devices=CELLS),
        device="cpu", **settings)).compute_minimum_eigenvalue(
        _operator(PauliSum, pauli_z_string))
    theirs = JaxQNEAT(JaxQNEATConfig(
        configured_estimator=JaxEstimator(), mesh=jax_population_mesh(8), **settings,
    )).compute_minimum_eigenvalue(_operator(JaxPauliSum, jax_z))
    _assert_first_generation_equal(ours, theirs)


def _trajectory(result):
    return ([list(g.expectation_values) for g in result.population_evaluation_results],
            result.eigenvalue, repr(result.best_individual), result.circuit_evaluations,
            result.eigenstate)


@pytest.mark.parametrize("sampler", [False, True])
def test_full_solve_bit_identical_across_factorizations(sampler):
    runs = {amp: _trajectory(_port_evqe(amp, sampler=sampler)) for amp in (1, 2, 4, 8)}
    for amp in (2, 4, 8):
        assert runs[amp] == runs[1]


# ---------------------------------------------------------------------------
# QAOA
# ---------------------------------------------------------------------------


def _qaoa_inputs(n=6, starts=3, reps=2, seed=2):
    rng = np.random.default_rng(seed)
    gammas = rng.uniform(0, 0.3, size=(starts, reps)).astype(np.float32)
    betas = rng.uniform(0, 1.5, size=(starts, reps)).astype(np.float32)
    return gammas, betas


def _port_qaoa(n_amp, gammas, betas, n=6):
    mesh = amplitude_mesh(devices=["cpu"] * n_amp)
    row = mesh.row(0, n)
    op = _operator(PauliSum, pauli_z_string, n)
    coeffs, masks = diagonal_terms(op)
    tables = build_device_table(mesh, coeffs, masks, n).of(row)
    params = torch.as_tensor(np.concatenate([gammas, betas], axis=1)).requires_grad_(True)
    p = gammas.shape[1]
    energies = sharded_qaoa_energies(row, tables, params[:, :p], params[:, p:])
    (grad,) = torch.autograd.grad(energies.sum(), params)
    return energies.detach().numpy(), grad.numpy()


def test_sharded_qaoa_energies_and_gradients_match_jax():
    n = 6
    gammas, betas = _qaoa_inputs(n)
    mesh = jax_amplitude_mesh(4)
    coeffs, masks = jax_terms(_operator(JaxPauliSum, jax_z, n))
    table = jax_device_table(mesh, coeffs, masks, n)
    fn = make_sharded_qaoa_energies_fn(mesh, n)
    want = np.asarray(fn(table, jnp.asarray(gammas), jnp.asarray(betas)))
    grads = jax.grad(lambda g, b: fn(table, g, b).sum(), argnums=(0, 1))(
        jnp.asarray(gammas), jnp.asarray(betas))
    want_grad = np.concatenate([np.asarray(grads[0]), np.asarray(grads[1])], axis=1)
    runs = {n_amp: _port_qaoa(n_amp, gammas, betas) for n_amp in (1, 2, 4, 8)}
    energies, grad = runs[4]
    np.testing.assert_allclose(energies, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(grad, want_grad, atol=1e-5 * np.abs(want_grad).max())
    for n_amp in (1, 2, 8):
        np.testing.assert_array_equal(runs[n_amp][0], energies)
        np.testing.assert_array_equal(runs[n_amp][1], grad)


@pytest.mark.parametrize("shots", [None, 256])
def test_sharded_qaoa_solve_matches_jax(shots):
    n = 6
    settings = dict(reps=2, n_starts=3, maxiter=5, shots=shots, seed=1, eigenstate_top_k=4)
    ours = QAOAMinimumEigensolver(QAOAConfiguration(
        mesh=amplitude_mesh(devices=["cpu"] * 4), device="cpu", **settings,
    )).compute_minimum_eigenvalue(_operator(PauliSum, pauli_z_string, n))
    theirs = JaxQAOA(JaxQAOAConfig(mesh=jax_amplitude_mesh(4), **settings)
                     ).compute_minimum_eigenvalue(_operator(JaxPauliSum, jax_z, n))
    scale = float(np.abs(_operator(PauliSum, pauli_z_string, n).coeffs).sum())
    np.testing.assert_allclose(ours.start_energies, theirs.start_energies, atol=1e-5 * scale)
    assert ours.best_bitstring == theirs.best_bitstring
    assert ours.best_bitstring_energy == pytest.approx(theirs.best_bitstring_energy, abs=1e-12)
    assert ours.optimal_state is None and ours.circuit_evaluations == theirs.circuit_evaluations
    assert set(ours.eigenstate) == set(theirs.eigenstate)
    for state, p in theirs.eigenstate.items():
        assert ours.eigenstate[state] == pytest.approx(p, abs=1e-5)
