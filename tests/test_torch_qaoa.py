"""The port's QAOA simulation and solver against the JAX package's (CPU).

The energy table (float32, summed term by term) and the start schedules
(threefry uniforms scaled as ``jax.random.uniform`` scales them) are
compared bit for bit; states, energies and gradients at n=9 to float32
rounding (states 1e-6, energies 1e-5 * max|table|, gradients 1e-4 of the
largest); whole solves at 15 Adam steps, where the schedules of the two
packages still agree to 1e-5 (each gamma and beta has a gradient far from
zero, so Adam's sign-of-rounding steps do not arise).  The instance is a
random QUBO with linear terms, whose optimum is unique (MaxCut's bit-flip
symmetry would leave the most probable bitstring a tie).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.paulis.diagonal import diagonal_energy_table_device as jax_device_table
from queasars_tpu.problems.qubo import qubo_hamiltonian as jax_qubo
from queasars_tpu.sim.qaoa import qaoa_energies_batch as jax_energies
from queasars_tpu.sim.qaoa import qaoa_state as jax_state
from queasars_tpu.solver import QAOAConfiguration as JaxConfiguration
from queasars_tpu.solver import QAOAMinimumEigensolver as JaxSolver
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table_device
from queasars_tpu_torch.problems import qubo_hamiltonian
from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
from queasars_tpu_torch.sim.qaoa import (
    plus_state_real,
    qaoa_energies_batch,
    qaoa_energy,
    qaoa_probabilities,
    qaoa_state,
)
from queasars_tpu_torch.solver import QAOAConfiguration, QAOAMinimumEigensolver
from queasars_tpu_torch.solver.qaoa import start_schedules
from tests.test_torch_optim import _operators


def _qubo(n, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, n))
    q[rng.random((n, n)) < 0.5] = 0.0
    linear = rng.normal(size=n)
    return qubo_hamiltonian(q, linear)[0], jax_qubo(q, linear)[0]


@pytest.mark.parametrize("maker", [lambda: _qubo(9), lambda: _operators(8, terms=30)])
def test_device_table_equals_jax_bit_for_bit(maker):
    op, op_ref = maker()
    got = diagonal_energy_table_device(op).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_device_table(op_ref)))


@pytest.mark.parametrize("seed, n_starts, reps", [(0, 8, 2), (7, 3, 4), (2**31 + 5, 5, 1)])
def test_start_schedules_equal_jax_bit_for_bit(seed, n_starts, reps):
    scale = np.float32(37.25)
    gammas, betas, key = start_schedules(seed, n_starts, reps, torch.tensor(scale))
    key_init, key_measure = jax.random.split(jax.random.PRNGKey(seed))
    key_g, key_b = jax.random.split(key_init)
    want_g = jax.random.uniform(key_g, (n_starts, reps), minval=0.0, maxval=1.0) / scale
    want_b = jax.random.uniform(key_b, (n_starts, reps), minval=0.0, maxval=float(np.pi) / 2.0)
    np.testing.assert_array_equal(gammas.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(betas.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(key.numpy(), np.asarray(key_measure).astype(np.int64))


def test_states_energies_and_gradients_match_jax():
    n = 9
    op, op_ref = _qubo(n)
    table = diagonal_energy_table_device(op)
    table_ref = jax_device_table(op_ref)
    rng = np.random.default_rng(3)
    gammas = rng.uniform(0, 0.3, size=(3, 2)).astype(np.float32)
    betas = rng.uniform(0, 1.5, size=(3, 2)).astype(np.float32)
    states = qaoa_state(table, torch.as_tensor(gammas), torch.as_tensor(betas), n)
    for b in range(3):
        np.testing.assert_allclose(
            states[b].numpy(), np.asarray(jax_state(table_ref, gammas[b], betas[b], n)), atol=1e-6)
    scale = float(np.abs(np.asarray(table_ref)).max())
    energies = qaoa_energies_batch(table, torch.as_tensor(gammas), torch.as_tensor(betas), n)
    want = np.asarray(jax_energies(table_ref, gammas, betas, n))
    np.testing.assert_allclose(energies.numpy(), want, atol=1e-5 * scale, rtol=0)
    assert float(qaoa_energy(table, torch.as_tensor(gammas[1]), torch.as_tensor(betas[1]), n)) \
        == pytest.approx(float(want[1]), abs=1e-5 * scale)
    probs = qaoa_probabilities(table, torch.as_tensor(gammas), torch.as_tensor(betas), n)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(plus_state_real(n)[0, 0], torch.full((1 << n,), 1 / np.sqrt(np.float32(512))))

    params = torch.as_tensor(np.concatenate([gammas, betas], axis=1)).requires_grad_(True)
    qaoa_energies_batch(table, params[:, :2], params[:, 2:], n).sum().backward()
    want_g = jax.grad(
        lambda x: jnp.sum(jax_energies(table_ref, x[:, :2], x[:, 2:], n))
    )(jnp.asarray(np.concatenate([gammas, betas], axis=1)))
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(params.grad.numpy(), want_g, atol=1e-4 * np.abs(want_g).max())


@pytest.mark.parametrize("shots", [None, 256])
def test_solve_matches_jax(shots):
    op, op_ref = _qubo(8, seed=11)
    settings = dict(reps=2, n_starts=4, maxiter=15, learning_rate=0.05, shots=shots, seed=3)
    got = QAOAMinimumEigensolver(QAOAConfiguration(device="cpu", **settings)
                                 ).compute_minimum_eigenvalue(op)
    want = JaxSolver(JaxConfiguration(**settings)).compute_minimum_eigenvalue(op_ref)
    scale = float(np.abs(np.asarray(jax_device_table(op_ref))).max())
    assert got.eigenvalue == pytest.approx(want.eigenvalue, abs=1e-5 * scale)
    np.testing.assert_allclose(got.start_energies, want.start_energies, atol=1e-5 * scale)
    np.testing.assert_allclose(got.optimal_gammas, want.optimal_gammas, rtol=1e-5)
    np.testing.assert_allclose(got.optimal_betas, want.optimal_betas, atol=1e-5)
    assert got.best_bitstring == want.best_bitstring
    assert got.best_bitstring_energy == want.best_bitstring_energy
    assert got.circuit_evaluations == want.circuit_evaluations == 4 * 31
    np.testing.assert_allclose(got.optimal_state, np.asarray(want.optimal_state), atol=1e-5)
    if shots is None:
        assert set(got.eigenstate) == set(want.eigenstate)
        for state, p in want.eigenstate.items():
            assert got.eigenstate[state] == pytest.approx(p, abs=1e-6)
    else:
        assert got.eigenstate == want.eigenstate


def test_configuration_and_operator_checks():
    with pytest.raises(ValueError, match="diagonal"):
        QAOAMinimumEigensolver(QAOAConfiguration(device="cpu")).compute_minimum_eigenvalue(
            transverse_field_ising(3))
    mesh = QAOAMinimumEigensolver(QAOAConfiguration(n_devices=2, device="cpu"))._resolve_mesh()
    assert (mesh.n_pop, mesh.n_amp) == (1, 2)
    assert QAOAMinimumEigensolver(QAOAConfiguration(n_devices=1))._resolve_mesh() is None
    for bad in (dict(reps=0), dict(n_starts=0), dict(maxiter=-1), dict(shots=0),
                dict(eigenstate_top_k=0)):
        with pytest.raises(ValueError):
            QAOAConfiguration(**bad)
