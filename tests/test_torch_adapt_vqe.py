"""The port's ADAPT-VQE against the JAX package's (CPU).

The pool is compared array for array; the screen's gradient vector and its
pick on Hamiltonians with random coefficients (so no two candidates tie) to
1e-5 of the largest gradient; whole solves at depth <= 3 with 20 Adam steps
per re-optimization (the picks, their gradients, the energies to 1e-5 *
sum|c|, the evaluation count).  The H2 anchor (O'Malley et al., PRX 6,
031007 (2016)) runs on the port alone: monotone descent to chemical
accuracy.  The port applies only the gate each candidate or grown layer
holds; the JAX package applies whole layers whose other slots are
identities, which leave the states bit-equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.parallel import population_mesh as jax_population_mesh
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.solver import AdaptVQEConfiguration as JaxConfiguration
from queasars_tpu.solver import AdaptVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver.adapt_vqe import _build_pool as jax_build_pool
from queasars_tpu.solver.adapt_vqe import _screen_pool as jax_screen_pool
from queasars_tpu.solver.adapt_vqe import _screen_pool_sharded as jax_screen_pool_sharded
from queasars_tpu_torch.parallel import population_mesh
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table
from queasars_tpu_torch.sim.expectation import pauli_terms
from queasars_tpu_torch.solver import (
    AdaptVQEConfiguration,
    AdaptVQEMinimumEigensolver,
    AdaptVQEResult,
)
from queasars_tpu_torch.solver.adapt_vqe import _build_pool, screen_pool, screen_pool_sharded

N = 4


def _random_operator(n, seed, alphabet="IXYZ", terms=9):
    """(port, JAX) Pauli sums of ``terms`` random strings with normal
    coefficients."""
    rng = np.random.default_rng(seed)
    labels = ["".join(rng.choice(list(alphabet), n)) for _ in range(terms)]
    coeffs = [float(c) for c in rng.normal(size=terms)]
    return (PauliSum.sum([PauliSum.from_label(l, c) for l, c in zip(labels, coeffs)]),
            JaxPauliSum.sum([JaxPauliSum.from_label(l, c) for l, c in zip(labels, coeffs)]))


def _jax_operands(op_ref, diagonal):
    if diagonal:
        from queasars_tpu.paulis.diagonal import diagonal_energy_table as jax_table

        return jnp.asarray(jax_table(op_ref, dtype=np.float32))
    return (jnp.asarray(op_ref.coeffs.real.astype(np.float32)),
            jnp.asarray(op_ref.coeffs.imag.astype(np.float32)),
            jnp.asarray(op_ref.z[:, 0].astype(np.uint32)),
            jnp.asarray(op_ref.x[:, 0].astype(np.uint32)))


@pytest.mark.parametrize("n, pool, size", [(12, "full", 288), (20, "linear", 116),
                                           (20, "full", 800), (5, "single", 10)])
def test_pool_equals_jax(n, pool, size):
    got, want = _build_pool(n, pool), jax_build_pool(n, pool)
    assert len(got[3]) == size
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


@pytest.mark.parametrize("diagonal", [False, True])
def test_screen_matches_jax(diagonal):
    op, op_ref = _random_operator(N, 5, "IZ" if diagonal else "IXYZ")
    rng = np.random.default_rng(7)
    vec = rng.normal(size=(2, 1 << N)).astype(np.float32)
    vec /= np.sqrt((vec**2).sum())
    pool = _build_pool(N, "full")
    operands = (diagonal_energy_table(op, dtype=torch.float32) if diagonal
                else pauli_terms(op))
    got = screen_pool(torch.as_tensor(vec), *pool[:3], operands, N, diagonal)
    want = np.asarray(jax_screen_pool(jnp.asarray(vec), *map(jnp.asarray, pool[:3]),
                                      _jax_operands(op_ref, diagonal), N, diagonal))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    ranked = np.sort(np.abs(want))[::-1]
    assert ranked[0] - ranked[1] > 1e-3 * ranked[0]  # no tie at the top
    assert int(np.argmax(np.abs(got))) == int(np.argmax(np.abs(want)))


@pytest.mark.parametrize(
    "diagonal, pool", [(False, "full"), (True, "linear"), (False, "single")])
def test_solve_matches_jax(diagonal, pool):
    op, op_ref = _random_operator(N, 11 if diagonal else 3, "IZ" if diagonal else "IXYZ")
    settings = dict(max_depth=3, optimizer_maxiter=20, pool=pool, gradient_tolerance=1e-6)
    got = AdaptVQEMinimumEigensolver(AdaptVQEConfiguration(device="cpu", **settings)
                                     ).compute_minimum_eigenvalue(op)
    want = JaxSolver(JaxConfiguration(**settings)).compute_minimum_eigenvalue(op_ref)
    tol = 1e-5 * float(np.abs(op_ref.coeffs).sum())
    assert isinstance(got, AdaptVQEResult)
    assert [r.candidate for r in got.iterations] == [r.candidate for r in want.iterations]
    assert len(got.iterations) == 3
    for mine, theirs in zip(got.iterations, want.iterations):
        assert mine.gradient == pytest.approx(theirs.gradient, abs=1e-5 * abs(theirs.gradient))
        assert mine.energy == pytest.approx(theirs.energy, abs=tol)
    assert got.eigenvalue == pytest.approx(want.eigenvalue, abs=tol)
    assert got.n_circuit_evaluations == want.n_circuit_evaluations
    assert got.converged == want.converged
    assert [repr(l) for l in got.optimal_individual.layers] == [
        repr(l) for l in want.optimal_individual.layers]
    np.testing.assert_allclose(got.optimal_point, want.optimal_point, atol=1e-4)


def h2_hamiltonian() -> PauliSum:
    """The 2-qubit reduced H2 Hamiltonian at R = 0.75 A (O'Malley et al.,
    PRX 6, 031007 (2016), Table I; the identity offset dropped)."""
    return PauliSum.sum([
        PauliSum.from_label("ZI", 0.3435),
        PauliSum.from_label("IZ", -0.4347),
        PauliSum.from_label("ZZ", 0.5716),
        PauliSum.from_label("XX", 0.0910),
        PauliSum.from_label("YY", 0.0910),
    ])


def test_h2_anchor_descends_monotonically_to_chemical_accuracy():
    """arXiv:1812.11173 Fig. 2's behaviour: each gradient-screened growth
    iteration lowers the energy, ending within chemical accuracy (1.6e-3
    Hartree) of the exact ground energy and never below it."""
    hamiltonian = h2_hamiltonian()
    exact = float(np.linalg.eigvalsh(hamiltonian.to_dense_matrix())[0])
    result = AdaptVQEMinimumEigensolver(AdaptVQEConfiguration(
        max_depth=6, optimizer_maxiter=150, pool="full", device="cpu")
    ).compute_minimum_eigenvalue(hamiltonian)
    energies = [record.energy for record in result.iterations]
    assert len(energies) >= 2
    for before, after in zip(energies, energies[1:]):
        assert after <= before + 1e-6
    assert abs(result.iterations[0].gradient) > 0
    assert exact - 1e-6 <= result.eigenvalue <= exact + 1.6e-3


def test_eigenstate_start_converges_with_an_identity_genome():
    op = PauliSum.sum([PauliSum.from_label("IIZ", 1.0), PauliSum.from_label("IZI", -1.0),
                       PauliSum.from_label("ZII", 1.0)])
    result = AdaptVQEMinimumEigensolver(AdaptVQEConfiguration(
        max_depth=4, start="zero", device="cpu")).compute_minimum_eigenvalue(op)
    assert result.converged and result.iterations == ()
    assert result.eigenvalue == pytest.approx(1.0, abs=1e-6)
    assert len(result.optimal_individual.layers) == 1
    assert result.n_circuit_evaluations == 1 + 2 * 3 + 6 * 2


def test_configuration_checks():
    assert AdaptVQEConfiguration(n_devices=2).n_devices == 2  # the mesh is ported
    for bad in (dict(max_depth=0), dict(gradient_tolerance=-1.0), dict(pool="ring"),
                dict(optimizer_maxiter=0), dict(learning_rate=0.0), dict(start="minus"),
                dict(energy_tolerance=-1.0)):
        with pytest.raises(ValueError):
            AdaptVQEConfiguration(**bad)


@pytest.mark.parametrize("diagonal", [False, True])
def test_mesh_sharded_screen_matches_single_device(diagonal):
    """The screen split over 8 and over 3 CPU blocks (the full pool's 32
    candidates padded to 33 with an all-identity one) equals the
    single-device screen bit for bit, as the JAX package's sharded screen
    equals its own (tests/test_adapt_vqe.py:194), and agrees with the JAX
    package's 8-device screen to 1e-5 of the largest gradient."""
    op, op_ref = _random_operator(N, 5, "IZ" if diagonal else "IXYZ")
    rng = np.random.default_rng(7)
    vec = rng.normal(size=(2, 1 << N)).astype(np.float32)
    vec /= np.sqrt((vec**2).sum())
    pool = _build_pool(N, "full")
    operands = (diagonal_energy_table(op, dtype=torch.float32) if diagonal
                else pauli_terms(op))
    state = torch.as_tensor(vec)
    single = screen_pool(state, *pool[:3], operands, N, diagonal)
    for blocks in (8, 3):
        mesh = population_mesh(devices=["cpu"] * blocks)
        sharded = screen_pool_sharded(mesh, state, *pool[:3], operands, N, diagonal)
        assert sharded.shape == (len(pool[3]),)
        np.testing.assert_array_equal(sharded, single)
    want = np.asarray(jax_screen_pool_sharded(
        jax_population_mesh(8), jnp.asarray(vec), *map(jnp.asarray, pool[:3]),
        _jax_operands(op_ref, diagonal), N, diagonal))
    np.testing.assert_allclose(single, want, atol=1e-5 * np.abs(want).max())


def test_mesh_solve_equals_the_unsharded_solve():
    """A solve whose screens run on 8 CPU blocks (``n_devices`` with
    ``device="cpu"``, and an explicit mesh) equals the unsharded solve."""
    op, _ = _random_operator(N, 3)
    settings = dict(max_depth=3, optimizer_maxiter=15, pool="linear", device="cpu")
    plain = AdaptVQEMinimumEigensolver(AdaptVQEConfiguration(**settings)
                                       ).compute_minimum_eigenvalue(op)
    for mesh_settings in (dict(n_devices=8), dict(mesh=population_mesh(devices=["cpu"] * 4))):
        meshed = AdaptVQEMinimumEigensolver(AdaptVQEConfiguration(**settings, **mesh_settings)
                                            ).compute_minimum_eigenvalue(op)
        assert meshed.iterations == plain.iterations
        assert meshed.eigenvalue == plain.eigenvalue
        assert meshed.n_circuit_evaluations == plain.n_circuit_evaluations
