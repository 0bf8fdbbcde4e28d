"""QWC grouping, the spin-chain builders and the grouped-measurement
operands of the port against the JAX package's, on TFIM, Heisenberg, random
Hermitian Pauli sums (tests/test_grouping.py's generator) and the
molecular-like 3-local operator of experiments/exp_grouped_pallas.py at
n <= 14.  Everything here is host arithmetic on equal inputs, so arrays must
be equal and the group order identical: each group's shot key is
``fold_in(key, g)`` in that order.
"""

from __future__ import annotations

import numpy as np
import pytest

from experiments.exp_grouped_pallas import molecular_like as jax_molecular_like
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.paulis.grouping import measurement_rotation_layer as jax_rotation_layer
from queasars_tpu.paulis.grouping import pauli_label_coefficients as jax_label_coefficients
from queasars_tpu.paulis.grouping import qwc_groups as jax_qwc_groups
from queasars_tpu.problems import spin_chains as jax_chains
from queasars_tpu.sim.grouped_sampling import allocate_shots as jax_allocate_shots
from queasars_tpu.sim.grouped_sampling import grouped_operands as jax_grouped_operands
from queasars_tpu.sim.grouped_sampling import grouped_weights as jax_grouped_weights
from queasars_tpu_torch.interop import grouped_operands_from_numpy, pauli_sum_from_numpy
from queasars_tpu_torch.paulis.grouping import (
    measurement_rotation_layer,
    pauli_label_coefficients,
    qwc_groups,
)
from queasars_tpu_torch.problems import spin_chains
from queasars_tpu_torch.sim.grouped_sampling import (
    allocate_shots,
    grouped_operands,
    grouped_weights,
    group_shot_counts,
)


def random_hermitian(n: int, n_terms: int, seed: int):
    """Random real-coefficient Pauli strings over I/X/Y/Z (the JAX
    package's tests/test_grouped_sampling.py generator), in both packages."""
    rng = np.random.default_rng(seed)
    labels = ["".join(rng.choice(list("IXYZ")) for _ in range(n)) for _ in range(n_terms)]
    coeffs = [float(rng.normal()) for _ in range(n_terms)]
    return JaxPauliSum.sum([JaxPauliSum.from_label(l, c) for l, c in zip(labels, coeffs)])


def _port(op_ref):
    return pauli_sum_from_numpy(op_ref.n_qubits, op_ref.z, op_ref.x, op_ref.coeffs)


CASES = {
    "tfim-6": lambda: jax_chains.transverse_field_ising(6, coupling=1.0, field=0.9),
    "tfim-14-periodic": lambda: jax_chains.transverse_field_ising(14, 0.7, 1.3, periodic=True),
    "heisenberg-5": lambda: jax_chains.heisenberg_chain(5),
    "heisenberg-12-periodic": lambda: jax_chains.heisenberg_chain(12, 0.5, periodic=True),
    "random-4": lambda: random_hermitian(4, 12, 3),
    "random-9": lambda: random_hermitian(9, 25, 11),
    "molecular-14": lambda: jax_molecular_like(14, 40, 7),
    "molecular-10": lambda: jax_molecular_like(10, 30, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_groups_and_rotation_layers_match_jax(case):
    op_ref = CASES[case]()
    op = _port(op_ref)
    np.testing.assert_array_equal(pauli_label_coefficients(op), jax_label_coefficients(op_ref))
    const, groups = qwc_groups(op)
    const_ref, groups_ref = jax_qwc_groups(op_ref)
    assert const == const_ref and len(groups) == len(groups_ref)
    for g, g_ref in zip(groups, groups_ref):
        np.testing.assert_array_equal(g.x_basis, g_ref.x_basis)
        np.testing.assert_array_equal(g.y_basis, g_ref.y_basis)
        np.testing.assert_array_equal(g.diagonal.z, g_ref.diagonal.z)
        np.testing.assert_array_equal(g.diagonal.x, g_ref.diagonal.x)
        np.testing.assert_array_equal(g.diagonal.coeffs, g_ref.diagonal.coeffs)
        for got, want in zip(measurement_rotation_layer(g, op.n_qubits),
                             jax_rotation_layer(g_ref, op.n_qubits)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_operands_and_weights_match_jax(case):
    op_ref = CASES[case]()
    op = _port(op_ref)
    ops = grouped_operands(op)
    rot_types, rot_angles, tables, const = jax_grouped_operands(op_ref)
    np.testing.assert_array_equal(ops.rot_types.numpy(), np.asarray(rot_types))
    np.testing.assert_array_equal(ops.rot_angles.numpy(), np.asarray(rot_angles))
    np.testing.assert_array_equal(ops.tables.numpy(), np.asarray(tables))
    assert np.float32(ops.const) == np.asarray(const)
    assert ops.rotate == tuple(bool(t.any()) for t in np.asarray(rot_types))
    np.testing.assert_array_equal(grouped_weights(op), jax_grouped_weights(op_ref))
    via = grouped_operands_from_numpy(rot_types, rot_angles, tables, const)
    for name in ("rot_types", "rot_angles", "tables", "rot_factors", "rot_active"):
        assert np.array_equal(getattr(via, name).numpy(), getattr(ops, name).numpy()), name
    assert via.const == ops.const and via.rotate == ops.rotate


@pytest.mark.parametrize("builder, args", [
    ("transverse_field_ising", (2,)), ("transverse_field_ising", (20, 1.0, 0.9)),
    ("transverse_field_ising", (7, 0.5, 2.0, True)), ("heisenberg_chain", (2,)),
    ("heisenberg_chain", (9, -1.5, True)),
])
def test_spin_chain_builders_match_jax(builder, args):
    op = getattr(spin_chains, builder)(*args)
    op_ref = getattr(jax_chains, builder)(*args)
    assert op.n_qubits == op_ref.n_qubits and not op.is_diagonal
    np.testing.assert_array_equal(op.z, op_ref.z)
    np.testing.assert_array_equal(op.x, op_ref.x)
    np.testing.assert_array_equal(op.coeffs, op_ref.coeffs)
    with pytest.raises(ValueError):
        getattr(spin_chains, builder)(1)


def test_tfim20_has_a_z_group_and_an_x_group():
    """The slice's operator: 19 ZZ bonds and 20 X fields in two groups,
    one measured in the computational basis, one under H on every qubit."""
    op = spin_chains.transverse_field_ising(20, coupling=1.0, field=0.9)
    const, groups = qwc_groups(op)
    assert const == 0.0 and op.n_terms == 39 and len(groups) == 2
    ops = grouped_operands(op)
    assert sorted(ops.rotate) == [False, True]
    rotated = ops.rotate.index(True)
    assert (ops.rot_types[rotated] == 1).all() and (ops.rot_types[1 - rotated] == 0).all()
    np.testing.assert_allclose(grouped_weights(op)[rotated], 18.0)
    np.testing.assert_allclose(grouped_weights(op)[1 - rotated], 19.0)


@pytest.mark.parametrize("weights, total", [
    ([3.0, 1.0], 8), ([5.0, 3.0, 2.0], 100), ([1000.0, 1e-6], 10), ([1.0, 1.0, 1.0], 7),
    ([0.3, 2.5, 1.1, 0.9, 4.0], 513),
])
def test_allocate_shots_matches_jax(weights, total):
    got = allocate_shots(weights, total)
    assert got == jax_allocate_shots(weights, total)
    assert sum(got) == total and min(got) >= 1


def test_allocation_and_shot_count_errors():
    with pytest.raises(ValueError):
        allocate_shots([1.0, 2.0, 3.0], 2)
    with pytest.raises(ValueError):
        allocate_shots([1.0, 0.0], 10)
    assert group_shot_counts(64, 3) == (64, 64, 64)
    assert group_shot_counts((5, 6), 2) == (5, 6)
    with pytest.raises(ValueError):
        group_shot_counts((5, 6), 3)


def test_grouping_refuses_what_the_reference_refuses():
    non_hermitian = pauli_sum_from_numpy(
        2, np.array([[1]], np.uint64), np.array([[1]], np.uint64), np.array([1.0 + 0j])
    )  # 1 * Z X = -iY: not Hermitian
    with pytest.raises(ValueError, match="Hermitian"):
        qwc_groups(non_hermitian)
    identity_only = pauli_sum_from_numpy(
        3, np.zeros((1, 1), np.uint64), np.zeros((1, 1), np.uint64), np.array([2.5 + 0j])
    )
    assert qwc_groups(identity_only) == (2.5, [])
    with pytest.raises(ValueError, match="no non-identity terms"):
        grouped_operands(identity_only)
