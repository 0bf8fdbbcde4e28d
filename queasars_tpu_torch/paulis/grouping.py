"""Qubit-wise-commuting (QWC) measurement grouping for general Pauli sums.

Counterpart of ``queasars_tpu/paulis/grouping.py`` (numpy host code; the
port keeps its own copy).  A Hermitian :class:`PauliSum` is partitioned into
groups whose terms commute qubit-wise: on every qubit the terms of a group
act as the same non-identity Pauli, or as the identity.  Each group is then
measurable in one rotated product basis -- ``H`` on every X-basis qubit,
``Sdg`` then ``H`` on every Y-basis qubit (the U3 rotations ``H = U3(pi/2,
0, pi)`` and ``H.Sdg = U3(pi/2, 0, pi/2)``) -- in which every term of the
group is a plain Z-string over its support.  The operator's energy is the
sum of the groups' diagonal expectations plus the identity constant.

Grouping is greedy first-fit over the storage term order, so it is
deterministic for a given PauliSum, and the group order is the reference's
exactly: each group's shot key is ``fold_in(key, g)`` in this order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from queasars_tpu_torch.paulis.pauli_sum import PauliSum, _popcount_rows
from queasars_tpu_torch.sim.statevector import GATE_ID, GATE_ROT


@dataclass(frozen=True)
class MeasurementGroup:
    """One qubit-wise-commuting measurement group.

    :param x_basis: mask row (uint64 words) of the qubits measured in the X
        basis (rotate with ``H`` before the Z measurement)
    :param y_basis: mask row of the qubits measured in the Y basis (rotate
        with ``Sdg`` then ``H``)
    :param diagonal: the group in its measurement basis: a diagonal
        PauliSum whose Z-masks are the original terms' supports and whose
        coefficients are their real Pauli-label coefficients
    """

    x_basis: np.ndarray
    y_basis: np.ndarray
    diagonal: PauliSum


def pauli_label_coefficients(op: PauliSum, atol: float = 1e-10) -> np.ndarray:
    """Real per-term coefficients in the I/X/Y/Z label convention: the
    stored ``c`` of ``c * Z^z X^x`` times ``i^{n_Y}``.  Raises when a label
    coefficient has an imaginary part above ``atol`` (not Hermitian)."""
    n_y = _popcount_rows(op.z & op.x)
    label = op.coeffs * (1j) ** (n_y % 4)
    if np.abs(label.imag).max(initial=0.0) > atol:
        raise ValueError(
            "measurement grouping needs a Hermitian operator "
            "(a Pauli-label coefficient has a non-real value)"
        )
    return label.real.copy()


def qwc_groups(op: PauliSum, atol: float = 1e-10) -> tuple[float, list[MeasurementGroup]]:
    """Partition ``op`` into qubit-wise-commuting measurement groups.

    :return: ``(identity_constant, groups)``: the identity terms' summed
        coefficient (exact, never sampled) and the greedy first-fit groups
        in term order
    """
    label_coeffs = pauli_label_coefficients(op, atol=atol)
    t_x = op.x & ~op.z
    t_y = op.x & op.z
    t_z = op.z & ~op.x
    support = op.z | op.x

    identity_constant = 0.0
    basis_x: list[np.ndarray] = []
    basis_y: list[np.ndarray] = []
    basis_z: list[np.ndarray] = []
    members: list[list[int]] = []
    for k in range(op.n_terms):
        if not support[k].any():
            identity_constant += float(label_coeffs[k])
            continue
        for g in range(len(members)):
            conflict = (
                (t_x[k] & (basis_y[g] | basis_z[g])).any()
                or (t_y[k] & (basis_x[g] | basis_z[g])).any()
                or (t_z[k] & (basis_x[g] | basis_y[g])).any()
            )
            if not conflict:
                basis_x[g] |= t_x[k]
                basis_y[g] |= t_y[k]
                basis_z[g] |= t_z[k]
                members[g].append(k)
                break
        else:
            basis_x.append(t_x[k].copy())
            basis_y.append(t_y[k].copy())
            basis_z.append(t_z[k].copy())
            members.append([k])

    groups = []
    for g, idx in enumerate(members):
        rows = np.asarray(idx, dtype=np.int64)
        diagonal = PauliSum(
            op.n_qubits,
            label_coeffs[rows].astype(np.complex128),
            support[rows].copy(),
            np.zeros_like(support[rows]),
        )
        groups.append(MeasurementGroup(x_basis=basis_x[g], y_basis=basis_y[g], diagonal=diagonal))
    return identity_constant, groups


# H and H.Sdg as U3 angles (global phase dropped; measurement probabilities
# do not see it): H = U3(pi/2, 0, pi), H.Sdg = U3(pi/2, 0, pi/2)
_H_ANGLES = (np.pi / 2, 0.0, np.pi)
_HSDG_ANGLES = (np.pi / 2, 0.0, np.pi / 2)


def measurement_rotation_layer(
    group: MeasurementGroup, n_qubits: int
) -> tuple[np.ndarray, np.ndarray]:
    """The group's basis rotation as one genome layer: ``(gate_types [n]
    int32, angles [n, 3] float32)``, a ROT slot with the H / H.Sdg angles on
    every X/Y-basis qubit and ID elsewhere (no controls)."""
    gate_types = np.full(n_qubits, GATE_ID, dtype=np.int32)
    angles = np.zeros((n_qubits, 3), dtype=np.float32)
    for q in range(n_qubits):
        word, bit = q // 64, np.uint64(q % 64)
        if (group.x_basis[word] >> bit) & np.uint64(1):
            gate_types[q] = GATE_ROT
            angles[q] = _H_ANGLES
        elif (group.y_basis[word] >> bit) & np.uint64(1):
            gate_types[q] = GATE_ROT
            angles[q] = _HSDG_ANGLES
    return gate_types, angles
