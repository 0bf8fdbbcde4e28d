"""Identity and single-Z observable helpers.

Behavioral port of queasars/utility/pauli_strings.py:7-41, returning
:class:`~queasars_tpu_torch.paulis.pauli_sum.PauliSum` instead of Qiskit
``SparsePauliOp``.  The qubit-index convention matches the reference (index
counts from the right of the label string, i.e. bit ``q`` of the basis-state
integer — pauli_strings.py:39).
"""

from __future__ import annotations

import numpy as np

from queasars_tpu_torch.paulis.pauli_sum import PauliSum, _masks_from_qubits, _n_words


def pauli_identity_string(n_qubits: int) -> PauliSum:
    """All-identity observable; expectation 1 for any state.

    Reference: queasars/utility/pauli_strings.py:7-18.
    """
    if n_qubits < 1:
        raise ValueError("need n_qubits >= 1")
    return PauliSum.identity(n_qubits)


def pauli_z_string(qubit_index: int, n_qubits: int) -> PauliSum:
    """Single Pauli-Z at ``qubit_index``; eigenvalue -1 iff that qubit is |1>.

    Reference: queasars/utility/pauli_strings.py:21-41.
    """
    if n_qubits < 1:
        raise ValueError("need n_qubits >= 1")
    if not 0 <= qubit_index < n_qubits:
        raise ValueError("qubit index out of range for this operator width")
    w = _n_words(n_qubits)
    return PauliSum(
        n_qubits,
        np.array([1.0], dtype=np.complex128),
        _masks_from_qubits([qubit_index], n_qubits)[None, :],
        np.zeros((1, w), dtype=np.uint64),
    )
