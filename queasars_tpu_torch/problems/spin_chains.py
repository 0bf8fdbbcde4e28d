"""Spin-chain Hamiltonians: non-diagonal Pauli sums for the general-operator
path.

Counterpart of ``queasars_tpu/problems/spin_chains.py``: the transverse-field
Ising chain (the repository's config 2 family) and the isotropic Heisenberg
chain (config 5), with the reference's term order.
"""

from __future__ import annotations

from queasars_tpu_torch.paulis import PauliSum


def transverse_field_ising(
    n_qubits: int,
    coupling: float = 1.0,
    field: float = 1.0,
    periodic: bool = False,
) -> PauliSum:
    """Transverse-field Ising chain ``-J sum Z_i Z_{i+1} - g sum X_i``."""
    if n_qubits < 2:
        raise ValueError("a chain needs at least 2 qubits")
    terms = []
    bonds = n_qubits if periodic else n_qubits - 1
    for i in range(bonds):
        terms.append(
            PauliSum.from_sparse_list([("ZZ", [i, (i + 1) % n_qubits], -coupling)], n_qubits)
        )
    for i in range(n_qubits):
        terms.append(PauliSum.from_sparse_list([("X", [i], -field)], n_qubits))
    return PauliSum.sum(terms)


def heisenberg_chain(
    n_qubits: int,
    coupling: float = 1.0,
    periodic: bool = False,
) -> PauliSum:
    """Isotropic Heisenberg chain ``J sum (XX + YY + ZZ)``."""
    if n_qubits < 2:
        raise ValueError("a chain needs at least 2 qubits")
    terms = []
    bonds = n_qubits if periodic else n_qubits - 1
    for i in range(bonds):
        for paulis in ("XX", "YY", "ZZ"):
            terms.append(
                PauliSum.from_sparse_list([(paulis, [i, (i + 1) % n_qubits], coupling)], n_qubits)
            )
    return PauliSum.sum(terms)
