"""Pauli-sum algebra on packed bitmask arrays, and diagonal energy tables."""

from queasars_tpu_torch.paulis.pauli_sum import PauliSum
from queasars_tpu_torch.paulis.strings import pauli_identity_string, pauli_z_string
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table

__all__ = [
    "PauliSum",
    "pauli_identity_string",
    "pauli_z_string",
    "diagonal_energy_table",
]
