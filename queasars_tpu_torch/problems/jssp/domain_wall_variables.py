"""Domain-wall encoded categorical variables.

Behavioral port of queasars/utility/domain_wall_variables.py:14-170: one
variable choosing between n+1 values on n qubits (domain-wall encoding,
https://iopscience.iop.org/article/10.1088/2058-9565/ab33c2), emitting
:class:`~queasars_tpu_torch.paulis.pauli_sum.PauliSum` penalty/indicator terms.
"""

from __future__ import annotations

from typing import Generic, Hashable, Optional, TypeVar

from queasars_tpu_torch.paulis import PauliSum, pauli_identity_string, pauli_z_string

T = TypeVar("T", bound=Hashable)


class DomainWallVariable(Generic[T]):
    """A choice between ``len(values)`` unique values on ``len(values)-1`` qubits.

    :param qubit_start_index: first qubit index occupied by this variable
    :param values: the values to choose between (must be unique, >= 1)

    Reference: domain_wall_variables.py:29-41.
    """

    def __init__(self, qubit_start_index: int, values: tuple[T, ...]):
        self._qubit_start_index = qubit_start_index
        self._values = values
        if len(self._values) < 1:
            raise ValueError("a domain-wall variable needs a non-empty value set")
        self._value_indices = {value: i for i, value in enumerate(self._values)}
        if len(self._values) != len(self._value_indices):
            raise ValueError("domain-wall variable values contain duplicates")
        self._n_qubits = len(values) - 1

    @property
    def values(self) -> tuple[T, ...]:
        return self._values

    @property
    def n_qubits(self) -> int:
        return self._n_qubits

    @property
    def qubit_start_index(self) -> int:
        return self._qubit_start_index

    def _z_dash(self, i: int, circuit_n_qubits: int) -> PauliSum:
        """Z'_i: virtual -I before the variable (i == -1), +I after it
        (i == n_qubits), Pauli-Z on qubit ``start + i`` otherwise.

        Reference: domain_wall_variables.py:43-62.
        """
        if i < -1 or i > self._n_qubits:
            raise ValueError("value index exceeds this domain-wall variable")
        if i == -1:
            return pauli_identity_string(circuit_n_qubits) * -1.0
        if i == self._n_qubits:
            return pauli_identity_string(circuit_n_qubits)
        return pauli_z_string(qubit_index=self._qubit_start_index + i, n_qubits=circuit_n_qubits)

    def viability_term(self, quantum_circuit_n_qubits: int) -> PauliSum:
        """Penalty observable: eigenvalue 0 on single-domain-wall states,
        (k-1) on states with k walls.

        Reference: domain_wall_variables.py:79-113 —
        ``sum_{i=-1}^{n-1} (I - Z'_i Z'_{i+1}) / 2  -  I``.
        """
        if self._n_qubits == 0:
            return pauli_identity_string(quantum_circuit_n_qubits) * 0.0
        identity = pauli_identity_string(quantum_circuit_n_qubits)
        local_terms = [
            (
                identity
                - self._z_dash(i, quantum_circuit_n_qubits)
                @ self._z_dash(i + 1, quantum_circuit_n_qubits)
            )
            * 0.5
            for i in range(-1, self._n_qubits)
        ]
        local_terms.append(identity * -1.0)
        return PauliSum.sum(local_terms)

    def value_term(self, value: T, quantum_circuit_n_qubits: int) -> PauliSum:
        """Indicator observable: eigenvalue 1 iff the variable holds ``value``.

        Reference: domain_wall_variables.py:115-143 —
        ``(Z'_i - Z'_{i-1}) / 2`` for the value's index i.
        """
        if value not in self._value_indices:
            raise ValueError("value is not in this domain-wall variable")
        if self._n_qubits == 0:
            return pauli_identity_string(quantum_circuit_n_qubits)
        i = self._value_indices[value]
        return (
            self._z_dash(i, quantum_circuit_n_qubits) - self._z_dash(i - 1, quantum_circuit_n_qubits)
        ) * 0.5

    def value_from_bitlist(self, bit_list: list[int]) -> Optional[T]:
        """Decode the variable from a full-circuit bit list (bit q = qubit q);
        None if the segment holds more than one domain wall.

        Reference: domain_wall_variables.py:145-170.
        """
        segment = bit_list[self._qubit_start_index : self._qubit_start_index + self._n_qubits]
        wall_index = self._n_qubits
        for i, bit in enumerate(segment):
            if bit == 0:
                wall_index = i
                break
            if bit != 1:
                raise ValueError("bit_list entries must be 0 or 1")
        if sum(segment[wall_index:]) != 0:
            return None
        return self._values[wall_index]
