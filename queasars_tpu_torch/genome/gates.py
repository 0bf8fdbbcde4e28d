"""Gate-type alphabet of the EVQE genome.

Behavioral port of
queasars/minimum_eigensolvers/evqe/quantum_circuit/quantum_gate.py:12-165,
minus any circuit-building: gates are pure genome structure here; the
simulator consumes their tensor encoding
(:data:`~queasars_tpu_torch.sim.statevector.GATE_ID` etc. use the same integer
codes as :class:`EVQEGateType`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum


class EVQEGateType(Enum):
    """One slot per qubit per layer (reference: quantum_gate.py:12-20)."""

    IDENTITY = 0
    ROTATION = 1
    CONTROL = 2
    CONTROLLED_ROTATION = 3


@dataclass(frozen=True)
class EVQEGate(ABC):
    """A genome gate slot placed on ``qubit_index``
    (reference: quantum_gate.py:23-61)."""

    qubit_index: int

    @staticmethod
    @abstractmethod
    def gate_type() -> EVQEGateType:
        """The slot's gate type."""

    @staticmethod
    @abstractmethod
    def n_parameters() -> int:
        """Number of rotation parameters this slot contributes."""


@dataclass(frozen=True)
class IdentityGate(EVQEGate):
    """No-op slot (reference: quantum_gate.py:64-79)."""

    @staticmethod
    def gate_type() -> EVQEGateType:
        return EVQEGateType.IDENTITY

    @staticmethod
    def n_parameters() -> int:
        return 0


@dataclass(frozen=True)
class RotationGate(EVQEGate):
    """U3 rotation slot, 3 parameters (reference: quantum_gate.py:82-102)."""

    @staticmethod
    def gate_type() -> EVQEGateType:
        return EVQEGateType.ROTATION

    @staticmethod
    def n_parameters() -> int:
        return 3


@dataclass(frozen=True)
class ControlGate(EVQEGate):
    """Controlling half of a CU3 pair; points at its rotation partner
    (reference: quantum_gate.py:105-126)."""

    controlled_qubit_index: int

    @staticmethod
    def gate_type() -> EVQEGateType:
        return EVQEGateType.CONTROL

    @staticmethod
    def n_parameters() -> int:
        return 0


@dataclass(frozen=True)
class ControlledGate(EVQEGate, ABC):
    """Controlled half of a gate pair; points at its control partner
    (reference: quantum_gate.py:129-139)."""

    control_qubit_index: int


@dataclass(frozen=True)
class ControlledRotationGate(ControlledGate):
    """CU3 rotation applied to ``qubit_index`` when ``control_qubit_index``
    is |1>, 3 parameters (reference: quantum_gate.py:142-165)."""

    @staticmethod
    def gate_type() -> EVQEGateType:
        return EVQEGateType.CONTROLLED_ROTATION

    @staticmethod
    def n_parameters() -> int:
        return 3
