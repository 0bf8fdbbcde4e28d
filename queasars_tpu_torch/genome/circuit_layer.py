"""Immutable genome circuit layers with constrained random generation.

Behavioral port of
queasars/minimum_eigensolvers/evqe/quantum_circuit/circuit_layer.py:22-239.
``random_layer`` reproduces the reference's exact ``random.Random`` call
sequence (one ``choice`` per eligible qubit, then ``sample`` draws for CR
pairing) so seeded genome structures match the reference's distribution
call-for-call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from random import Random
from typing import Optional

from queasars_tpu_torch.genome.gates import (
    ControlGate,
    ControlledGate,
    ControlledRotationGate,
    EVQEGate,
    EVQEGateType,
    IdentityGate,
    RotationGate,
)


class EVQECircuitLayerException(Exception):
    """Raised for invalid circuit-layer operations
    (reference: circuit_layer.py:238-239)."""


@dataclass(frozen=True)
class EVQECircuitLayer:
    """One circuit layer: a tuple of gate slots, one per qubit
    (reference: circuit_layer.py:22-35).

    :param n_qubits: qubit count the layer acts on
    :param gates: gate per qubit; ``gates[q].qubit_index == q`` must hold
    """

    n_qubits: int
    gates: tuple[EVQEGate, ...]

    # cached in __post_init__
    _n_parameters: int = field(init=False, repr=False, compare=False, default=0)
    _n_controlled_gates: int = field(init=False, repr=False, compare=False, default=0)

    @staticmethod
    def random_layer(
        n_qubits: int,
        previous_layer: Optional["EVQECircuitLayer"] = None,
        random_seed: Optional[int] = None,
    ) -> "EVQECircuitLayer":
        """Generate a random layer honoring the previous-layer constraint.

        Semantics (reference: circuit_layer.py:37-125): a qubit that held a
        rotation or identity in the previous layer may only receive a
        controlled rotation now (prevents stacking redundant parameters);
        CR pairs duplicating a previous-layer pair are rejected; a single
        leftover CR candidate becomes a rotation unless the previous layer
        already rotated it.
        """
        if n_qubits < 1:
            raise EVQECircuitLayerException("a circuit layer needs at least one qubit")
        if previous_layer is not None and previous_layer.n_qubits != n_qubits:
            raise EVQECircuitLayerException(
                f"previous_layer spans {previous_layer.n_qubits} qubits but this layer spans "
                + f"{n_qubits}"
            )

        chosen: list[EVQEGate] = [IdentityGate(qubit_index=q) for q in range(n_qubits)]
        cr_candidates: list[int] = []
        rng = Random(random_seed)

        for q in range(n_qubits):
            prev_forces_cr = previous_layer is not None and previous_layer.gates[q].gate_type() in (
                EVQEGateType.ROTATION,
                EVQEGateType.IDENTITY,
            )
            if prev_forces_cr:
                cr_candidates.append(q)
            else:
                gate_type = rng.choice([EVQEGateType.ROTATION, EVQEGateType.CONTROLLED_ROTATION])
                if gate_type == EVQEGateType.CONTROLLED_ROTATION:
                    cr_candidates.append(q)
                else:
                    chosen[q] = RotationGate(qubit_index=q)

        while len(cr_candidates) >= 2:
            rotation_qubit, control_qubit = rng.sample(cr_candidates, 2)
            rotation_gate = ControlledRotationGate(
                qubit_index=rotation_qubit, control_qubit_index=control_qubit
            )
            control_gate = ControlGate(qubit_index=control_qubit, controlled_qubit_index=rotation_qubit)
            if previous_layer is None or (
                rotation_gate not in previous_layer.gates and control_gate not in previous_layer.gates
            ):
                chosen[control_qubit] = control_gate
                chosen[rotation_qubit] = rotation_gate
                cr_candidates.remove(rotation_qubit)
                cr_candidates.remove(control_qubit)

        if len(cr_candidates) == 1:
            q = cr_candidates[0]
            if previous_layer is not None and previous_layer.gates[q].gate_type() == EVQEGateType.ROTATION:
                chosen[q] = IdentityGate(qubit_index=q)
            else:
                chosen[q] = RotationGate(qubit_index=q)

        return EVQECircuitLayer(n_qubits=n_qubits, gates=tuple(chosen))

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "_n_parameters", int(sum(gate.n_parameters() for gate in self.gates))
        )
        object.__setattr__(
            self,
            "_n_controlled_gates",
            sum(1 for gate in self.gates if isinstance(gate, ControlledGate)),
        )
        if not self.is_valid():
            raise EVQECircuitLayerException("layer construction produced an inconsistent layer")

    @property
    def n_parameters(self) -> int:
        """Rotation parameters offered by this layer (3 per R/CR slot)."""
        return self._n_parameters

    @property
    def n_controlled_gates(self) -> int:
        return self._n_controlled_gates

    def is_valid(self) -> bool:
        """Slot/pairing consistency (reference: circuit_layer.py:157-189)."""
        if len(self.gates) != self.n_qubits:
            return False
        for q, gate in enumerate(self.gates):
            if q != gate.qubit_index:
                return False
            if isinstance(gate, ControlledGate):
                partner = self.gates[gate.control_qubit_index]
                if not (isinstance(partner, ControlGate) and partner.controlled_qubit_index == q):
                    return False
            if isinstance(gate, ControlGate):
                partner = self.gates[gate.controlled_qubit_index]
                if not (
                    isinstance(partner, ControlledRotationGate) and partner.control_qubit_index == q
                ):
                    return False
        return True

    def parameterized_qubits(self) -> tuple[int, ...]:
        """Qubit indices contributing parameters, ascending (canonical
        flat-parameter order; see genome/__init__.py ordering note)."""
        return tuple(q for q, gate in enumerate(self.gates) if gate.n_parameters() > 0)
