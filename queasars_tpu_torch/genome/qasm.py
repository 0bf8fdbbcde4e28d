"""OpenQASM 2.0 export for genome individuals.

Counterpart of ``queasars_tpu/genome/qasm.py``, character for character.
Interop story for users coming from the reference: where
``result.optimal_circuit`` returns a Qiskit ``QuantumCircuit``
(reference: evolving_ansatz_minimum_eigensolver_result.py:72-82), this
exporter renders a genome to OpenQASM 2.0 — loadable by Qiskit
(``QuantumCircuit.from_qasm_str``), Cirq, tket and real-hardware stacks.

Gate mapping: ROTATION -> ``u3`` on its qubit, CONTROLLED_ROTATION ->
``cu3 (control, target)`` — exactly the gates the reference's genome
renders (quantum_gate.py:96-102, :157-165).
"""

from __future__ import annotations

from queasars_tpu_torch.genome.gates import EVQEGateType
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.parameter_order import get_parameter_order, layer_slot_order


def individual_to_qasm(
    individual: EVQEIndividual,
    include_measurements: bool = False,
) -> str:
    """Render an individual's circuit as an OpenQASM 2.0 program.

    :param include_measurements: append a full measure_all block (the
        reference's final sampling step measures all qubits,
        evolving_ansatz_minimum_eigensolver.py:445)
    """
    n = individual.n_qubits
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{n}];",
    ]
    if include_measurements:
        lines.append(f"creg c[{n}];")

    mode = get_parameter_order()
    cursor = 0
    params = individual.parameter_values
    for layer in individual.layers:
        parameterized = [q for q, gate in enumerate(layer.gates) if gate.n_parameters() > 0]
        # gather this layer's (theta, phi, lambda) per qubit following the
        # active flat-parameter ordering mode
        triplets: dict[int, list[float]] = {q: [0.0, 0.0, 0.0] for q in parameterized}
        for q, a in layer_slot_order(parameterized, mode):
            triplets[q][a] = params[cursor]
            cursor += 1
        for q, gate in enumerate(layer.gates):
            gate_type = gate.gate_type()
            if gate_type == EVQEGateType.ROTATION:
                theta, phi, lam = triplets[q]
                lines.append(f"u3({theta!r},{phi!r},{lam!r}) q[{q}];")
            elif gate_type == EVQEGateType.CONTROLLED_ROTATION:
                theta, phi, lam = triplets[q]
                control = gate.control_qubit_index
                lines.append(f"cu3({theta!r},{phi!r},{lam!r}) q[{control}],q[{q}];")
            # IDENTITY / CONTROL slots emit nothing

    if include_measurements:
        for q in range(n):
            lines.append(f"measure q[{q}] -> c[{q}];")
    return "\n".join(lines) + "\n"
