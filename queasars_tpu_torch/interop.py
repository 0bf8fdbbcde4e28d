"""Carry state from the JAX package into the port.

The port never imports the JAX package; what crosses over is plain data:
numpy arrays and built-in containers.  This module turns that data into the
port's objects:

- the ``PackedPopulation`` fields (``gate_types``, ``controls``, ``angles``,
  ``layer_mask``, ...) into a port :class:`PackedPopulation` or into device
  tensors;
- a diagonal energy table into a float32 device tensor;
- an individual's genome in its plain-data form (:func:`individual_to_plain`)
  into a port :class:`EVQEIndividual`;
- a kron-fold pipeline's ten arrays (the JAX package's ``FoldPipeline``
  fields, in order) into a port :class:`FoldPipeline`;
- a sampler evaluator's shot-stream state (its key and round counter,
  :func:`sampler_state_to_plain`) into a port evaluator, so that both
  draw the same keys from then on;
- a Pauli sum's plain ``(z, x, coeffs)`` arrays into a port
  :class:`PauliSum`, and grouped-measurement operands (the JAX package's
  ``grouped_operands`` tuple) into port :class:`GroupedOperands`;
- a compacted-gate list's arrays (the JAX package's ``CompactGates``
  fields) into a port :class:`CompactGates`.

:func:`individual_to_plain` reads only attributes that the JAX package's
genome classes share with the port's, so it also turns a JAX individual into
plain data.
"""

from __future__ import annotations

import numpy as np
import torch

from queasars_tpu_torch.genome.circuit_layer import EVQECircuitLayer
from queasars_tpu_torch.genome.gates import (
    ControlGate,
    ControlledRotationGate,
    EVQEGateType,
    IdentityGate,
    RotationGate,
)
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.sim.compact_kernels import CompactGates
from queasars_tpu_torch.sim.fold_pipeline import FoldPipeline
from queasars_tpu_torch.sim.grouped_sampling import GroupedOperands, make_grouped_operands
from queasars_tpu_torch.utils.device import resolve_device


def packed_population_from_numpy(
    gate_types: np.ndarray,
    controls: np.ndarray,
    angles: np.ndarray,
    layer_mask: np.ndarray,
    param_mask: np.ndarray,
    n_params: np.ndarray,
    n_qubits: int,
    parameter_order: str = "canonical",
) -> PackedPopulation:
    """A port PackedPopulation from the JAX package's packed fields."""
    return PackedPopulation(
        gate_types=np.asarray(gate_types, dtype=np.int32),
        controls=np.asarray(controls, dtype=np.int32),
        angles=np.asarray(angles, dtype=np.float32),
        layer_mask=np.asarray(layer_mask, dtype=bool),
        param_mask=np.asarray(param_mask, dtype=bool),
        n_params=np.asarray(n_params, dtype=np.int32),
        n_qubits=int(n_qubits),
        parameter_order=parameter_order,
    )


def genome_tensors_from_numpy(gate_types, controls, angles, layer_mask, device="cpu") -> tuple:
    """(gate_types int32, controls int32, angles float32, layer_mask bool)
    device tensors in the kernels' contract."""
    return (
        torch.as_tensor(np.asarray(gate_types), dtype=torch.int32, device=device),
        torch.as_tensor(np.asarray(controls), dtype=torch.int32, device=device),
        torch.as_tensor(np.asarray(angles), dtype=torch.float32, device=device),
        torch.as_tensor(np.asarray(layer_mask), dtype=torch.bool, device=device),
    )


def energy_table_from_numpy(table: np.ndarray, device="cpu") -> torch.Tensor:
    """A [2^n] diagonal energy table as a float32 device tensor."""
    return torch.as_tensor(np.asarray(table), dtype=torch.float32, device=device)


def individual_to_plain(individual) -> dict:
    """Plain-data genome: ``{"n_qubits", "layers", "parameter_values"}``;
    each layer is a list of ``[gate_code, partner]`` per qubit, the partner
    being the other qubit of a CU3 pair (-1 elsewhere)."""
    layers = []
    for layer in individual.layers:
        slots = []
        for gate in layer.gates:
            partner = getattr(
                gate, "control_qubit_index", getattr(gate, "controlled_qubit_index", -1)
            )
            slots.append([int(gate.gate_type().value), int(partner)])
        layers.append(slots)
    return {
        "n_qubits": int(individual.n_qubits),
        "layers": layers,
        "parameter_values": [float(v) for v in individual.parameter_values],
    }


def _gate(q: int, code: int, partner: int):
    kind = EVQEGateType(code)
    if kind == EVQEGateType.IDENTITY:
        return IdentityGate(qubit_index=q)
    if kind == EVQEGateType.ROTATION:
        return RotationGate(qubit_index=q)
    if kind == EVQEGateType.CONTROL:
        return ControlGate(qubit_index=q, controlled_qubit_index=partner)
    return ControlledRotationGate(qubit_index=q, control_qubit_index=partner)


def individual_from_plain(data: dict) -> EVQEIndividual:
    """A port EVQEIndividual from :func:`individual_to_plain` data."""
    n_qubits = int(data["n_qubits"])
    layers = tuple(
        EVQECircuitLayer(
            n_qubits=n_qubits,
            gates=tuple(_gate(q, code, partner) for q, (code, partner) in enumerate(slots)),
        )
        for slots in data["layers"]
    )
    return EVQEIndividual(
        n_qubits=n_qubits,
        layers=layers,
        parameter_values=tuple(float(v) for v in data["parameter_values"]),
    )


def _shot_stream_owner(evaluator):
    """The evaluator holding the shot stream: an estimator's inner
    precision sampler, else the evaluator itself."""
    inner = getattr(evaluator, "_precision_sampler", None)
    return evaluator if inner is None else inner


def sampler_state_to_plain(evaluator) -> dict:
    """A sampler evaluator's shot-stream state, ``{"key": [hi, lo],
    "counter": c}``: its base key (``PRNGKey(seed)``) and the number of
    evaluation rounds drawn.  Reads only the attributes the JAX package's
    evaluators share with the port's (also an estimator with precision)."""
    owner = _shot_stream_owner(evaluator)
    key = np.asarray(owner._key).astype(np.int64).reshape(2)
    return {"key": [int(key[0]), int(key[1])], "counter": int(owner._counter)}


def sampler_state_from_plain(evaluator, data: dict) -> None:
    """Set a port sampler evaluator's (or precision estimator's) shot
    stream to :func:`sampler_state_to_plain` data: its next round draws
    the keys the source evaluator's next round draws."""
    owner = _shot_stream_owner(evaluator)
    owner._key = torch.tensor([int(v) for v in data["key"]], dtype=torch.int64)
    owner._counter = int(data["counter"])


def fold_pipeline_from_numpy(arrays, device="cpu") -> FoldPipeline:
    """A port :class:`FoldPipeline` on ``device`` from the ten pipeline
    arrays in field order (the JAX package's ``FoldPipeline`` itself, or
    ``tuple(pipeline)``).  Phases and factors become float32, every other
    field int32."""
    arrays = list(arrays)
    if len(arrays) != len(FoldPipeline._fields):
        raise ValueError(f"a fold pipeline has {len(FoldPipeline._fields)} arrays, got {len(arrays)}")
    fields = {}
    for name, array in zip(FoldPipeline._fields, arrays):
        dtype = torch.float32 if name in ("factors", "diag_phase", "abs_phase") else torch.int32
        fields[name] = torch.as_tensor(np.array(array), dtype=dtype, device=device).contiguous()
    return FoldPipeline(**fields)


def pauli_sum_from_numpy(n_qubits: int, z, x, coeffs) -> PauliSum:
    """A port :class:`PauliSum` from the packed arrays of one (the JAX
    package's ``z``, ``x`` uint64 word masks [K, words] and complex
    ``coeffs`` [K])."""
    return PauliSum(
        int(n_qubits),
        np.asarray(coeffs, dtype=np.complex128),
        np.asarray(z, dtype=np.uint64),
        np.asarray(x, dtype=np.uint64),
    )


def grouped_operands_from_numpy(rot_types, rot_angles, tables, const, device="cpu") -> GroupedOperands:
    """Port :class:`GroupedOperands` on ``device`` from grouped-measurement
    operands: rotation layers [G, n] / [G, n, 3], rotated-basis tables
    [G, 2^n] and the identity constant (the JAX package's
    ``grouped_operands`` tuple, as numpy)."""
    return make_grouped_operands(
        np.asarray(rot_types), np.asarray(rot_angles), np.asarray(tables),
        np.float32(np.asarray(const)), device,
    )


def compact_gates_from_numpy(
    qubits, controls, angle_index, boundaries, n_qubits: int, n_layers: int, device=None
) -> CompactGates:
    """A port :class:`CompactGates` on ``device`` (the card unless the caller
    asks for the CPU) from the JAX package's ``CompactGates`` fields; the
    largest count is read from ``boundaries`` on the host."""
    device = resolve_device(device)
    arrays = [np.asarray(a, dtype=np.int32) for a in (qubits, controls, angle_index, boundaries)]
    return CompactGates(
        *(torch.as_tensor(a, device=device) for a in arrays),
        n_qubits=int(n_qubits), n_layers=int(n_layers),
        max_count=int(arrays[3][:, -1].max(initial=0)),
    )
