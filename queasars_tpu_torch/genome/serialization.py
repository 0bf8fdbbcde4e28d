"""JSON (de)serialization for genomes and populations.

Counterpart of ``queasars_tpu/genome/serialization.py``: the same keys, so
one population encodes to the same JSON text in both packages and each
decodes the other's.  Wire-compatible with the reference codecs
(queasars/minimum_eigensolvers/evqe/quantum_circuit/serialization.py:16-140
and evqe/serialization.py:15-154): identical sentinel keys and gate-type
tags so genome JSON round-trips across implementations.

(Parameter values serialize in this package's canonical order — see the
ordering note in genome/__init__.py.)
"""

from __future__ import annotations

from json import JSONDecoder, JSONEncoder
from typing import Any

from queasars_tpu_torch.genome.circuit_layer import EVQECircuitLayer
from queasars_tpu_torch.genome.gates import (
    ControlGate,
    ControlledRotationGate,
    IdentityGate,
    RotationGate,
)
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.population import EVQEPopulation


class EVQECircuitLayerEncoder(JSONEncoder):
    """Serializes layers and the four gate kinds
    (reference key scheme: quantum_circuit/serialization.py:27-59)."""

    def default(self, o: Any):
        if isinstance(o, EVQECircuitLayer):
            return {
                "evqe_circuit_layer_n_qubits": o.n_qubits,
                "evqe_circuit_layer_gates": [self.default(gate) for gate in o.gates],
            }
        if isinstance(o, IdentityGate):
            return {"evqe_gate_type": "identity", "evqe_qubit_index": o.qubit_index}
        if isinstance(o, RotationGate):
            return {"evqe_gate_type": "rotation", "evqe_qubit_index": o.qubit_index}
        if isinstance(o, ControlGate):
            return {
                "evqe_gate_type": "control",
                "evqe_qubit_index": o.qubit_index,
                "evqe_controlled_qubit_index": o.controlled_qubit_index,
            }
        if isinstance(o, ControlledRotationGate):
            return {
                "evqe_gate_type": "controlled_rotation",
                "evqe_qubit_index": o.qubit_index,
                "evqe_control_qubit_index": o.control_qubit_index,
            }
        return super().default(o)

    @staticmethod
    def serializable_types() -> set[type]:
        return {EVQECircuitLayer, IdentityGate, RotationGate, ControlGate, ControlledRotationGate}


class EVQECircuitLayerDecoder(JSONDecoder):
    """Inverse of :class:`EVQECircuitLayerEncoder`
    (reference: quantum_circuit/serialization.py:76-140)."""

    def __init__(self, *args, **kwargs):
        super().__init__(object_hook=self.object_hook, *args, **kwargs)

    @staticmethod
    def identifying_keys() -> set[str]:
        return {
            "evqe_circuit_layer_n_qubits",
            "evqe_circuit_layer_gates",
            "evqe_gate_type",
            "evqe_qubit_index",
            "evqe_controlled_qubit_index",
            "evqe_control_qubit_index",
        }

    def object_hook(self, object_dict):
        if "evqe_circuit_layer_n_qubits" in object_dict:
            return EVQECircuitLayer(
                n_qubits=object_dict["evqe_circuit_layer_n_qubits"],
                gates=tuple(object_dict["evqe_circuit_layer_gates"]),
            )
        if "evqe_gate_type" in object_dict:
            return self.parse_evqe_gate(object_dict)
        return object_dict

    @staticmethod
    def parse_evqe_gate(object_dict):
        gate_type = object_dict["evqe_gate_type"]
        if gate_type == "identity":
            return IdentityGate(qubit_index=object_dict["evqe_qubit_index"])
        if gate_type == "rotation":
            return RotationGate(qubit_index=object_dict["evqe_qubit_index"])
        if gate_type == "control":
            return ControlGate(
                qubit_index=object_dict["evqe_qubit_index"],
                controlled_qubit_index=object_dict["evqe_controlled_qubit_index"],
            )
        if gate_type == "controlled_rotation":
            return ControlledRotationGate(
                qubit_index=object_dict["evqe_qubit_index"],
                control_qubit_index=object_dict["evqe_control_qubit_index"],
            )
        raise ValueError(f"cannot decode gate record (unrecognized tag): {object_dict}!")


class EVQEPopulationJSONEncoder(JSONEncoder):
    """Serializes individuals and populations (with speciation state)
    (reference key scheme: evqe/serialization.py:15-77)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._layer_encoder = EVQECircuitLayerEncoder(*args, **kwargs)

    def default(self, o: Any):
        if any(isinstance(o, t) for t in EVQECircuitLayerEncoder.serializable_types()):
            return self._layer_encoder.default(o)
        if isinstance(o, EVQEIndividual):
            return {
                "evqe_individual_n_qubits": o.n_qubits,
                "evqe_individual_layers": [self.default(layer) for layer in o.layers],
                "evqe_individual_parameter_values": list(o.parameter_values),
            }
        if isinstance(o, EVQEPopulation):
            representatives = (
                None
                if o.species_representatives is None
                else [self.default(ind) for ind in o.species_representatives]
            )
            members = (
                None
                if o.species_members is None
                else [[self.default(ind), idxs] for ind, idxs in o.species_members.items()]
            )
            membership = (
                None
                if o.species_membership is None
                else [[idx, self.default(rep)] for idx, rep in o.species_membership.items()]
            )
            return {
                "evqe_population_individuals": [self.default(ind) for ind in o.individuals],
                "evqe_population_species_representatives": representatives,
                "evqe_population_species_members": members,
                "evqe_population_species_membership": membership,
            }
        return super().default(o)

    @staticmethod
    def serializable_types() -> set[type]:
        return {EVQEIndividual, EVQEPopulation}


def load_population(path: str) -> EVQEPopulation:
    """Load a checkpointed population JSON — either a population-only file
    or the population embedded in a full solver-state checkpoint (see
    solver/checkpoint.py; for exact-trajectory resume prefer
    ``resume_from_checkpoint=`` which restores RNGs and counters too)."""
    import json as _json

    with open(path) as fh:
        decoded = _json.load(fh, cls=EVQEPopulationJSONDecoder)
    if isinstance(decoded, EVQEPopulation):
        return decoded
    if isinstance(decoded, dict) and isinstance(decoded.get("population"), EVQEPopulation):
        return decoded["population"]
    raise ValueError(f"no population found in checkpoint file {path!r}")


class EVQEPopulationJSONDecoder(JSONDecoder):
    """Inverse of :class:`EVQEPopulationJSONEncoder`
    (reference: evqe/serialization.py:79-154)."""

    def __init__(self, *args, **kwargs):
        super().__init__(object_hook=self.object_hook, *args, **kwargs)
        self._layer_decoder_hook = EVQECircuitLayerDecoder().object_hook

    @staticmethod
    def identifying_keys() -> set[str]:
        return {
            "evqe_individual_n_qubits",
            "evqe_individual_layers",
            "evqe_individual_parameter_values",
            "evqe_population_individuals",
            "evqe_population_species_representatives",
            "evqe_population_species_members",
            "evqe_population_species_membership",
        } | EVQECircuitLayerDecoder.identifying_keys()

    def object_hook(self, object_dict):
        if "evqe_individual_n_qubits" in object_dict:
            return EVQEIndividual(
                n_qubits=object_dict["evqe_individual_n_qubits"],
                layers=tuple(object_dict["evqe_individual_layers"]),
                parameter_values=tuple(object_dict["evqe_individual_parameter_values"]),
            )
        if "evqe_population_individuals" in object_dict:
            raw_members = object_dict["evqe_population_species_members"]
            members = (
                None
                if raw_members is None
                else {rep: list(idxs) for rep, idxs in raw_members}
            )
            raw_membership = object_dict["evqe_population_species_membership"]
            membership = (
                None
                if raw_membership is None
                else {int(idx): rep for idx, rep in raw_membership}
            )
            representatives = object_dict["evqe_population_species_representatives"]
            return EVQEPopulation(
                individuals=tuple(object_dict["evqe_population_individuals"]),
                species_representatives=(
                    None if representatives is None else list(representatives)
                ),
                species_members=members,
                species_membership=membership,
            )
        return self._layer_decoder_hook(object_dict)


# ---------------------------------------------------------------------------
# QNEAT genomes (no reference counterpart — QNEAT is future work there;
# the key scheme mirrors the EVQE sentinel-key convention)
# ---------------------------------------------------------------------------


class QNEATPopulationJSONEncoder(JSONEncoder):
    """Serializes QNEAT genes, individuals and populations."""

    def default(self, o: Any):
        from queasars_tpu_torch.genome.qneat import QNEATGene, QNEATIndividual, QNEATPopulation

        if isinstance(o, QNEATGene):
            return {
                "qneat_gene_innovation": o.innovation,
                "qneat_gene_target": o.target,
                "qneat_gene_control": o.control,
            }
        if isinstance(o, QNEATIndividual):
            return {
                "qneat_individual_n_qubits": o.n_qubits,
                "qneat_individual_genes": [self.default(g) for g in o.genes],
                "qneat_individual_angles": list(o.angles),
            }
        if isinstance(o, QNEATPopulation):
            return {
                "qneat_population_individuals": [self.default(i) for i in o.individuals],
                "qneat_population_next_innovation": o.next_innovation,
                "qneat_population_species_representatives": (
                    None
                    if o.species_representatives is None
                    else [self.default(i) for i in o.species_representatives]
                ),
                "qneat_population_elite_flags": (
                    None if o.elite_flags is None else list(o.elite_flags)
                ),
            }
        return super().default(o)


class QNEATPopulationJSONDecoder(JSONDecoder):
    """Round-trip decoder for the QNEAT codec above."""

    def __init__(self, *args, **kwargs):
        super().__init__(object_hook=self.object_hook, *args, **kwargs)

    def object_hook(self, object_dict):
        from queasars_tpu_torch.genome.qneat import QNEATGene, QNEATIndividual, QNEATPopulation

        if "qneat_gene_innovation" in object_dict:
            return QNEATGene(
                innovation=object_dict["qneat_gene_innovation"],
                target=object_dict["qneat_gene_target"],
                control=object_dict["qneat_gene_control"],
            )
        if "qneat_individual_n_qubits" in object_dict:
            return QNEATIndividual(
                n_qubits=object_dict["qneat_individual_n_qubits"],
                genes=tuple(object_dict["qneat_individual_genes"]),
                angles=tuple(object_dict["qneat_individual_angles"]),
            )
        if "qneat_population_individuals" in object_dict:
            representatives = object_dict["qneat_population_species_representatives"]
            elite_flags = object_dict["qneat_population_elite_flags"]
            return QNEATPopulation(
                individuals=tuple(object_dict["qneat_population_individuals"]),
                next_innovation=object_dict["qneat_population_next_innovation"],
                species_representatives=(
                    None if representatives is None else tuple(representatives)
                ),
                elite_flags=None if elite_flags is None else tuple(elite_flags),
            )
        return object_dict
