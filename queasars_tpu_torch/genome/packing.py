"""Genome -> device tensor packing.

The bridge between the host genome objects and the engine: a whole
population is lowered to fixed-shape arrays (padded to a small
bucketed L_max, so that repeated packing yields few distinct shapes —
the reference's analog is
rebuilding/re-transpiling Qiskit circuits per evaluation,
individual.py:288-322, which this replaces entirely).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from queasars_tpu_torch.genome.gates import ControlledRotationGate
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.parameter_order import get_parameter_order, layer_slot_order


def _layer_bucket(value: int) -> int:
    """Pad the layer count to a small bucket: exact up to 4, then multiples
    of 2.  Padded layers are masked out but still *computed* by the scan,
    so tight buckets matter more than minimizing recompiles (which are
    cached per bucket for the process lifetime anyway)."""
    if value <= 4:
        return value
    return -(-value // 2) * 2


@dataclass
class PackedPopulation:
    """Fixed-shape tensor encoding of a population of genomes.

    Shapes: P individuals, L layers (padded), n qubits.

    - ``gate_types`` [P, L, n] int32 — EVQEGateType codes
    - ``controls`` [P, L, n] int32 — control qubit per CROT slot, else -1
    - ``angles`` [P, L, n, 3] float32 — (theta, phi, lambda) per slot
    - ``layer_mask`` [P, L] bool — real vs padding layers
    - ``param_mask`` [P, L, n] bool — slots contributing parameters
    - ``n_params`` [P] int32 — flat parameter count per individual
    """

    gate_types: np.ndarray
    controls: np.ndarray
    angles: np.ndarray
    layer_mask: np.ndarray
    param_mask: np.ndarray
    n_params: np.ndarray
    n_qubits: int
    #: flat-vector interpretation used at pack time ("canonical"/"qiskit",
    #: see genome/parameter_order.py) — all flat<->tensor round trips on
    #: this instance use the same mode
    parameter_order: str = "canonical"
    #: the host genomes this packing was built from (set by :meth:`pack`) —
    #: external-backend evaluators (sim/external.py) hand these to the
    #: user's ``evaluate_circuits`` callback as the "circuits"
    individuals: Optional[tuple[EVQEIndividual, ...]] = None

    @property
    def n_individuals(self) -> int:
        return int(self.gate_types.shape[0])

    @property
    def max_layers(self) -> int:
        return int(self.gate_types.shape[1])

    @staticmethod
    def pack(
        individuals: Sequence[EVQEIndividual],
        min_layers: Optional[int] = None,
        parameter_order: Optional[str] = None,
    ) -> "PackedPopulation":
        """Pack genomes into padded tensors.

        L_max = layer bucket >= the longest individual (>= min_layers if
        given) so repeated packing hits a small set of shapes.

        :param parameter_order: flat-vector interpretation
            ("canonical"/"qiskit", see genome/parameter_order.py); None =
            the process-global mode
        """
        if len(individuals) == 0:
            raise ValueError("cannot pack an empty population")
        order = parameter_order if parameter_order is not None else get_parameter_order()
        n_qubits = individuals[0].n_qubits
        longest = max(len(ind.layers) for ind in individuals)
        l_max = _layer_bucket(max(longest, min_layers or 1))
        pop = len(individuals)

        gate_types = np.zeros((pop, l_max, n_qubits), dtype=np.int32)
        controls = np.full((pop, l_max, n_qubits), -1, dtype=np.int32)
        angles = np.zeros((pop, l_max, n_qubits, 3), dtype=np.float32)
        layer_mask = np.zeros((pop, l_max), dtype=bool)
        param_mask = np.zeros((pop, l_max, n_qubits), dtype=bool)
        n_params = np.zeros(pop, dtype=np.int32)

        for p, individual in enumerate(individuals):
            if individual.n_qubits != n_qubits:
                raise ValueError("all individuals must share the same qubit count")
            flat = individual.parameter_values
            cursor = 0
            for l, layer in enumerate(individual.layers):
                layer_mask[p, l] = True
                parameterized: list[int] = []
                for q, gate in enumerate(layer.gates):
                    gate_types[p, l, q] = gate.gate_type().value
                    if isinstance(gate, ControlledRotationGate):
                        controls[p, l, q] = gate.control_qubit_index
                    if gate.n_parameters() > 0:
                        param_mask[p, l, q] = True
                        parameterized.append(q)
                for q, a in layer_slot_order(parameterized, order):
                    angles[p, l, q, a] = flat[cursor]
                    cursor += 1
            n_params[p] = cursor

        return PackedPopulation(
            gate_types=gate_types,
            controls=controls,
            angles=angles,
            layer_mask=layer_mask,
            param_mask=param_mask,
            n_params=n_params,
            n_qubits=n_qubits,
            parameter_order=order,
            individuals=tuple(individuals),
        )

    def _layer_parameterized_qubits(self, individual_index: int, layer: int) -> list[int]:
        mask = self.param_mask[individual_index, layer]
        return [q for q in range(self.n_qubits) if mask[q]]

    def angles_to_flat(self, individual_index: int, angles: np.ndarray) -> tuple[float, ...]:
        """Extract one individual's flat parameter vector from an angle
        tensor [L, n, 3] (inverse of packing, in this instance's
        parameter order)."""
        values: list[float] = []
        for l in range(self.max_layers):
            if not self.layer_mask[individual_index, l]:
                continue
            slots = layer_slot_order(
                self._layer_parameterized_qubits(individual_index, l), self.parameter_order
            )
            values.extend(float(angles[l, q, a]) for q, a in slots)
        return tuple(values)

    def param_coordinates(self, individual_index: int) -> np.ndarray:
        """[n_params, 3] array of (layer, qubit, angle_index) coordinates in
        flat order for one individual (this instance's parameter order —
        the order batched NFT cycles through)."""
        coords: list[tuple[int, int, int]] = []
        for l in range(self.max_layers):
            if not self.layer_mask[individual_index, l]:
                continue
            slots = layer_slot_order(
                self._layer_parameterized_qubits(individual_index, l), self.parameter_order
            )
            coords.extend((l, q, a) for q, a in slots)
        return np.asarray(coords, dtype=np.int32).reshape(-1, 3)

    def layer_param_coordinates(self, individual_index: int, layer_id: int) -> np.ndarray:
        """[k, 3] coordinates of one layer's parameters in flat order
        (layer_id may be negative, counting real layers from the end)."""
        real_layers = int(self.layer_mask[individual_index].sum())
        layer_id = layer_id % real_layers
        slots = layer_slot_order(
            self._layer_parameterized_qubits(individual_index, layer_id), self.parameter_order
        )
        coords = [(layer_id, q, a) for q, a in slots]
        return np.asarray(coords, dtype=np.int32).reshape(-1, 3)


def unpack_individual(
    packed: PackedPopulation, individual_index: int, template: EVQEIndividual
) -> EVQEIndividual:
    """Rebuild a host individual from (possibly optimizer-updated) packed
    angles, keeping the template's layer structure."""
    flat = packed.angles_to_flat(individual_index, packed.angles[individual_index])
    return EVQEIndividual.change_parameter_values(template, flat)
