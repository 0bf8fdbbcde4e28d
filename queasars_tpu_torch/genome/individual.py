"""Immutable EVQE genome individuals.

Behavioral port of
queasars/minimum_eigensolvers/evqe/evolutionary_algorithm/individual.py:
17-363: genome = (n_qubits, layer tuple, flat parameter tuple), all
structural edits return new individuals, genetic distance =
ceil(mean layer count) - shared prefix layers.

Instead of building (partially) parameterized Qiskit circuits
(individual.py:288-322), individuals expose their tensor encoding through
:mod:`queasars_tpu_torch.genome.packing`; "partially parameterized" becomes a set
of free-parameter coordinates handed to the batched optimizer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import ceil, pi
from random import Random
from types import MappingProxyType
from typing import Optional

from queasars_tpu_torch.genome.circuit_layer import EVQECircuitLayer
from queasars_tpu_torch.utils.random import new_random_seed


class EVQEIndividualException(Exception):
    """Raised for invalid individual operations (reference: individual.py:362-363)."""


@dataclass(frozen=True)
class EVQEIndividual:
    """A genome: layered circuit structure + flat parameter values
    (reference: individual.py:17-32).

    Parameter layout: layers ascending, then qubits ascending, then
    (theta, phi, lambda) per parameterized gate.
    """

    n_qubits: int
    layers: tuple[EVQECircuitLayer, ...]
    parameter_values: tuple[float, ...]

    _layer_parameter_indices: MappingProxyType = field(
        init=False, repr=False, compare=False, default=None
    )

    # ------------------------------------------------------------------
    # factories / edits (all reference-faithful in Random call order)
    # ------------------------------------------------------------------

    @staticmethod
    def random_individual(
        n_qubits: int,
        n_layers: int,
        randomize_parameter_values: bool,
        random_seed: Optional[int] = None,
    ) -> "EVQEIndividual":
        """Random individual; parameters uniform in [0, 2*pi) or zero
        (reference: individual.py:34-65 — one child seed per layer, then
        one ``random()`` per parameter)."""
        rng = Random(random_seed)
        layers: list[EVQECircuitLayer] = []
        layer: Optional[EVQECircuitLayer] = None
        for _ in range(n_layers):
            layer = EVQECircuitLayer.random_layer(
                n_qubits=n_qubits, previous_layer=layer, random_seed=new_random_seed(rng)
            )
            layers.append(layer)
        n_parameters = sum(layer.n_parameters for layer in layers)
        if randomize_parameter_values:
            parameter_values = tuple(2 * pi * rng.random() for _ in range(n_parameters))
        else:
            parameter_values = (0.0,) * n_parameters
        return EVQEIndividual(n_qubits=n_qubits, layers=tuple(layers), parameter_values=parameter_values)

    @staticmethod
    def change_parameter_values(
        individual: "EVQEIndividual", parameter_values: tuple[float, ...]
    ) -> "EVQEIndividual":
        """New individual with the same structure but new parameters
        (reference: individual.py:67-86)."""
        if len(parameter_values) != sum(layer.n_parameters for layer in individual.layers):
            raise EVQEIndividualException(
                "parameter_values length disagrees with the individual's parameter count"
            )
        return EVQEIndividual(
            n_qubits=individual.n_qubits,
            layers=individual.layers,
            parameter_values=tuple(parameter_values),
        )

    @staticmethod
    def change_layer_parameter_values(
        individual: "EVQEIndividual", layer_id: int, parameter_values: tuple[float, ...]
    ) -> "EVQEIndividual":
        """New individual with one layer's parameters replaced; negative
        layer_id counts from the end (reference: individual.py:88-130)."""
        layer_id = layer_id % len(individual.layers)
        indices = individual.layer_parameter_indices[layer_id]
        if len(parameter_values) != len(indices):
            raise EVQEIndividualException(
                "parameter_values length disagrees with the layer's parameter count"
            )
        new_values = list(individual.parameter_values)
        for offset, index in enumerate(indices):
            new_values[index] = parameter_values[offset]
        return EVQEIndividual(
            n_qubits=individual.n_qubits,
            layers=individual.layers,
            parameter_values=tuple(new_values),
        )

    @staticmethod
    def add_random_layers(
        individual: "EVQEIndividual",
        n_layers: int,
        randomize_parameter_values: bool,
        random_seed: Optional[int] = None,
    ) -> "EVQEIndividual":
        """Append random layers (constrained by the current last layer);
        their parameters start random or at 0 (reference: individual.py:
        132-183 — same child-seed-per-layer, then parameter draws)."""
        if n_layers < 1:
            raise EVQEIndividualException("n_layers must be >= 1")
        rng = Random(random_seed)
        new_layers: list[EVQECircuitLayer] = []
        previous = individual.layers[-1]
        for _ in range(n_layers):
            layer = EVQECircuitLayer.random_layer(
                n_qubits=individual.layers[0].n_qubits,
                random_seed=new_random_seed(rng),
                previous_layer=previous,
            )
            new_layers.append(layer)
            previous = layer
        n_new = sum(layer.n_parameters for layer in new_layers)
        if randomize_parameter_values:
            new_values = tuple(2 * pi * rng.random() for _ in range(n_new))
        else:
            new_values = (0.0,) * n_new
        return EVQEIndividual(
            n_qubits=individual.n_qubits,
            layers=(*individual.layers, *new_layers),
            parameter_values=(*individual.parameter_values, *new_values),
        )

    @staticmethod
    def remove_layers(individual: "EVQEIndividual", n_layers: int) -> "EVQEIndividual":
        """Drop the last ``n_layers`` layers; at least one must remain
        (reference: individual.py:185-215)."""
        if not 0 < n_layers:
            raise EVQEIndividualException("n_layers must be >= 1")
        if not n_layers < len(individual.layers):
            raise EVQEIndividualException(
                "cannot remove that many layers: an individual keeps at least one layer"
            )
        keep = len(individual.layers) - n_layers
        cut = individual.layer_parameter_indices[keep][0] if individual.layers[keep].n_parameters else None
        if cut is None:
            # the first removed layer has no parameters; cut at the end of
            # the kept layers' parameters
            cut = sum(layer.n_parameters for layer in individual.layers[:keep])
        return EVQEIndividual(
            n_qubits=individual.n_qubits,
            layers=individual.layers[:keep],
            parameter_values=individual.parameter_values[:cut],
        )

    @staticmethod
    def get_genetic_distance(individual_1: "EVQEIndividual", individual_2: "EVQEIndividual") -> int:
        """ceil(mean layer count) minus shared prefix-position layers
        (reference: individual.py:217-237)."""
        n_1, n_2 = len(individual_1.layers), len(individual_2.layers)
        n_all = ceil(0.5 * (n_1 + n_2))
        n_shared = sum(
            1
            for i in range(min(n_1, n_2))
            if individual_1.layers[i] == individual_2.layers[i]
        )
        return n_all - n_shared

    # ------------------------------------------------------------------
    # structure queries
    # ------------------------------------------------------------------

    def __post_init__(self) -> None:
        if not self.is_valid():
            raise EVQEIndividualException("genome construction produced an inconsistent individual")
        layer_parameter_indices: dict[int, tuple[int, ...]] = {}
        offset = 0
        for i, layer in enumerate(self.layers):
            layer_parameter_indices[i] = tuple(range(offset, offset + layer.n_parameters))
            offset += layer.n_parameters
        object.__setattr__(self, "_layer_parameter_indices", MappingProxyType(layer_parameter_indices))

    def is_valid(self) -> bool:
        """>=1 layer, all layers valid with matching qubit count, parameter
        count matches (reference: individual.py:252-272)."""
        if len(self.layers) <= 0:
            return False
        for layer in self.layers:
            if (not layer.is_valid()) or layer.n_qubits != self.n_qubits:
                return False
        if len(self.parameter_values) != sum(layer.n_parameters for layer in self.layers):
            return False
        return True

    @property
    def layer_parameter_indices(self) -> MappingProxyType:
        """layer index -> tuple of flat parameter indices."""
        return self._layer_parameter_indices

    def get_parameter_values(self) -> tuple[float, ...]:
        return self.parameter_values

    def get_layer_parameter_values(self, layer_id: int) -> tuple[float, ...]:
        """One layer's slice of the flat parameters (reference:
        individual.py:327-345)."""
        layer_id = layer_id % len(self.layers)
        indices = self.layer_parameter_indices[layer_id]
        return tuple(self.parameter_values[i] for i in indices)

    def get_n_controlled_gates(self) -> int:
        """Total CU3 pairs across layers (reference: individual.py:347-353)."""
        return sum(layer.n_controlled_gates for layer in self.layers)

    def __eq__(self, other):
        return hash(self) == hash(other)

    def __hash__(self):
        return hash((self.n_qubits, self.layers, self.parameter_values))
