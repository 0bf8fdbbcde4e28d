"""EVQE circuit genomes: host-side objects + tensor packing.

Host individuals are immutable dataclasses (needed for speciation hashing
and the reference's exact ``random.Random`` call order);
:mod:`~queasars_tpu_torch.genome.packing` lowers a population to the
fixed-shape tensors the engine consumes.
"""

from queasars_tpu_torch.genome.gates import (
    EVQEGateType,
    EVQEGate,
    IdentityGate,
    RotationGate,
    ControlGate,
    ControlledGate,
    ControlledRotationGate,
)
from queasars_tpu_torch.genome.circuit_layer import EVQECircuitLayer, EVQECircuitLayerException
from queasars_tpu_torch.genome.individual import EVQEIndividual, EVQEIndividualException
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.genome.parameter_order import (
    get_parameter_order,
    parameter_order,
    set_parameter_order,
)
from queasars_tpu_torch.genome.qneat import QNEATGene, QNEATIndividual, QNEATPopulation

__all__ = [
    "get_parameter_order",
    "parameter_order",
    "set_parameter_order",
    "EVQEGateType",
    "EVQEGate",
    "IdentityGate",
    "RotationGate",
    "ControlGate",
    "ControlledGate",
    "ControlledRotationGate",
    "EVQECircuitLayer",
    "EVQECircuitLayerException",
    "EVQEIndividual",
    "EVQEIndividualException",
    "EVQEPopulation",
    "PackedPopulation",
    "QNEATGene",
    "QNEATIndividual",
    "QNEATPopulation",
]
