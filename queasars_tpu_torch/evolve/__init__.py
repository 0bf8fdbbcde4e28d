"""Evolutionary algorithm: contracts and the EVQE operator pipeline.

Host-side orchestration (Bernoulli draws, speciation dicts, selection RNG)
keeps the reference's exact ``random.Random`` call order; circuit
evaluation and parameter optimization run batched on the device.
"""

from queasars_tpu_torch.evolve.base import (
    BaseEvolutionaryOperator,
    BasePopulationEvaluationResult,
    OperatorContext,
)
from queasars_tpu_torch.evolve.mutation import (
    EVQELastLayerParameterSearch,
    EVQEParameterSearch,
    EVQETopologicalSearch,
    EVQELayerRemoval,
)
from queasars_tpu_torch.evolve.multiobjective import (
    MultiObjectiveEVQESelection,
    non_dominated_sort,
    crowding_distance,
    pareto_front,
)
from queasars_tpu_torch.evolve.qneat import (
    QNEATAddGate,
    QNEATAngleMutation,
    QNEATParameterPolish,
    QNEATSpeciationSelection,
)
from queasars_tpu_torch.evolve.speciation import EVQESpeciation
from queasars_tpu_torch.evolve.selection import EVQESelection, EVQESelectionException

__all__ = [
    "BaseEvolutionaryOperator",
    "BasePopulationEvaluationResult",
    "OperatorContext",
    "EVQELastLayerParameterSearch",
    "EVQEParameterSearch",
    "EVQETopologicalSearch",
    "EVQELayerRemoval",
    "EVQESpeciation",
    "QNEATSpeciationSelection",
    "QNEATAngleMutation",
    "QNEATAddGate",
    "QNEATParameterPolish",
    "MultiObjectiveEVQESelection",
    "non_dominated_sort",
    "crowding_distance",
    "pareto_front",
    "EVQESelection",
    "EVQESelectionException",
]
