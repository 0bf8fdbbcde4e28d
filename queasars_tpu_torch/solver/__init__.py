"""Solvers: the generic evolving-ansatz driver, the EVQE facade and
MoG-VQE."""

from queasars_tpu_torch.solver.termination_criteria import (
    BestIndividualChangeTolerance,
    BestIndividualExpectationValueThreshold,
    BestIndividualRelativeChangeTolerance,
    EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion,
    PopulationChangeRelativeTolerance,
    PopulationChangeTolerance,
)
from queasars_tpu_torch.solver.result import EvolvingAnsatzMinimumEigensolverResult
from queasars_tpu_torch.solver.configured_evaluators import ConfiguredEstimator, ConfiguredSampler
from queasars_tpu_torch.solver.driver import (
    EvolvingAnsatzMinimumEigensolver,
    EvolvingAnsatzMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.solver.evqe import EVQEMinimumEigensolver, EVQEMinimumEigensolverConfiguration
from queasars_tpu_torch.solver.mog_vqe import MoGVQEMinimumEigensolver, result_pareto_front

__all__ = [
    "BestIndividualChangeTolerance",
    "BestIndividualExpectationValueThreshold",
    "BestIndividualRelativeChangeTolerance",
    "EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion",
    "PopulationChangeRelativeTolerance",
    "PopulationChangeTolerance",
    "EvolvingAnsatzMinimumEigensolverResult",
    "ConfiguredEstimator",
    "ConfiguredSampler",
    "EvolvingAnsatzMinimumEigensolver",
    "EvolvingAnsatzMinimumEigensolverConfiguration",
    "EVQEMinimumEigensolver",
    "EVQEMinimumEigensolverConfiguration",
    "MoGVQEMinimumEigensolver",
    "result_pareto_front",
]
