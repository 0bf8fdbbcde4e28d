"""Solvers: the generic evolving-ansatz driver, the EVQE, MoG-VQE and QNEAT
facades, ADAPT-VQE and QAOA; full-state checkpoints, the result JSON codec
and the convergence and Pareto-front plots."""

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
from queasars_tpu_torch.solver.adapt_vqe import (
    AdaptVQEConfiguration,
    AdaptVQEMinimumEigensolver,
    AdaptVQEResult,
)
from queasars_tpu_torch.solver.evqe import EVQEMinimumEigensolver, EVQEMinimumEigensolverConfiguration
from queasars_tpu_torch.solver.mog_vqe import MoGVQEMinimumEigensolver, result_pareto_front
from queasars_tpu_torch.solver.qaoa import QAOAConfiguration, QAOAMinimumEigensolver, QAOAResult
from queasars_tpu_torch.solver.qneat import (
    QNEATMinimumEigensolver,
    QNEATMinimumEigensolverConfiguration,
)

__all__ = [
    "AdaptVQEConfiguration",
    "AdaptVQEMinimumEigensolver",
    "AdaptVQEResult",
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
    "QAOAConfiguration",
    "QAOAMinimumEigensolver",
    "QAOAResult",
    "QNEATMinimumEigensolver",
    "QNEATMinimumEigensolverConfiguration",
    "result_pareto_front",
]

from queasars_tpu_torch.solver.visualization import plot_convergence, plot_pareto_front  # noqa: E402

__all__ += ["plot_convergence", "plot_pareto_front"]
