"""Generation-loop solver driver (PyTorch port).

Counterpart of ``queasars_tpu/solver/driver.py`` (behavioral port of
queasars/minimum_eigensolvers/base/evolving_ansatz_minimum_eigensolver.py:
53-478): operator pipeline with budget-aware early stop, result and
evaluation-count callbacks as the generation boundary, termination
criteria, and final result assembly.

The port runs the JAX package's production fused route: the exact
estimator on the slot kernels, the prefix cache, fused multi-slot parameter
search and selection energy reuse.  Not ported yet, each refused with
``NotImplementedError``: the configured sampler, checkpoint and resume, and
the device mesh.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
from numpy import mean, median

from queasars_tpu_torch.evolve.base import (
    BaseEvolutionaryOperator,
    BasePopulationEvaluationResult,
    OperatorContext,
    PopulationEnergyCache,
)
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.optim.objective import population_probs
from queasars_tpu_torch.sim.evaluators import (
    BaseCircuitEvaluator,
    StatevectorExpectationEvaluator,
    packed_tensors,
)
from queasars_tpu_torch.solver.configured_evaluators import ConfiguredEstimator, ConfiguredSampler
from queasars_tpu_torch.solver.result import EvolvingAnsatzMinimumEigensolverResult
from queasars_tpu_torch.solver.termination_criteria import (
    EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion,
)

ListOrDict = Union[list, dict, None]


def quasi_distribution(probs: np.ndarray, atol: float = 1e-12) -> dict[int, float]:
    """Dense probabilities -> sparse {basis_state: probability} dict."""
    probs = np.asarray(probs)
    (nonzero,) = np.nonzero(probs > atol)
    return {int(i): float(probs[i]) for i in nonzero}


@dataclass
class EvolvingAnsatzMinimumEigensolverConfiguration:
    """Driver configuration
    (reference: evolving_ansatz_minimum_eigensolver.py:53-119).

    :param population_initializer: problem-size (qubits) -> initial population
    :param evolutionary_operators: the per-generation operator pipeline
    :param configured_sampler: not ported yet (must be None)
    :param configured_estimator: exact-expectation settings (required)
    :param max_generations / max_circuit_evaluations / termination_criterion:
        at least one must be set
    :param initial_population: optional start population
    :param pack_min_layers: fixed lower bound of the packed layer dimension
    :param checkpoint_path / resume_from_checkpoint / mesh / n_devices: not
        ported yet (must be None)
    :param parameter_order: "canonical" or "qiskit" flat-parameter order
    :param reuse_selection_energies: selection reuses the exact final
        energies of the preceding last-layer search (None = on)
    :param device: where the solve runs (None = the CUDA device)
    """

    population_initializer: Callable[[int], EVQEPopulation]
    evolutionary_operators: list[BaseEvolutionaryOperator]
    configured_sampler: Optional[ConfiguredSampler]
    configured_estimator: Optional[ConfiguredEstimator]
    max_generations: Optional[int]
    max_circuit_evaluations: Optional[int]
    termination_criterion: Optional[EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion]
    initial_population: Optional[EVQEPopulation] = field(default=None)
    pack_min_layers: Optional[int] = None
    checkpoint_path: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None
    mesh: Optional[object] = None
    n_devices: Optional[int] = None
    parameter_order: str = "canonical"
    reuse_selection_energies: Optional[bool] = None
    device: Optional[object] = None

    def __post_init__(self):
        if (
            self.max_generations is None
            and self.max_circuit_evaluations is None
            and self.termination_criterion is None
        ):
            raise ValueError(
                "no stopping condition configured: set max_generations, "
                "max_circuit_evaluations and/or a termination_criterion"
            )
        if self.configured_sampler is not None:
            raise NotImplementedError("the configured sampler is not ported yet")
        if self.configured_estimator is None:
            raise ValueError("provide a configured_estimator")
        if self.configured_estimator.precision:
            raise NotImplementedError("estimator precision (shot-based) is not ported yet")
        if self.checkpoint_path is not None or self.resume_from_checkpoint is not None:
            raise NotImplementedError("checkpoint and resume are not ported yet")
        if self.mesh is not None or self.n_devices is not None:
            raise NotImplementedError("the device mesh is not ported yet")


class EvolvingAnsatzMinimumEigensolver:
    """Minimum eigensolver evolving the ansatz architecture alongside its
    rotation angles (reference: evolving_ansatz_minimum_eigensolver.py:
    122-478)."""

    def __init__(self, configuration: EvolvingAnsatzMinimumEigensolverConfiguration):
        self.configuration = configuration
        self.logger = logging.getLogger(__name__)

    def compute_minimum_eigenvalue(
        self,
        operator: PauliSum,
        aux_operators: ListOrDict = None,
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        """Find the minimum eigenvalue of ``operator`` (reference: :177-199)."""
        return self.compute_minimum_eigenvalue_with_initial_state(
            operator=operator, aux_operators=aux_operators, initial_state=None
        )

    def compute_minimum_eigenvalue_with_initial_state(
        self,
        operator: PauliSum,
        aux_operators: ListOrDict = None,
        initial_state: Union[np.ndarray, EVQEIndividual, None] = None,
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        """Like :meth:`compute_minimum_eigenvalue`, starting every circuit
        from ``initial_state`` (a [2^n] complex or [2, 2^n] re/im state, or
        an :class:`EVQEIndividual` preparing it; reference: :201-276)."""

        def build_evaluator(op: PauliSum) -> BaseCircuitEvaluator:
            return StatevectorExpectationEvaluator(
                operator=op, initial_state=initial_state, device=self.configuration.device
            )

        evaluator = build_evaluator(operator)
        aux_evaluators: ListOrDict = None
        if isinstance(aux_operators, list):
            aux_evaluators = [build_evaluator(op) for op in aux_operators]
        elif isinstance(aux_operators, dict):
            aux_evaluators = {key: build_evaluator(op) for key, op in aux_operators.items()}

        from queasars_tpu_torch.genome.parameter_order import parameter_order

        with parameter_order(self.configuration.parameter_order):
            result = self._solve_by_evolution(evaluator, aux_evaluators)
        result.initial_state = initial_state
        return result

    # ------------------------------------------------------------------
    # the generation loop (reference: :331-478)
    # ------------------------------------------------------------------

    def _solve_by_evolution(
        self,
        circuit_evaluator: StatevectorExpectationEvaluator,
        aux_circuit_evaluators: ListOrDict,
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        n_circuit_evaluations: list[int] = []
        n_generations = 0
        terminate = False
        current_best_individual: Optional[EVQEIndividual] = None
        current_best_expectation_value: Optional[float] = None
        population_evaluations: list[BasePopulationEvaluationResult] = []
        if self.configuration.termination_criterion is not None:
            self.configuration.termination_criterion.reset_state()

        def result_callback(evaluation_result: BasePopulationEvaluationResult) -> None:
            nonlocal current_best_individual, current_best_expectation_value
            nonlocal terminate, n_generations

            population_evaluations.append(evaluation_result)
            if (
                current_best_expectation_value is None
                or evaluation_result.best_expectation_value < current_best_expectation_value
            ):
                current_best_individual = evaluation_result.best_individual
                current_best_expectation_value = evaluation_result.best_expectation_value

            self.logger.info("Results for generation: %d", n_generations)
            self.logger.info(
                "generation best expectation value: %f", evaluation_result.best_expectation_value
            )
            filtered = [v for v in evaluation_result.expectation_values if v is not None]
            self.logger.info("generation median expectation value: %f", median(filtered))
            self.logger.info("generation mean expectation value: %f", mean(filtered))

            n_generations += 1

            if self.configuration.termination_criterion is not None:
                terminate = self.configuration.termination_criterion.check_termination(
                    population_evaluation=evaluation_result,
                    best_individual=current_best_individual,
                    best_expectation_value=current_best_expectation_value,
                )

        def circuit_evaluation_callback(evaluations: int) -> None:
            if len(n_circuit_evaluations) < n_generations + 1:
                n_circuit_evaluations.append(evaluations)
            else:
                n_circuit_evaluations[n_generations] += evaluations

        reuse_energies = self.configuration.reuse_selection_energies is not False
        operator_context = OperatorContext(
            circuit_evaluator=circuit_evaluator,
            result_callback=result_callback,
            circuit_evaluation_count_callback=circuit_evaluation_callback,
            pack_min_layers=self.configuration.pack_min_layers,
            energy_cache=PopulationEnergyCache() if reuse_energies else None,
        )

        if self.configuration.initial_population is not None:
            population = self.configuration.initial_population
        else:
            population = self.configuration.population_initializer(circuit_evaluator.n_qubits)

        self.logger.info("Starting evolution!")

        while not terminate:
            for operator in self.configuration.evolutionary_operators:
                # budget checks before each operator (reference: :405-428)
                if (
                    self.configuration.max_circuit_evaluations is not None
                    and sum(n_circuit_evaluations) >= self.configuration.max_circuit_evaluations
                ):
                    terminate = True
                estimated = operator.get_n_expected_circuit_evaluations(
                    population=population, operator_context=operator_context
                )
                if (
                    self.configuration.max_circuit_evaluations is not None
                    and estimated is not None
                    and sum(n_circuit_evaluations) + estimated
                    >= self.configuration.max_circuit_evaluations
                ):
                    terminate = True
                if (
                    self.configuration.max_generations is not None
                    and n_generations >= self.configuration.max_generations
                ):
                    terminate = True
                if terminate:
                    break
                population = operator.apply_operator(
                    population=population, operator_context=operator_context
                )

        if current_best_individual is None or len(population_evaluations) == 0:
            raise RuntimeError(
                "the solve terminated before any population evaluation completed "
                "(budget too small for even one selection step?)"
            )

        result = EvolvingAnsatzMinimumEigensolverResult()
        result.eigenvalue = current_best_expectation_value
        result.eigenstate = self._measure_eigenstate(current_best_individual, circuit_evaluator)
        result.best_individual = current_best_individual
        result.circuit_evaluations = n_circuit_evaluations
        result.generations = n_generations
        result.population_evaluation_results = population_evaluations

        if isinstance(aux_circuit_evaluators, list):
            result.aux_operators_evaluated = [
                evaluator.evaluate_individuals([current_best_individual])[0]
                for evaluator in aux_circuit_evaluators
            ]
        elif isinstance(aux_circuit_evaluators, dict):
            result.aux_operators_evaluated = {
                name: evaluator.evaluate_individuals([current_best_individual])[0]
                for name, evaluator in aux_circuit_evaluators.items()
            }

        return result

    def _measure_eigenstate(
        self, individual: EVQEIndividual, evaluator: StatevectorExpectationEvaluator
    ) -> dict[int, float]:
        """Exact measurement distribution of the best circuit (a
        probabilities kernel on the card, on the optimizers' route)."""
        packed = PackedPopulation.pack([individual])
        probs = population_probs(
            *packed_tensors(packed, device=evaluator.device),
            n_qubits=packed.n_qubits,
            initial_state=evaluator.initial_states(1),
        )[0]
        return quasi_distribution(probs.cpu().numpy())
