"""Pluggable convergence detectors over the generation sequence.

Behavioral port of
queasars/minimum_eigensolvers/base/termination_criteria.py:10-335: the
five criteria, the consecutive-violation windows, and the median-Hausdorff
population distance.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from numpy import median

from queasars_tpu_torch.evolve.base import BasePopulationEvaluationResult
from queasars_tpu_torch.genome.individual import EVQEIndividual


class EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion(ABC):
    """Holds and evaluates the solver's termination state
    (reference: termination_criteria.py:10-35)."""

    @abstractmethod
    def reset_state(self) -> None:
        """Reset internal state so the criterion can be reused."""

    @abstractmethod
    def check_termination(
        self,
        population_evaluation: BasePopulationEvaluationResult,
        best_individual: EVQEIndividual,
        best_expectation_value: float,
    ) -> bool:
        """True if the solver should terminate after this generation."""


class BestIndividualChangeTolerance(EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion):
    """Terminate when the absolute change of the generation-best expectation
    stays below ``minimum_change`` for the violation window
    (reference: termination_criteria.py:38-87)."""

    def __init__(self, minimum_change: float, allowed_consecutive_violations: int = 0):
        if minimum_change <= 0:
            raise ValueError("minimum_absolute_improvement must be positive")
        if allowed_consecutive_violations < 0:
            raise ValueError("allowed_consecutive_violations must be >= 0")
        self._minimum_change = minimum_change
        self._allowed_consecutive_violations = allowed_consecutive_violations
        self._previous_expectation_value: Optional[float] = None
        self._change_history: list[float] = []

    def reset_state(self) -> None:
        self._previous_expectation_value = None
        self._change_history = []

    def check_termination(self, population_evaluation, best_individual, best_expectation_value) -> bool:
        if self._previous_expectation_value is None:
            self._previous_expectation_value = population_evaluation.best_expectation_value
            return False
        change = abs(self._previous_expectation_value - population_evaluation.best_expectation_value)
        self._change_history.append(change)
        self._previous_expectation_value = population_evaluation.best_expectation_value
        if len(self._change_history) < self._allowed_consecutive_violations + 1:
            return False
        return max(self._change_history[-self._allowed_consecutive_violations - 1 :]) < self._minimum_change


class BestIndividualRelativeChangeTolerance(EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion):
    """Like :class:`BestIndividualChangeTolerance`, but the change is taken
    relative to the previous generation's best expectation
    (reference: termination_criteria.py:90-144)."""

    def __init__(self, minimum_relative_change: float, allowed_consecutive_violations: int = 0):
        if minimum_relative_change <= 0 or minimum_relative_change > 1:
            raise ValueError("minimum_relative_change must lie in the half-open interval (0, 1]")
        if allowed_consecutive_violations < 0:
            raise ValueError("allowed_consecutive_violations must be >= 0")
        self._minimum_relative_change = minimum_relative_change
        self._allowed_consecutive_violations = allowed_consecutive_violations
        self._previous_expectation_value: Optional[float] = None
        self._relative_change_history: list[float] = []

    def reset_state(self) -> None:
        self._previous_expectation_value = None
        self._relative_change_history = []

    def check_termination(self, population_evaluation, best_individual, best_expectation_value) -> bool:
        if self._previous_expectation_value is None:
            self._previous_expectation_value = population_evaluation.best_expectation_value
            return False
        relative_change = abs(
            self._previous_expectation_value - population_evaluation.best_expectation_value
        ) / abs(self._previous_expectation_value)
        self._previous_expectation_value = population_evaluation.best_expectation_value
        self._relative_change_history.append(relative_change)
        if len(self._relative_change_history) < self._allowed_consecutive_violations + 1:
            return False
        return (
            max(self._relative_change_history[-self._allowed_consecutive_violations - 1 :])
            < self._minimum_relative_change
        )


class BestIndividualExpectationValueThreshold(EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion):
    """Terminate once the generation-best expectation falls below a
    threshold (reference: termination_criteria.py:147-170)."""

    def __init__(self, expectation_threshold: float):
        self._expectation_threshold = expectation_threshold

    def reset_state(self) -> None:
        pass

    def check_termination(self, population_evaluation, best_individual, best_expectation_value) -> bool:
        return population_evaluation.best_expectation_value < self._expectation_threshold


def _median_hausdorff_distance_by_expectation_value(
    result_1: BasePopulationEvaluationResult, result_2: BasePopulationEvaluationResult
) -> float:
    """Median Hausdorff distance between two generations' expectation-value
    sets (reference: termination_criteria.py:173-194)."""

    def distance(from_values: list[float], to_values: list[float]) -> float:
        return float(
            median([min(abs(a - b) for b in to_values) for a in from_values])
        )

    values_1 = [v for v in result_1.expectation_values if v is not None]
    values_2 = [v for v in result_2.expectation_values if v is not None]
    return max(distance(values_1, values_2), distance(values_2, values_1))


class PopulationChangeTolerance(EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion):
    """Terminate when max(best-individual change, median Hausdorff distance
    of the population) stays below ``minimum_change``
    (reference: termination_criteria.py:197-256)."""

    def __init__(self, minimum_change: float, allowed_consecutive_violations: int):
        if allowed_consecutive_violations < 0:
            raise ValueError("allowed_consecutive_violations must be >= 0")
        self._minimum_change = minimum_change
        self._allowed_consecutive_violations = allowed_consecutive_violations
        self.reset_state()

    def reset_state(self) -> None:
        self._change_history = [
            10 * self._minimum_change for _ in range(self._allowed_consecutive_violations + 1)
        ]
        self._last_population_evaluation: Optional[BasePopulationEvaluationResult] = None

    def check_termination(self, population_evaluation, best_individual, best_expectation_value) -> bool:
        if self._last_population_evaluation is not None:
            hausdorff = _median_hausdorff_distance_by_expectation_value(
                self._last_population_evaluation, population_evaluation
            )
            best_distance = abs(
                self._last_population_evaluation.best_expectation_value
                - population_evaluation.best_expectation_value
            )
            self._change_history.append(max(hausdorff, best_distance))
        self._last_population_evaluation = population_evaluation
        if len(self._change_history) < self._allowed_consecutive_violations + 1:
            return False
        return (
            max(self._change_history[-(self._allowed_consecutive_violations + 1) :])
            < self._minimum_change
        )


class PopulationChangeRelativeTolerance(EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion):
    """Like :class:`PopulationChangeTolerance`, relative to the previous
    generation's median expectation
    (reference: termination_criteria.py:259-335)."""

    def __init__(self, minimum_relative_change: float, allowed_consecutive_violations: int):
        if allowed_consecutive_violations < 0:
            raise ValueError("allowed_consecutive_violations must be >= 0")
        self._minimum_relative_change = minimum_relative_change
        self._allowed_consecutive_violations = allowed_consecutive_violations
        self.reset_state()

    def reset_state(self) -> None:
        self._relative_change_history = [
            10 * self._minimum_relative_change
            for _ in range(self._allowed_consecutive_violations + 1)
        ]
        self._last_population_evaluation: Optional[BasePopulationEvaluationResult] = None

    def check_termination(self, population_evaluation, best_individual, best_expectation_value) -> bool:
        if self._last_population_evaluation is not None:
            hausdorff = _median_hausdorff_distance_by_expectation_value(
                self._last_population_evaluation, population_evaluation
            )
            best_distance = abs(
                self._last_population_evaluation.best_expectation_value
                - population_evaluation.best_expectation_value
            )
            distance = max(hausdorff, best_distance)
            last_median = float(
                median(
                    [v for v in self._last_population_evaluation.expectation_values if v is not None]
                )
            )
            self._relative_change_history.append(distance / last_median)
        self._last_population_evaluation = population_evaluation
        if len(self._relative_change_history) < self._allowed_consecutive_violations + 1:
            return False
        return (
            max(self._relative_change_history[-(self._allowed_consecutive_violations + 1) :])
            < self._minimum_relative_change
        )
