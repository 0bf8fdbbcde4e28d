"""Solver result object.

Behavioral port of queasars/minimum_eigensolvers/base/
evolving_ansatz_minimum_eigensolver_result.py:13-165 without the qiskit
base class: eigenvalue, eigenstate distribution, best individual,
per-generation evaluation ledger, all population evaluation results, and
the initial state.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from queasars_tpu_torch.evolve.base import BasePopulationEvaluationResult
from queasars_tpu_torch.genome.individual import EVQEIndividual


class EvolvingAnsatzMinimumEigensolverResult:
    """Result of an evolving-ansatz minimum eigenvalue solve."""

    def __init__(self) -> None:
        self.eigenvalue: Optional[float] = None
        self.eigenstate: Optional[dict[int, float]] = None
        self.best_individual: Optional[EVQEIndividual] = None
        self.circuit_evaluations: Optional[list[int]] = None
        self.generations: Optional[int] = None
        self.population_evaluation_results: Optional[list[BasePopulationEvaluationResult]] = None
        self.initial_state: Optional[np.ndarray] = None
        self.aux_operators_evaluated: Optional[Any] = None

    @property
    def optimal_parameters(self) -> Optional[tuple[float, ...]]:
        """The best individual's flat parameter values
        (reference: result.py:62-70)."""
        if self.best_individual is None:
            return None
        return self.best_individual.get_parameter_values()

    @property
    def optimal_circuit(self) -> Optional[EVQEIndividual]:
        """The best genome (the circuit, in this framework's currency;
        reference returns a QuantumCircuit at result.py:72-82)."""
        return self.best_individual

    @property
    def total_circuit_evaluations(self) -> Optional[int]:
        if self.circuit_evaluations is None:
            return None
        return int(sum(self.circuit_evaluations))

    @property
    def final_population_evaluation_result(self) -> Optional[BasePopulationEvaluationResult]:
        """The last generation's evaluation (reference: result.py:138-147)."""
        if not self.population_evaluation_results:
            return None
        return self.population_evaluation_results[-1]

    def __repr__(self) -> str:
        return (
            "EvolvingAnsatzMinimumEigensolverResult("
            f"eigenvalue={self.eigenvalue}, generations={self.generations}, "
            f"total_circuit_evaluations={self.total_circuit_evaluations})"
        )
