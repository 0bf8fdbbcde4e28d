"""Evolution contracts: operator ABC, evaluation result, operator context.

Behavioral port of
queasars/minimum_eigensolvers/base/evolutionary_algorithm.py:15-152 with
one deliberate omission: ``OperatorContext`` carries no
``parallel_executor`` — the reference injects a dask Client or thread pool
(:110-118) because each circuit evaluation is an independent RPC; here
evaluation is one batched device call, so the executor surface disappears
(SURVEY.md §2.3).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Callable, Generic, Optional, TypeVar

from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.sim.evaluators import BaseCircuitEvaluator

# unbound: the pipeline is generic over population types (EVQE layer
# genomes, QNEAT gene genomes, ...); evaluation results always carry a
# lowered EVQEPopulation so the downstream stack stays uniform
POP = TypeVar("POP")
IND = TypeVar("IND", bound=EVQEIndividual)


@dataclass
class BasePopulationEvaluationResult(Generic[IND]):
    """One generation's evaluation snapshot
    (reference: evolutionary_algorithm.py:77-95).

    :param population: the population that was evaluated
    :param expectation_values: one expectation value per individual
    :param best_individual: the generation's best individual
    :param best_expectation_value: its expectation value
    """

    population: EVQEPopulation
    expectation_values: tuple[Optional[float], ...]
    best_individual: IND
    best_expectation_value: float


@dataclass
class PopulationEnergyCache:
    """Exact population energies published by an optimizing operator for
    reuse by the next selection step.

    On the exact diagonal estimator path, the NFT sweep's final recycled
    value IS the energy of each individual at its final angles (the
    sinusoid model is exact there — optim/nft.py module docstring), so
    the selection that immediately follows (only speciation, which never
    touches genomes, runs in between — reference pipeline order
    evqe.py:198-230) need not re-dispatch an evaluation.  The cache is
    keyed on the population's genome hashes: any structural or parameter
    change misses and selection evaluates as usual.  The evaluation
    ledger is unaffected either way (it counts reference-equivalent
    evaluations, not physical dispatches).
    """

    key: Optional[tuple] = None
    energies: Optional[tuple] = None

    def publish(self, individuals, energies) -> None:
        self.key = tuple(hash(ind) for ind in individuals)
        self.energies = tuple(float(v) for v in energies)

    def consume(self, individuals) -> Optional[list[float]]:
        """Return the cached energies if they match ``individuals``
        exactly; always clears the cache."""
        key, energies = self.key, self.energies
        self.key = None
        self.energies = None
        if energies is None or key != tuple(hash(ind) for ind in individuals):
            return None
        return list(energies)


@dataclass
class OperatorContext:
    """Dependency-injection record handed to every operator
    (reference: evolutionary_algorithm.py:98-118, minus the executor).

    :param circuit_evaluator: evaluates populations to energies
    :param result_callback: reports a finished generation evaluation (the
        generation boundary — triggers termination checks)
    :param circuit_evaluation_count_callback: reports evaluations used
        (budget ledger input)
    :param pack_min_layers: fixed lower bound for the packed layer
        dimension — pinning it keeps the kernel shapes constant across
        generations (padded layers are skipped by
        layer predication)
    :param energy_cache: when set, optimizing operators may publish exact
        final energies for the selection step to reuse (saves one device
        dispatch + one batched evaluation per generation)
    """

    circuit_evaluator: BaseCircuitEvaluator
    result_callback: Callable[[BasePopulationEvaluationResult], None]
    circuit_evaluation_count_callback: Callable[[int], None]
    pack_min_layers: Optional[int] = None
    energy_cache: Optional[PopulationEnergyCache] = None


class BaseEvolutionaryOperator(ABC, Generic[POP]):
    """One step of the generation pipeline
    (reference: evolutionary_algorithm.py:121-152)."""

    @abstractmethod
    def apply_operator(self, population: POP, operator_context: OperatorContext) -> POP:
        """Apply the operator, returning the next population state."""

    @abstractmethod
    def get_n_expected_circuit_evaluations(
        self, population: POP, operator_context: OperatorContext
    ) -> Optional[int]:
        """Estimated evaluation cost of the next application (None if
        unknown); consumed by the solver's budget-aware early stop."""
