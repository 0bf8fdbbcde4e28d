"""Multi-objective (MoG-VQE-style) selection: energy vs. circuit cost.

Counterpart of ``queasars_tpu/evolve/multiobjective.py`` (host code, the
same ``random.Random`` call order).
The reference names MoG-VQE and QNEAT as intended future algorithms with
no code (reference README.md:3, docs/source/index.rst:10).  This module
implements the MoG-VQE selection scheme (Chivilikhin et al.,
arXiv:2007.04424): NSGA-II non-dominated sorting over the two objectives

  (expectation value,  number of controlled two-qubit gates)

with crowding-distance diversity and binary-tournament survivor draws —
a drop-in replacement for :class:`~queasars_tpu_torch.evolve.selection.
EVQESelection` in the operator pipeline (no speciation required).

Population evaluation stays one batched device call; the sorting is
O(P^2) host work like the reference's host-side selection bookkeeping.
"""

from __future__ import annotations

from random import Random
from typing import Optional, Sequence

import numpy as np

from queasars_tpu_torch.evolve.base import (
    BaseEvolutionaryOperator,
    BasePopulationEvaluationResult,
    OperatorContext,
)
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.genome.population import EVQEPopulation


def non_dominated_sort(objectives: np.ndarray) -> list[list[int]]:
    """NSGA-II fast non-dominated sort.

    :param objectives: [P, M] objective matrix (all minimized)
    :return: fronts as lists of indices, best front first
    """
    pop = objectives.shape[0]
    dominates = np.logical_and(
        (objectives[:, None, :] <= objectives[None, :, :]).all(axis=-1),
        (objectives[:, None, :] < objectives[None, :, :]).any(axis=-1),
    )
    domination_count = dominates.sum(axis=0)  # how many dominate i
    fronts: list[list[int]] = []
    current = [i for i in range(pop) if domination_count[i] == 0]
    remaining = domination_count.copy()
    while current:
        fronts.append(current)
        next_front: list[int] = []
        for i in current:
            for j in np.nonzero(dominates[i])[0]:
                remaining[j] -= 1
                if remaining[j] == 0:
                    next_front.append(int(j))
        current = next_front
    return fronts


def crowding_distance(objectives: np.ndarray, front: Sequence[int]) -> np.ndarray:
    """NSGA-II crowding distance for one front (larger = more isolated)."""
    size = len(front)
    distance = np.zeros(size)
    if size <= 2:
        return np.full(size, np.inf)
    values = objectives[list(front)]
    for m in range(values.shape[1]):
        order = np.argsort(values[:, m], kind="stable")
        spread = values[order[-1], m] - values[order[0], m]
        distance[order[0]] = distance[order[-1]] = np.inf
        if spread <= 0:
            continue
        for k in range(1, size - 1):
            distance[order[k]] += (values[order[k + 1], m] - values[order[k - 1], m]) / spread
    return distance


def pareto_front(
    individuals: Sequence[EVQEIndividual], energies: Sequence[float]
) -> list[tuple[EVQEIndividual, float, int]]:
    """The non-dominated (energy, controlled-gate count) set of a
    population: [(individual, energy, n_controlled_gates), ...]."""
    objectives = np.array(
        [[energies[i], individuals[i].get_n_controlled_gates()] for i in range(len(individuals))],
        dtype=float,
    )
    front = non_dominated_sort(objectives)[0]
    unique: list[tuple[EVQEIndividual, float, int]] = []
    seen: set[int] = set()
    for i in sorted(front, key=lambda i: objectives[i, 0]):
        key = hash(individuals[i])
        if key not in seen:
            seen.add(key)
            unique.append((individuals[i], float(objectives[i, 0]), int(objectives[i, 1])))
    return unique


class MultiObjectiveEVQESelection(BaseEvolutionaryOperator[EVQEPopulation]):
    """NSGA-II selection over (energy, controlled-gate count).

    Like :class:`EVQESelection` this is the generation's evaluation step:
    it evaluates the population in one batched call, reports the result
    (generation boundary), then draws survivors by binary tournament on
    (front rank, crowding distance).

    :param layer_penalty: optional third objective weight — when > 0 the
        circuit-depth objective (layer count) joins the front computation
    :param random_seed: selection RNG seed
    """

    def __init__(self, layer_penalty: float = 0.0, random_seed: Optional[int] = None):
        self._layer_penalty = layer_penalty
        self._random_generator = Random(random_seed)

    def apply_operator(self, population: EVQEPopulation, operator_context: OperatorContext) -> EVQEPopulation:
        packed = PackedPopulation.pack(
            list(population.individuals), min_layers=operator_context.pack_min_layers
        )
        energies = [float(v) for v in operator_context.circuit_evaluator.evaluate_packed(packed)]
        operator_context.circuit_evaluation_count_callback(len(population.individuals))

        best_index = int(np.argmin(energies))
        operator_context.result_callback(
            BasePopulationEvaluationResult(
                population=population,
                expectation_values=tuple(energies),
                best_individual=population.individuals[best_index],
                best_expectation_value=energies[best_index],
            )
        )

        columns = [
            energies,
            [ind.get_n_controlled_gates() for ind in population.individuals],
        ]
        if self._layer_penalty > 0:
            columns.append([self._layer_penalty * len(ind.layers) for ind in population.individuals])
        objectives = np.array(columns, dtype=float).T

        fronts = non_dominated_sort(objectives)
        rank = np.zeros(len(population.individuals), dtype=int)
        crowd = np.zeros(len(population.individuals))
        for r, front in enumerate(fronts):
            rank[front] = r
            crowd[list(front)] = crowding_distance(objectives, front)

        def better(i: int, j: int) -> int:
            if rank[i] != rank[j]:
                return i if rank[i] < rank[j] else j
            if crowd[i] != crowd[j]:
                return i if crowd[i] > crowd[j] else j
            return i

        pop = len(population.individuals)
        selected = []
        for _ in range(pop):
            i, j = self._random_generator.choices(range(pop), k=2)
            selected.append(population.individuals[better(i, j)])

        return EVQEPopulation(
            individuals=tuple(selected),
            species_representatives=population.species_representatives,
            species_members=None,
            species_membership=None,
        )

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return len(population.individuals)
