"""QNEAT evolutionary operators (speciated neuro-evolution of circuits).

The NEAT generation cycle (Stanley & Miikkulainen 2002, adapted to gate
genomes per arXiv:2304.06981) on the batched engine; counterpart of
``queasars_tpu/evolve/qneat.py``, with its ``random.Random`` call order:

1. :class:`QNEATSpeciationSelection` — evaluate the whole population in
   ONE batched device call (the lowered genomes share the packed-tensor
   engine), speciate by compatibility distance, apply explicit fitness
   sharing, and reproduce: species champions survive unchanged (elitism),
   the rest of the next generation comes from within-species crossover /
   cloning of the fitter survivors.  Reports the generation's
   :class:`BasePopulationEvaluationResult` (with the LOWERED population,
   so the driver/termination/serialization stack is reused untouched).
2. :class:`QNEATAngleMutation` — NEAT weight mutation: each non-elite
   genome's angles are jittered with per-angle Bernoulli(p) Gaussian
   noise (or fully re-drawn with a small probability).
3. :class:`QNEATAddGate` — structural mutation: append one random gate
   gene; identical structural mutations within one generation reuse the
   same innovation number (NEAT's innovation-reuse rule).

Optionally an angle-polish stage runs the batched NFT/SPSA optimizers on
every genome's full parameter vector (:class:`QNEATParameterPolish`) —
a hybrid the QNEAT paper leaves to weight mutation alone.
"""

from __future__ import annotations

from random import Random
from typing import Optional

import numpy as np

from queasars_tpu_torch.evolve.base import (
    BaseEvolutionaryOperator,
    BasePopulationEvaluationResult,
    OperatorContext,
)
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.genome.qneat import TWO_PI, QNEATGene, QNEATIndividual, QNEATPopulation
from queasars_tpu_torch.utils.random import new_random_seed


def _lowered(population: QNEATPopulation) -> list:
    return [individual.lower() for individual in population.individuals]


class QNEATSpeciationSelection(BaseEvolutionaryOperator[QNEATPopulation]):
    """Evaluate, speciate, share fitness, reproduce (the generation tick).

    :param distance_threshold: compatibility-distance species boundary
    :param c_excess / c_disjoint / c_angles: NEAT distance coefficients
    :param survival_fraction: fraction of each species allowed to parent
    :param crossover_probability: offspring via crossover (else clone)
    :param elitism_threshold: species at least this large keep their
        champion unchanged (NEAT uses 5)
    """

    def __init__(
        self,
        distance_threshold: float = 2.0,
        c_excess: float = 1.0,
        c_disjoint: float = 1.0,
        c_angles: float = 0.4,
        survival_fraction: float = 0.5,
        crossover_probability: float = 0.75,
        elitism_threshold: int = 3,
        random_seed: Optional[int] = None,
    ):
        self.distance_threshold = distance_threshold
        self.c_excess = c_excess
        self.c_disjoint = c_disjoint
        self.c_angles = c_angles
        self.survival_fraction = survival_fraction
        self.crossover_probability = crossover_probability
        self.elitism_threshold = elitism_threshold
        self.random_generator = Random(random_seed)

    def _speciate(self, population: QNEATPopulation) -> dict[int, list[int]]:
        """First-fit species assignment against sticky representatives
        (new species founded by unmatched genomes), NEAT-style."""
        representatives: list[QNEATIndividual] = list(population.species_representatives or ())
        members: dict[int, list[int]] = {s: [] for s in range(len(representatives))}
        for i, individual in enumerate(population.individuals):
            for s, representative in enumerate(representatives):
                if (
                    individual.compatibility_distance(
                        representative, self.c_excess, self.c_disjoint, self.c_angles
                    )
                    <= self.distance_threshold
                ):
                    members[s].append(i)
                    break
            else:
                s = len(representatives)
                representatives.append(individual)
                members[s] = [i]
        return {s: idx for s, idx in members.items() if idx}

    def apply_operator(
        self, population: QNEATPopulation, operator_context: OperatorContext
    ) -> QNEATPopulation:
        individuals = list(population.individuals)
        lowered = _lowered(population)
        packed = PackedPopulation.pack(lowered, min_layers=operator_context.pack_min_layers)
        energies = np.asarray(
            operator_context.circuit_evaluator.evaluate_packed(packed), dtype=np.float64
        )
        operator_context.circuit_evaluation_count_callback(len(individuals))

        members = self._speciate(population)

        # report the generation (driver result callback / termination tick)
        best_index = int(np.argmin(energies))
        evaluation = BasePopulationEvaluationResult(
            population=EVQEPopulation(
                individuals=tuple(lowered),
                species_representatives=None,
                species_members=None,
                species_membership=None,
            ),
            expectation_values=tuple(float(v) for v in energies),
            best_individual=lowered[best_index],
            best_expectation_value=float(energies[best_index]),
        )
        operator_context.result_callback(evaluation)

        # explicit fitness sharing on a positive scale: NEAT allocates
        # offspring proportional to species' shared fitness (NEAT sec. 3.3)
        raw_fitness = (float(np.max(energies)) - energies) + 1e-9
        species_ids = sorted(members)
        shared_sums = {
            s: float(np.sum(raw_fitness[members[s]])) / len(members[s]) for s in species_ids
        }
        total_shared = sum(shared_sums.values())

        pop_size = len(individuals)
        quotas: dict[int, int] = {}
        assigned = 0
        for s in species_ids:
            quota = int(np.floor(pop_size * shared_sums[s] / total_shared)) if total_shared else 0
            quotas[s] = quota
            assigned += quota
        # distribute the remainder to the best-shared-fitness species
        for s in sorted(species_ids, key=lambda s: -shared_sums[s]):
            if assigned >= pop_size:
                break
            quotas[s] += 1
            assigned += 1

        next_generation: list[QNEATIndividual] = []
        elite_flags: list[bool] = []
        representatives: list[QNEATIndividual] = []
        for s in species_ids:
            quota = quotas[s]
            if quota == 0:
                continue
            ranked = sorted(members[s], key=lambda i: energies[i])
            representatives.append(
                individuals[self.random_generator.choice(members[s])]
            )
            produced = 0
            if len(ranked) >= self.elitism_threshold:
                next_generation.append(individuals[ranked[0]])
                elite_flags.append(True)
                produced += 1
            survivors = ranked[: max(1, int(np.ceil(len(ranked) * self.survival_fraction)))]
            while produced < quota:
                if (
                    len(survivors) >= 2
                    and self.random_generator.random() < self.crossover_probability
                ):
                    a, b = self.random_generator.sample(survivors, 2)
                    if energies[a] > energies[b]:
                        a, b = b, a
                    child = QNEATIndividual.crossover(
                        individuals[a],
                        individuals[b],
                        self.random_generator,
                        equal_fitness=bool(energies[a] == energies[b]),
                    )
                else:
                    child = individuals[self.random_generator.choice(survivors)]
                next_generation.append(child)
                elite_flags.append(False)
                produced += 1

        return QNEATPopulation(
            individuals=tuple(next_generation[:pop_size]),
            next_innovation=population.next_innovation,
            species_members=None,
            species_representatives=tuple(representatives),
            elite_flags=tuple(elite_flags[:pop_size]),
        )

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return len(population.individuals)


class QNEATAngleMutation(BaseEvolutionaryOperator[QNEATPopulation]):
    """NEAT weight mutation on the rotation angles.

    Each non-elite genome is mutated with probability
    ``mutation_probability``; within a mutated genome each angle is
    jittered N(0, sigma) with probability ``perturbation_probability`` or
    re-drawn uniformly in [0, 2pi) with probability ``reset_probability``.
    """

    def __init__(
        self,
        mutation_probability: float = 0.8,
        perturbation_probability: float = 0.9,
        reset_probability: float = 0.05,
        sigma: float = 0.2,
        random_seed: Optional[int] = None,
    ):
        self.mutation_probability = mutation_probability
        self.perturbation_probability = perturbation_probability
        self.reset_probability = reset_probability
        self.sigma = sigma
        self.random_generator = Random(random_seed)

    def apply_operator(self, population, operator_context):
        elites = population.elite_flags or (False,) * len(population.individuals)
        individuals = list(population.individuals)
        for i, individual in enumerate(individuals):
            if elites[i] or self.random_generator.random() > self.mutation_probability:
                continue
            angles = list(individual.angles)
            for k in range(len(angles)):
                draw = self.random_generator.random()
                if draw < self.reset_probability:
                    angles[k] = self.random_generator.uniform(0.0, TWO_PI)
                elif draw < self.reset_probability + self.perturbation_probability:
                    angles[k] += self.random_generator.gauss(0.0, self.sigma)
            individuals[i] = individual.with_angles(angles)
        operator_context.circuit_evaluation_count_callback(0)
        return QNEATPopulation(
            individuals=tuple(individuals),
            next_innovation=population.next_innovation,
            species_members=population.species_members,
            species_representatives=population.species_representatives,
            elite_flags=population.elite_flags,
        )

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return 0


class QNEATAddGate(BaseEvolutionaryOperator[QNEATPopulation]):
    """Structural mutation: append one random gate gene (U3 with
    probability ``rotation_probability``, else CU3 on a random ordered
    pair).  Identical structural additions within one operator pass share
    one innovation number (NEAT's within-generation innovation reuse)."""

    def __init__(
        self,
        mutation_probability: float = 0.3,
        rotation_probability: float = 0.5,
        random_seed: Optional[int] = None,
    ):
        self.mutation_probability = mutation_probability
        self.rotation_probability = rotation_probability
        self.random_generator = Random(random_seed)

    def apply_operator(self, population, operator_context):
        elites = population.elite_flags or (False,) * len(population.individuals)
        individuals = list(population.individuals)
        next_innovation = population.next_innovation
        seen_this_pass: dict[tuple[int, int], int] = {}
        for i, individual in enumerate(individuals):
            if elites[i] or self.random_generator.random() > self.mutation_probability:
                continue
            if (
                individual.n_qubits >= 2
                and self.random_generator.random() >= self.rotation_probability
            ):
                target, control = self.random_generator.sample(
                    range(individual.n_qubits), 2
                )
            else:
                target = self.random_generator.randrange(individual.n_qubits)
                control = -1
            key = (target, control)
            if key in seen_this_pass:
                innovation = seen_this_pass[key]
            else:
                innovation = next_innovation
                seen_this_pass[key] = innovation
                next_innovation += 1
            if any(g.innovation == innovation for g in individual.genes):
                continue  # this genome already received this exact gene
            gene = QNEATGene(innovation=innovation, target=target, control=control)
            gene_angles = [self.random_generator.uniform(0.0, TWO_PI) for _ in range(3)]
            individuals[i] = individual.with_gene(gene, gene_angles)
        operator_context.circuit_evaluation_count_callback(0)
        return QNEATPopulation(
            individuals=tuple(individuals),
            next_innovation=next_innovation,
            species_members=population.species_members,
            species_representatives=population.species_representatives,
            elite_flags=None,  # structure moved on: elites already copied
        )

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return 0


class QNEATParameterPolish(BaseEvolutionaryOperator[QNEATPopulation]):
    """Optional hybrid stage: run a batched optimizer (NFT/SPSA) over the
    FULL parameter vector of every genome — pure QNEAT relies on weight
    mutation alone; this stage adds VQE-style local convergence at
    ``optimizer.config.n_circuit_evaluations()`` evals per individual."""

    def __init__(self, optimizer, random_seed: Optional[int] = None):
        self.optimizer = optimizer
        self.random_generator = Random(random_seed)

    def apply_operator(self, population, operator_context):
        individuals = list(population.individuals)
        lowered = _lowered(population)
        packed = PackedPopulation.pack(lowered, min_layers=operator_context.pack_min_layers)
        coords_list = [packed.param_coordinates(i) for i in range(packed.n_individuals)]
        k_max = max((c.shape[0] for c in coords_list), default=1)
        coords = np.zeros((packed.n_individuals, max(k_max, 1), 3), np.int32)
        n_free = np.zeros(packed.n_individuals, np.int32)
        for i, c in enumerate(coords_list):
            coords[i, : c.shape[0]] = c
            n_free[i] = c.shape[0]
        active = n_free > 0
        seed = new_random_seed(self.random_generator)
        new_angles, _, nfev_each = self.optimizer.minimize(
            operator_context.circuit_evaluator, packed, coords, n_free, active, seed=seed
        )
        packed.angles = np.asarray(new_angles)
        from queasars_tpu_torch.genome.packing import unpack_individual

        for i in range(len(individuals)):
            updated = unpack_individual(packed, i, lowered[i])
            individuals[i] = individuals[i].pull_angles_from(updated)
        operator_context.circuit_evaluation_count_callback(
            int(active.sum()) * int(nfev_each)
        )
        return QNEATPopulation(
            individuals=tuple(individuals),
            next_innovation=population.next_innovation,
            species_members=population.species_members,
            species_representatives=population.species_representatives,
            elite_flags=population.elite_flags,
        )

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        if hasattr(self.optimizer, "config") and hasattr(
            self.optimizer.config, "n_circuit_evaluations"
        ):
            return len(population.individuals) * self.optimizer.config.n_circuit_evaluations()
        return None
