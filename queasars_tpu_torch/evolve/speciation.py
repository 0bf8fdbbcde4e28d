"""NEAT-style speciation operator.

Behavioral port of
queasars/minimum_eigensolvers/evqe/evolutionary_algorithm/speciation.py:
19-95: each individual joins the first known species whose representative
lies within the genetic-distance threshold (founding a new species
otherwise); afterwards every species re-draws a random member as its
representative.  Pure host work, zero circuit evaluations.
"""

from __future__ import annotations

from random import Random
from typing import Optional

from queasars_tpu_torch.evolve.base import BaseEvolutionaryOperator, OperatorContext
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.population import EVQEPopulation

Membership = dict[EVQEIndividual, list[int]]


class EVQESpeciation(BaseEvolutionaryOperator[EVQEPopulation]):
    """Speciation by genetic distance (reference: speciation.py:19-95).

    :param genetic_distance_threshold: individuals strictly closer than
        this to a representative join its species
    :param random_seed: RNG seed for the representative re-draws
    """

    def __init__(self, genetic_distance_threshold: int, random_seed: Optional[int]):
        self.genetic_distance_threshold = genetic_distance_threshold
        self.random_generator = Random(random_seed)

    def _belongs_to(self, individual: EVQEIndividual, representative: EVQEIndividual) -> bool:
        distance = EVQEIndividual.get_genetic_distance(
            individual_1=individual, individual_2=representative
        )
        return distance < self.genetic_distance_threshold or individual == representative

    def _assign(self, population: EVQEPopulation) -> Membership:
        """First-fit species assignment, seeding from any carried-over
        representatives (reference: speciation.py:34-65)."""
        members: Membership = {}
        if population.species_representatives is not None:
            for carried in population.species_representatives:
                members[carried] = []

        for index, individual in enumerate(population.individuals):
            home = next(
                (rep for rep in members if self._belongs_to(individual, rep)), None
            )
            if home is None:
                members[individual] = [index]
            else:
                members[home].append(index)
        return members

    def _redraw_representatives(self, population: EVQEPopulation, members: Membership) -> Membership:
        """Each non-empty species elects a random member as its new
        representative; collisions merge (reference: speciation.py:67-83).

        The ``choice`` call order (one per non-empty species, in species
        insertion order) matches the reference exactly.
        """
        refreshed: Membership = {}
        for indices in members.values():
            if not indices:
                continue
            elected_index = self.random_generator.choice(indices)
            elected = population.individuals[elected_index]
            if elected in refreshed:
                refreshed[elected].extend(indices)
            else:
                refreshed[elected] = indices
        return refreshed

    def apply_operator(self, population: EVQEPopulation, operator_context: OperatorContext) -> EVQEPopulation:
        refreshed = self._redraw_representatives(population, self._assign(population))
        membership = {
            index: representative
            for representative, indices in refreshed.items()
            for index in indices
        }
        return EVQEPopulation(
            individuals=population.individuals,
            species_representatives=list(refreshed.keys()),
            species_members=refreshed,
            species_membership=membership,
        )

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return 0
