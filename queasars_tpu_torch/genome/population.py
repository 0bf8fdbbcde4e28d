"""EVQE populations with speciation state.

Behavioral port of
queasars/minimum_eigensolvers/evqe/evolutionary_algorithm/population.py:13-77.
"""

from __future__ import annotations

from dataclasses import dataclass
from random import Random
from typing import Optional

from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.utils.random import new_random_seed


@dataclass
class EVQEPopulation:
    """A tuple of individuals plus optional speciation bookkeeping.

    :param individuals: the population members
    :param species_representatives: one representative per species (None if
        speciation has not run)
    :param species_members: representative -> member indices
    :param species_membership: member index -> representative

    Reference: population.py:13-30.
    """

    individuals: tuple[EVQEIndividual, ...]
    species_representatives: Optional[list[EVQEIndividual]]
    species_members: Optional[dict[EVQEIndividual, list[int]]]
    species_membership: Optional[dict[int, EVQEIndividual]]

    @staticmethod
    def random_population(
        n_qubits: int,
        n_layers: int,
        n_individuals: int,
        randomize_parameter_values: bool,
        random_seed: Optional[int] = None,
    ) -> "EVQEPopulation":
        """Seeded random population; speciation state starts empty
        (reference: population.py:32-77 — one child seed per individual)."""
        rng = Random(random_seed)
        individuals = tuple(
            EVQEIndividual.random_individual(
                n_qubits=n_qubits,
                n_layers=n_layers,
                randomize_parameter_values=randomize_parameter_values,
                random_seed=new_random_seed(rng),
            )
            for _ in range(n_individuals)
        )
        return EVQEPopulation(
            individuals=individuals,
            species_representatives=None,
            species_members=None,
            species_membership=None,
        )
