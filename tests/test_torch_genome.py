"""The port's genome modules against the JAX package's and against the
committed reference fixtures: seeded structures and parameter values must
be identical (the reference's ``random.Random`` call order), packed tensors
equal element by element."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from queasars_tpu.genome import EVQEIndividual as JaxIndividual
from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu_torch.genome import EVQEIndividual, EVQEPopulation, PackedPopulation
from queasars_tpu_torch.interop import (
    individual_from_plain,
    individual_to_plain,
    packed_population_from_numpy,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _layer_tuples(individual):
    plain = individual_to_plain(individual)["layers"]
    return [(tuple(c for c, _ in layer), tuple(p for _, p in layer)) for layer in plain]


def test_pinned_reference_genomes():
    with open(os.path.join(FIXTURES, "reference_genomes.json")) as fh:
        fixtures = json.load(fh)
    for entry in fixtures:
        individual = EVQEIndividual.random_individual(
            n_qubits=entry["n_qubits"], n_layers=entry["n_layers"],
            randomize_parameter_values=entry["randomize"], random_seed=entry["seed"],
        )
        expected = [(tuple(codes), tuple(partners)) for codes, partners in entry["layers"]]
        assert _layer_tuples(individual) == expected
        assert list(individual.parameter_values) == entry["parameter_values"]


@pytest.mark.parametrize("n_qubits,n_layers,seed", [(4, 2, 0), (7, 4, 11), (10, 3, 5)])
def test_random_populations_and_edits_match_jax(n_qubits, n_layers, seed):
    ours = EVQEPopulation.random_population(n_qubits, n_layers, 6, True, random_seed=seed)
    ref = JaxPopulation.random_population(n_qubits, n_layers, 6, True, random_seed=seed)
    for a, b in zip(ours.individuals, ref.individuals):
        assert individual_to_plain(a) == individual_to_plain(b)
        grown = EVQEIndividual.add_random_layers(a, 2, False, random_seed=seed + 1)
        grown_ref = JaxIndividual.add_random_layers(b, 2, False, random_seed=seed + 1)
        assert individual_to_plain(grown) == individual_to_plain(grown_ref)
        assert EVQEIndividual.get_genetic_distance(a, grown) == JaxIndividual.get_genetic_distance(
            b, grown_ref
        )


@pytest.mark.parametrize("order", ["canonical", "qiskit"])
def test_packing_matches_jax(order):
    ours = EVQEPopulation.random_population(11, 3, 5, True, random_seed=3)
    ref = JaxPopulation.random_population(11, 3, 5, True, random_seed=3)
    p = PackedPopulation.pack(list(ours.individuals), min_layers=6, parameter_order=order)
    q = JaxPacked.pack(list(ref.individuals), min_layers=6, parameter_order=order)
    for field in ("gate_types", "controls", "angles", "layer_mask", "param_mask", "n_params"):
        np.testing.assert_array_equal(getattr(p, field), getattr(q, field))
    for i in range(5):
        np.testing.assert_array_equal(p.param_coordinates(i), q.param_coordinates(i))
        np.testing.assert_array_equal(
            p.layer_param_coordinates(i, -1), q.layer_param_coordinates(i, -1)
        )
        assert p.angles_to_flat(i, p.angles[i]) == q.angles_to_flat(i, q.angles[i])


def test_interop_carries_jax_state_into_the_port():
    ref = JaxPopulation.random_population(6, 3, 4, True, random_seed=21)
    for individual in ref.individuals:
        plain = individual_to_plain(individual)
        ported = individual_from_plain(plain)
        assert individual_to_plain(ported) == plain
        assert ported.get_n_controlled_gates() == individual.get_n_controlled_gates()
    q = JaxPacked.pack(list(ref.individuals))
    p = packed_population_from_numpy(
        q.gate_types, q.controls, q.angles, q.layer_mask, q.param_mask, q.n_params, q.n_qubits
    )
    np.testing.assert_array_equal(
        p.param_coordinates(0), PackedPopulation.pack(
            [individual_from_plain(individual_to_plain(ref.individuals[0]))]
        ).param_coordinates(0)
    )
