"""The port's JSON and OpenQASM codecs against the JAX package's.

One population, JSSP instance or result encodes to the same JSON text in
both packages, and each package decodes the other's text into an object
that encodes back to that text.  The committed reference fixtures decode in
the port, and ``individual_to_qasm`` writes the JAX package's text
character for character.
"""

from __future__ import annotations

import json
import os
from math import pi
from random import Random

import numpy as np
import pytest

import queasars_tpu.evolve.base as jax_evolve_base
import queasars_tpu.genome as jax_genome
import queasars_tpu.genome.qasm as jax_qasm
import queasars_tpu.genome.serialization as jax_codec
import queasars_tpu.problems.jssp as jax_jssp
import queasars_tpu.problems.jssp.serialization as jax_jssp_codec
import queasars_tpu.solver.result as jax_result
import queasars_tpu.solver.serialization as jax_result_codec
import queasars_tpu_torch.evolve.base as evolve_base
import queasars_tpu_torch.genome as genome
import queasars_tpu_torch.genome.qasm as qasm
import queasars_tpu_torch.genome.serialization as codec
import queasars_tpu_torch.problems.jssp as jssp
import queasars_tpu_torch.problems.jssp.serialization as jssp_codec
import queasars_tpu_torch.solver.result as result_module
import queasars_tpu_torch.solver.serialization as result_codec
from queasars_tpu_torch.genome import parameter_order

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PORT = dict(genome=genome, codec=codec, jssp=jssp, jssp_codec=jssp_codec, base=evolve_base,
            result=result_module, result_codec=result_codec, qasm=qasm)
JAX = dict(genome=jax_genome, codec=jax_codec, jssp=jax_jssp, jssp_codec=jax_jssp_codec,
           base=jax_evolve_base, result=jax_result, result_codec=jax_result_codec, qasm=jax_qasm)


def _f32(values):
    """Parameter values as the optimizers leave them: float32 angles made
    Python floats through ``float(np.float32)``."""
    return tuple(float(np.float32(v)) for v in values)


def evqe_population(pkg, seed):
    """A seeded population with float32-rounded angles on half its
    individuals and a speciation state."""
    population = pkg["genome"].EVQEPopulation.random_population(
        n_qubits=5, n_layers=3, n_individuals=6, randomize_parameter_values=True,
        random_seed=seed,
    )
    individuals = tuple(
        pkg["genome"].EVQEIndividual.change_parameter_values(ind, _f32(ind.parameter_values))
        if i % 2 else ind
        for i, ind in enumerate(population.individuals)
    )
    reps = [individuals[0], individuals[3]]
    return pkg["genome"].EVQEPopulation(
        individuals=individuals,
        species_representatives=reps,
        species_members={reps[0]: [0, 1, 2], reps[1]: [3, 4, 5]},
        species_membership={i: reps[i // 3] for i in range(6)},
    )


def qneat_population(pkg, seed):
    """A seeded QNEAT population grown by a few CU3 and U3 genes, with
    species representatives and elite flags."""
    base = pkg["genome"].QNEATPopulation.initial(4, 5, True, seed)
    rng = Random(seed)
    Gene, Individual = pkg["genome"].QNEATGene, pkg["genome"].QNEATIndividual
    individuals = []
    for i, ind in enumerate(base.individuals):
        genes = list(ind.genes) + [Gene(innovation=4 + i, target=i % 4, control=(i + 1) % 4),
                                   Gene(innovation=9, target=3)]
        angles = list(ind.angles) + [2 * pi * rng.random() for _ in range(6)]
        individuals.append(Individual(n_qubits=4, genes=tuple(genes), angles=_f32(angles)))
    return pkg["genome"].QNEATPopulation(
        individuals=tuple(individuals), next_innovation=10,
        species_representatives=(individuals[0], individuals[2]),
        elite_flags=(True, False, False, True, False),
    )


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_evqe_population_text_equal_and_decoded_across_packages(seed):
    ours = json.dumps(evqe_population(PORT, seed), cls=codec.EVQEPopulationJSONEncoder)
    theirs = json.dumps(evqe_population(JAX, seed), cls=jax_codec.EVQEPopulationJSONEncoder)
    assert ours == theirs
    from_jax = json.loads(theirs, cls=codec.EVQEPopulationJSONDecoder)
    assert isinstance(from_jax, genome.EVQEPopulation)
    assert json.dumps(from_jax, cls=codec.EVQEPopulationJSONEncoder) == theirs
    from_port = json.loads(ours, cls=jax_codec.EVQEPopulationJSONDecoder)
    assert json.dumps(from_port, cls=jax_codec.EVQEPopulationJSONEncoder) == ours


@pytest.mark.parametrize("seed", [0, 3])
def test_qneat_population_text_equal_and_decoded_across_packages(seed):
    ours = json.dumps(qneat_population(PORT, seed), cls=codec.QNEATPopulationJSONEncoder)
    theirs = json.dumps(qneat_population(JAX, seed), cls=jax_codec.QNEATPopulationJSONEncoder)
    assert ours == theirs
    from_jax = json.loads(theirs, cls=codec.QNEATPopulationJSONDecoder)
    assert from_jax == qneat_population(PORT, seed)
    from_port = json.loads(ours, cls=jax_codec.QNEATPopulationJSONDecoder)
    assert json.dumps(from_port, cls=jax_codec.QNEATPopulationJSONEncoder) == ours


def test_reference_wire_population_fixture_decodes():
    path = os.path.join(FIXTURES, "reference_wire_population.json")
    with open(path) as fh:
        population = json.load(fh, cls=codec.EVQEPopulationJSONDecoder)
    assert isinstance(population, genome.EVQEPopulation)
    assert len(population.individuals) == 2
    first = population.individuals[0]
    gates = first.layers[0].gates
    assert isinstance(gates[0], genome.RotationGate)
    assert isinstance(gates[1], genome.ControlledRotationGate) and gates[1].control_qubit_index == 2
    assert isinstance(gates[2], genome.ControlGate) and gates[2].controlled_qubit_index == 1
    assert first.parameter_values == (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)
    assert isinstance(population.individuals[1].layers[0].gates[2], genome.IdentityGate)
    ((representative, members),) = population.species_members.items()
    assert members == [0, 1]
    assert population.species_membership[0] == representative
    with open(path) as fh:
        raw = json.load(fh)
    assert json.loads(json.dumps(population, cls=codec.EVQEPopulationJSONEncoder)) == raw


def test_reference_genomes_fixture_round_trips():
    """Each pinned genome of ``reference_genomes.json``, rebuilt from its
    seed in the port, encodes to the JAX package's text and decodes back
    to itself in both packages."""
    from queasars_tpu_torch.interop import individual_to_plain

    with open(os.path.join(FIXTURES, "reference_genomes.json")) as fh:
        entries = json.load(fh)
    for entry in entries:
        args = (entry["n_qubits"], entry["n_layers"], entry["randomize"])
        ours = genome.EVQEIndividual.random_individual(*args, random_seed=entry["seed"])
        plain = individual_to_plain(ours)
        assert [[[c for c, _ in layer], [p for _, p in layer]] for layer in plain["layers"]] \
            == entry["layers"]
        text = json.dumps(ours, cls=codec.EVQEPopulationJSONEncoder)
        theirs = jax_genome.EVQEIndividual.random_individual(*args, random_seed=entry["seed"])
        assert text == json.dumps(theirs, cls=jax_codec.EVQEPopulationJSONEncoder)
        assert json.loads(text, cls=codec.EVQEPopulationJSONDecoder) == ours
        assert list(json.loads(text, cls=jax_codec.EVQEPopulationJSONDecoder).parameter_values) \
            == entry["parameter_values"]


def _jssp_instances(pkg):
    return [
        pkg["jssp"].random_job_shop_scheduling_instance(
            f"wire-{seed}", n_jobs=3, n_machines=3, relative_op_amount=0.7,
            op_duration={1: 0.5, 2: 0.5}, random_seed=seed,
        )
        for seed in range(3)
    ]


def test_jssp_instances_and_results_round_trip_across_packages():
    encoders = (jssp_codec.JSSPJSONEncoder, jax_jssp_codec.JSSPJSONEncoder)
    for ours, theirs in zip(_jssp_instances(PORT), _jssp_instances(JAX)):
        ours_text = json.dumps(ours, cls=encoders[0])
        assert ours_text == json.dumps(theirs, cls=encoders[1])
        assert json.loads(ours_text, cls=jssp_codec.JSSPJSONDecoder) == ours
        assert json.loads(ours_text, cls=jax_jssp_codec.JSSPJSONDecoder) == theirs
        # a decoded schedule (valid or not) for the all-zero and a mixed state
        limit = 6
        port_encoder = jssp.JSSPDomainWallHamiltonianEncoder(ours, makespan_limit=limit)
        jax_encoder = jax_jssp.JSSPDomainWallHamiltonianEncoder(theirs, makespan_limit=limit)
        for state in (0, 0b1011):
            result_text = json.dumps(port_encoder.translate_result_state(state), cls=encoders[0])
            assert result_text == json.dumps(
                jax_encoder.translate_result_state(state), cls=encoders[1])
            assert json.dumps(json.loads(result_text, cls=jax_jssp_codec.JSSPJSONDecoder),
                              cls=encoders[1]) == result_text
            assert json.dumps(json.loads(result_text, cls=jssp_codec.JSSPJSONDecoder),
                              cls=encoders[0]) == result_text


def solver_result(pkg):
    """A result with every field set: two generations of one population,
    float32 energies as Python floats, a sampled distribution, a complex
    initial state and aux values."""
    population = evqe_population(pkg, 5)
    energies = [_f32([0.5 * i - 1.25])[0] for i in range(6)]
    evaluations = [
        pkg["base"].BasePopulationEvaluationResult(
            population=population, expectation_values=tuple(energies), best_individual=
            population.individuals[0], best_expectation_value=energies[0],
        )
        for _ in range(2)
    ]
    result = pkg["result"].EvolvingAnsatzMinimumEigensolverResult()
    result.eigenvalue = energies[0]
    result.eigenstate = {3: 0.5, 17: 0.375, 30: 0.125}
    result.best_individual = population.individuals[0]
    result.circuit_evaluations = [96, 120]
    result.generations = 2
    result.population_evaluation_results = evaluations
    state = np.zeros(32, dtype=np.complex128)
    state[0], state[5] = 0.6, 0.8j
    result.initial_state = state
    result.aux_operators_evaluated = [0.25, -1.5]
    return result


def _result_fields(result):
    return (
        result.eigenvalue, result.eigenstate, result.best_individual.parameter_values,
        result.circuit_evaluations, result.generations,
        [(e.expectation_values, e.best_expectation_value)
         for e in result.population_evaluation_results],
        np.asarray(result.initial_state).tolist(), result.aux_operators_evaluated,
    )


def test_result_text_equal_and_decoded_across_packages():
    encoder = result_codec.EvolvingAnsatzMinimumEigensolverResultJSONEncoder
    jax_encoder = jax_result_codec.EvolvingAnsatzMinimumEigensolverResultJSONEncoder
    ours = solver_result(PORT)
    text = json.dumps(ours, cls=encoder)
    assert text == json.dumps(solver_result(JAX), cls=jax_encoder)
    in_jax = json.loads(text, cls=jax_result_codec.EvolvingAnsatzMinimumEigensolverResultJSONDecoder)
    in_port = json.loads(text, cls=result_codec.EvolvingAnsatzMinimumEigensolverResultJSONDecoder)
    assert isinstance(in_port, result_module.EvolvingAnsatzMinimumEigensolverResult)
    assert _result_fields(in_jax) == _result_fields(in_port) == _result_fields(ours)
    assert in_port.best_individual == ours.best_individual
    assert json.dumps(in_jax, cls=jax_encoder) == json.dumps(in_port, cls=encoder) == text


@pytest.mark.parametrize("order", ["canonical", "qiskit"])
@pytest.mark.parametrize("seed", [0, 11])
def test_qasm_text_equals_the_jax_package(order, seed):
    ours = genome.EVQEIndividual.random_individual(12, 3, True, random_seed=seed)
    theirs = jax_genome.EVQEIndividual.random_individual(12, 3, True, random_seed=seed)
    with parameter_order(order), jax_genome.parameter_order(order):
        for measure in (False, True):
            assert qasm.individual_to_qasm(ours, measure) == \
                jax_qasm.individual_to_qasm(theirs, measure)


def test_qasm_of_the_interop_bundle():
    with open(os.path.join(FIXTURES, "interop_bundle.json")) as fh:
        bundle = json.load(fh)
    individual = json.loads(json.dumps(bundle["genome"]), cls=codec.EVQEPopulationJSONDecoder)
    assert qasm.individual_to_qasm(individual) == bundle["qasm"]
