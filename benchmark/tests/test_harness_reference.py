"""The plain reference against the port's plain engine and encoder at small
sizes (a test may import both; the reference imports neither the port nor
JAX), and the frozen instance generator against the port's."""

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.instances import instances_with_qubits, random_instance
from benchmark.reference import encoding, statevector

FAMILIES = [
    dict(n_jobs=2, n_machines=2, relative_op_amount=1.0, op_duration=1, makespan_limit=4, qubits=8),
    dict(n_jobs=3, n_machines=3, relative_op_amount=0.5, op_duration={"1": 0.5, "2": 0.5},
         makespan_limit=5, qubits=14),
    dict(n_jobs=3, n_machines=2, relative_op_amount=1.0, op_duration={"1": 0.7, "2": 0.3},
         makespan_limit=5, qubits=12),
]


@pytest.mark.parametrize("seed", range(0, 40, 3))
def test_the_generator_draws_the_ports_instances(seed):
    from queasars_tpu_torch.problems.jssp.random_instances import (
        random_job_shop_scheduling_instance,
    )

    mine = random_instance(FAMILIES[1], seed)
    theirs = random_job_shop_scheduling_instance("x", 3, 3, 0.5, {1: 0.5, 2: 0.5},
                                                 random_seed=seed)
    assert mine["jobs"] == [[[op.machine.name, op.processing_duration] for op in job.operations]
                            for job in theirs.jobs]


@pytest.mark.parametrize("family", FAMILIES)
def test_the_reference_table_equals_the_ports_hamiltonian(family):
    from queasars_tpu_torch.paulis import diagonal_energy_table

    for _, instance in instances_with_qubits(family, 0, 2):
        ref = encoding.energy_table(instance, family["makespan_limit"])
        hamiltonian = program.encode(instance, family["makespan_limit"])
        assert hamiltonian.n_qubits == family["qubits"] == encoding.n_qubits(
            instance, family["makespan_limit"])
        port = diagonal_energy_table(hamiltonian, dtype=torch.float64)
        assert float((ref - port).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_the_config_instances_have_their_widths_and_the_seeds_the_repo_ran():
    from benchmark import workload

    for name, seed in (("jssp20-exact", 0), ("jssp22-exact", 2)):
        family = workload.load("configs", name)["instance"]
        found = instances_with_qubits(family, family["first_seed"], 1)[0]
        assert found[0] == seed
        assert encoding.n_qubits(found[1], family["makespan_limit"]) == family["qubits"]


@pytest.mark.parametrize("n", [5, 9])
def test_the_reference_simulator_equals_the_ports_plain_engine(n):
    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.sim import slot_kernels
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    pop = EVQEPopulation.random_population(n, 4, 6, True, random_seed=n)
    packed = PackedPopulation.pack(list(pop.individuals), min_layers=4)
    tensors = packed_tensors(packed)
    probs = slot_kernels.probabilities(*tensors, n) if hasattr(slot_kernels, "probabilities") \
        else None
    table = torch.linspace(-3.0, 5.0, 1 << n, dtype=torch.float32)
    energies = slot_kernels.energies_exact_plain(*tensors, table, n)
    for p, individual in enumerate(pop.individuals):
        ref = statevector.probabilities(program.circuit(individual))
        assert float(ref.sum()) == pytest.approx(1.0, abs=1e-12)
        assert statevector.energy(ref, table.double()) == pytest.approx(float(energies[p]),
                                                                         abs=2e-6)
        if probs is not None:
            assert np.allclose(ref.numpy(), probs[p].double().numpy(), atol=1e-6)


def test_the_control_precision_reads_far_from_float64():
    family = FAMILIES[1]
    _, instance = instances_with_qubits(family, 0, 1)[0]
    ref = encoding.energy_table(instance, family["makespan_limit"])
    low = encoding.energy_table(instance, family["makespan_limit"], dtype=torch.bfloat16)
    assert float((low.double() - ref).abs().max()) > 1e-4 * float(ref.abs().max())
