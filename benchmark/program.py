"""The system under test: the calls the benchmark makes into the PyTorch and
CUDA port (``queasars_tpu_torch``), and the plain data it reads back from
the port's outputs for the reference to judge.

Imported only after the configuration's environment (``QUEASARS_MXU``) is
set, as a user sets it before importing the port.
"""

from __future__ import annotations

import heapq
from operator import itemgetter

import numpy as np

from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.genome.gates import EVQEGateType
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.problem_instances import (
    Job,
    JobShopSchedulingProblemInstance,
    Machine,
    Operation,
)
from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)

GATE_NAMES = {EVQEGateType.IDENTITY: "id", EVQEGateType.ROTATION: "u3",
              EVQEGateType.CONTROL: "ctrl", EVQEGateType.CONTROLLED_ROTATION: "cu3"}


def port_instance(instance: dict, name: str) -> JobShopSchedulingProblemInstance:
    """The port's instance object for plain instance data."""
    machines = sorted({m for ops in instance["jobs"] for m, _ in ops}, key=lambda m: int(m[1:]))
    jobs = tuple(
        Job(name=f"job{i}", operations=tuple(
            Operation(name=f"op{j}", job_name=f"job{i}", machine=Machine(m),
                      processing_duration=int(d))
            for j, (m, d) in enumerate(ops)))
        for i, ops in enumerate(instance["jobs"]))
    return JobShopSchedulingProblemInstance(
        name=name, machines=tuple(Machine(m) for m in machines), jobs=jobs)


def encode(instance: dict, makespan_limit: int, name: str = "bench"):
    """The port's problem Hamiltonian of ``instance``."""
    encoder = JSSPDomainWallHamiltonianEncoder(port_instance(instance, name),
                                               makespan_limit=makespan_limit)
    return encoder.get_problem_hamiltonian()


def solver(settings: dict, random_seed: int, device=None) -> EVQEMinimumEigensolver:
    """The configuration's EVQE solver with the exact estimator."""
    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        configured_sampler=None,
        optimizer=BatchedNFT(NFTConfig(maxiter=settings["nft_maxiter"])),
        optimizer_n_circuit_evaluations=None,
        max_generations=settings["max_generations"],
        max_circuit_evaluations=None,
        termination_criterion=None,
        random_seed=random_seed,
        population_size=settings["population_size"],
        speciation_genetic_distance_threshold=settings["speciation_genetic_distance_threshold"],
        selection_alpha_penalty=settings["selection_alpha_penalty"],
        selection_beta_penalty=settings["selection_beta_penalty"],
        parameter_search_probability=settings["parameter_search_probability"],
        topological_search_probability=settings["topological_search_probability"],
        layer_removal_probability=settings["layer_removal_probability"],
        pack_min_layers=settings["pack_min_layers"],
        shard_amplitudes=False,
        device=device,
    ))


def circuit(individual) -> dict:
    """An individual's circuit as plain data (see
    ``benchmark/reference/statevector.py``), its flat parameters read in the
    canonical order: layers, then qubits ascending, then (theta, phi,
    lambda)."""
    values = list(individual.parameter_values)
    layers, angles, cursor = [], [], 0
    for layer in individual.layers:
        gates, layer_angles = [], []
        for gate in layer.gates:
            kind = GATE_NAMES[gate.gate_type()]
            gates.append([kind, getattr(gate, "control_qubit_index", None)])
            if gate.n_parameters():
                layer_angles.append([float(v) for v in values[cursor:cursor + 3]])
                cursor += 3
            else:
                layer_angles.append(None)
        layers.append(gates)
        angles.append(layer_angles)
    return {"n_qubits": individual.n_qubits, "layers": layers, "angles": angles}


def solve_answer(result, hamiltonian, leading: int) -> dict:
    """What a solve reports, as plain data: the eigenvalue, the best
    individual's circuit, the ``leading`` likeliest bitstrings with their
    probabilities, the energies the port's Hamiltonian gives them, and the
    final generation's individuals (circuits) with the energies the solve
    reports for them."""
    top = heapq.nlargest(leading, result.eigenstate.items(), key=itemgetter(1))
    states = np.array([s for s, _ in top], dtype=np.uint64)
    coeffs = hamiltonian.coeffs.real.astype(np.float64)
    masks = hamiltonian.z_masks_lo64().astype(np.uint64)
    energies = []
    for state in states:
        parity = np.array([bin(int(m & state)).count("1") & 1 for m in masks])
        energies.append(float(np.sum(coeffs * (1.0 - 2.0 * parity))))
    final = result.population_evaluation_results[-1]
    population = [[circuit(individual), None if value is None else float(value)]
                  for individual, value in zip(final.population.individuals,
                                               final.expectation_values)]
    return {"eigenvalue": float(result.eigenvalue), "circuit": circuit(result.best_individual),
            "states": [int(s) for s in states], "probabilities": [float(p) for _, p in top],
            "state_energies": energies, "population": population}


class Energies:
    """The evaluator of the ``energies`` mix on a fixed population."""

    def __init__(self, hamiltonian, plan, device=None):
        population = EVQEPopulation.random_population(
            hamiltonian.n_qubits, plan.layers, plan.population, True,
            random_seed=plan.genome_seed)
        self.individuals = list(population.individuals)
        self.packed = PackedPopulation.pack(self.individuals, min_layers=plan.min_layers)
        self.evaluator = StatevectorExpectationEvaluator(operator=hamiltonian, device=device)
        self.shape = self.packed.angles.shape

    def __call__(self, angles: np.ndarray) -> np.ndarray:
        return self.evaluator.evaluate_packed(self.packed, angles=angles)

    def circuits(self, angles: np.ndarray) -> list[dict]:
        """The population's circuits at ``angles`` [P, L, n, 3], as plain
        data: slot ``q`` of layer ``l`` takes ``angles[p, l, q]``."""
        out = []
        for p, individual in enumerate(self.individuals):
            plain = circuit(individual)
            plain["angles"] = [
                [None if a is None else [float(x) for x in angles[p, l, q]]
                 for q, a in enumerate(layer)]
                for l, layer in enumerate(plain["angles"])]
            out.append(plain)
        return out
