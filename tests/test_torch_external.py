"""The port's external-evaluator seam (``sim/external.py``) and the
host-stepped optimizers it drives, against the JAX package's.

The JAX package's ``tests/test_external_evaluator.py`` cases run on the
port: validation, structure and rebinding, ``resolve_injected_evaluator``,
the ``initial_state`` refusal, the aux-operator rules and a configured
sampler for the final distribution.  Then one numpy dense-oracle callback
(float64, independent of both packages' engines) drives an EVQE solve with
NFT and an SPSA ``minimize`` call in both packages: both run the same numpy
arithmetic on the same callback values, so energies, angles and genomes are
equal bit for bit; the final distribution comes from each package's own
engine and agrees to 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest

import queasars_tpu.genome as jax_genome
import queasars_tpu.genome.packing as jax_packing
import queasars_tpu.optim as jax_optim
import queasars_tpu.sim.external as jax_external
import queasars_tpu.solver as jax_solver
import queasars_tpu_torch.genome as port_genome
import queasars_tpu_torch.genome.packing as port_packing
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu_torch.genome import EVQEIndividual, PackedPopulation
from queasars_tpu_torch.interop import individual_from_plain, individual_to_plain, pauli_sum_from_numpy
from queasars_tpu_torch.optim import BatchedNFT, BatchedSPSA, NFTConfig, SPSAConfig
from queasars_tpu_torch.optim.cobyla import CobylaConfig, ScipyCobyla
from queasars_tpu_torch.sim.evaluators import (
    CircuitEvaluatorException,
    StatevectorExpectationEvaluator,
)
from queasars_tpu_torch.sim.external import CallbackCircuitEvaluator, resolve_injected_evaluator
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    ConfiguredSampler,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.sim.statevector import GATE_CROT, GATE_ROT

from tests.test_reference_anchor import N_QUBITS, build_hamiltonian, decode
from tests.test_statevector import dense_layer


def port_hamiltonian():
    reference = build_hamiltonian()
    return pauli_sum_from_numpy(reference.n_qubits, reference.z, reference.x, reference.coeffs)


class DenseOracleBackend:
    """Mock external backend: a dense numpy float64 simulator measuring a
    diagonal table.  It takes either package's genomes (through their
    structure, rebuilt as port genomes), so one instance of its arithmetic
    serves both."""

    def __init__(self, table, n_qubits):
        self.table = np.asarray(table, dtype=np.float64)
        self.n_qubits = n_qubits
        self.calls = 0
        self.circuits_seen = 0

    def evaluate_circuits(self, circuits, parameter_values):
        assert GATE_ROT == 1 and GATE_CROT == 3
        self.calls += 1
        self.circuits_seen += len(circuits)
        energies = []
        for individual, params in zip(circuits, parameter_values):
            plain = dict(individual_to_plain(individual), parameter_values=list(params))
            packed = PackedPopulation.pack([individual_from_plain(plain)])
            state = np.zeros(1 << self.n_qubits, dtype=np.complex128)
            state[0] = 1.0
            for layer in range(packed.max_layers):
                if packed.layer_mask[0, layer]:
                    state = dense_layer(
                        packed.gate_types[0, layer], packed.controls[0, layer],
                        packed.angles[0, layer], self.n_qubits,
                    ) @ state
            energies.append(float((np.abs(state) ** 2) @ self.table))
        return energies


def anchor_backend():
    """The dense oracle on the anchor Hamiltonian's diagonal (the JAX
    package's table, as float64)."""
    return DenseOracleBackend(jax_table(build_hamiltonian()), N_QUBITS)


def _settings(**overrides):
    settings = dict(
        configured_estimator=None,
        configured_sampler=None,
        optimizer_n_circuit_evaluations=10,
        max_generations=3,
        max_circuit_evaluations=None,
        termination_criterion=None,
        random_seed=0,
        population_size=6,
        randomize_initial_population_parameters=False,
        speciation_genetic_distance_threshold=3,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1,
        parameter_search_probability=0.24,
        topological_search_probability=0.2,
        layer_removal_probability=0.05,
    )
    settings.update(overrides)
    return settings


def _config(**overrides):
    settings = _settings(**overrides)
    settings.setdefault("optimizer", BatchedNFT(NFTConfig(maxiter=10)))
    return EVQEMinimumEigensolverConfiguration(device="cpu", **settings)


def _callback(backend, n_qubits=N_QUBITS, **kwargs):
    return CallbackCircuitEvaluator(backend.evaluate_circuits, n_qubits, device="cpu", **kwargs)


def test_callback_evaluator_validates_inputs():
    with pytest.raises(CircuitEvaluatorException, match="callable"):
        CallbackCircuitEvaluator("not callable", n_qubits=3, device="cpu")
    evaluator = CallbackCircuitEvaluator(lambda c, p: [0.0] * len(c), n_qubits=3, device="cpu")
    population = [EVQEIndividual.random_individual(3, 1, True, random_seed=s) for s in (0, 1)]
    packed = PackedPopulation.pack(population)
    assert evaluator.evaluate_packed(packed).shape == (2,)
    evaluator5 = CallbackCircuitEvaluator(lambda c, p: [0.0] * len(c), n_qubits=5, device="cpu")
    with pytest.raises(CircuitEvaluatorException, match="measures 5"):
        evaluator5.evaluate_packed(packed)
    bad = CallbackCircuitEvaluator(lambda c, p: [0.0], n_qubits=3, device="cpu")
    with pytest.raises(CircuitEvaluatorException, match="energies"):
        bad.evaluate_packed(packed)


def test_callback_receives_structure_and_rebinding():
    seen = {}

    def backend(circuits, parameter_values):
        seen["circuits"] = circuits
        seen["params"] = parameter_values
        return [float(sum(p)) for p in parameter_values]

    individual = EVQEIndividual.random_individual(3, 1, True, random_seed=7)
    evaluator = CallbackCircuitEvaluator(backend, n_qubits=3, device="cpu")
    packed = PackedPopulation.pack([individual])
    probe = packed.angles + 0.5
    out = evaluator.evaluate_packed(packed, angles=probe)
    assert seen["circuits"][0] is individual
    expected_flat = packed.angles_to_flat(0, probe[0])
    assert seen["params"][0] == expected_flat
    np.testing.assert_allclose(out[0], sum(expected_flat), rtol=1e-6)
    # the reference signature, directly and through the base class's shim
    assert evaluator.evaluate_circuits([individual], [expected_flat]) == [float(sum(expected_flat))]
    internal = StatevectorExpectationEvaluator(port_hamiltonian(), device="cpu")
    anchor = EVQEIndividual.random_individual(N_QUBITS, 2, True, random_seed=3)
    values = tuple(v + 0.25 for v in anchor.parameter_values)
    assert internal.evaluate_circuits([anchor], [values]) == internal.evaluate_individuals(
        [EVQEIndividual.change_parameter_values(anchor, values)])


def test_resolve_injected_evaluator_shapes():
    hamiltonian = port_hamiltonian()
    backend = anchor_backend()
    instance = _callback(backend)
    assert resolve_injected_evaluator(instance, hamiltonian) is instance
    factory_calls = []

    def factory(operator):
        factory_calls.append(operator)
        return _callback(backend, operator.n_qubits)

    assert isinstance(resolve_injected_evaluator(factory, hamiltonian), CallbackCircuitEvaluator)
    assert factory_calls == [hamiltonian]
    with pytest.raises(CircuitEvaluatorException, match="measures"):
        resolve_injected_evaluator(_callback(backend, 7), hamiltonian)
    with pytest.raises(CircuitEvaluatorException, match="factory"):
        resolve_injected_evaluator(lambda op: "nope", hamiltonian)
    with pytest.raises(CircuitEvaluatorException, match="BaseCircuitEvaluator"):
        resolve_injected_evaluator(42, hamiltonian)


def test_injected_evaluator_rejects_initial_state():
    solver = EVQEMinimumEigensolver(_config(evaluator=_callback(anchor_backend())))
    with pytest.raises(CircuitEvaluatorException, match="initial_state"):
        solver.compute_minimum_eigenvalue_with_initial_state(
            port_hamiltonian(), initial_state=np.eye(1, 1 << N_QUBITS, 0, dtype=np.complex64)[0]
        )


def test_config_requires_some_evaluation_path():
    with pytest.raises(ValueError, match="external evaluator"):
        _config()


def test_aux_operators_with_instance_need_primitives_or_factory():
    hamiltonian = port_hamiltonian()
    instance = _callback(anchor_backend())
    solver = EVQEMinimumEigensolver(_config(evaluator=instance))
    with pytest.raises(CircuitEvaluatorException, match="factory"):
        solver.compute_minimum_eigenvalue(hamiltonian, aux_operators=[hamiltonian])

    solver = EVQEMinimumEigensolver(_config(
        evaluator=instance, configured_estimator=ConfiguredEstimator(precision=None, seed=0),
        max_generations=1,
    ))
    result = solver.compute_minimum_eigenvalue(hamiltonian, aux_operators=[hamiltonian])
    assert len(result.aux_operators_evaluated) == 1

    solver = EVQEMinimumEigensolver(_config(
        evaluator=lambda operator: _callback(anchor_backend(), operator.n_qubits),
        max_generations=1,
    ))
    result = solver.compute_minimum_eigenvalue(hamiltonian, aux_operators={"h": hamiltonian})
    assert set(result.aux_operators_evaluated) == {"h"}
    internal = StatevectorExpectationEvaluator(hamiltonian, device="cpu")
    expected = internal.evaluate_individuals([result.best_individual])[0]
    np.testing.assert_allclose(result.aux_operators_evaluated["h"], expected, atol=1e-5)


def test_final_distribution_honors_the_configured_sampler():
    configuration = _config(
        evaluator=_callback(anchor_backend()),
        configured_sampler=ConfiguredSampler(shots=64, seed=3),
        max_generations=2,
    )
    result = EVQEMinimumEigensolver(configuration).compute_minimum_eigenvalue(port_hamiltonian())
    weights = np.array(list(result.eigenstate.values()))
    np.testing.assert_allclose(weights * 64, np.round(weights * 64), atol=1e-6)


def test_internal_energies_through_the_callback():
    """A callback returning the port's own internal energies reproduces
    ``evaluate_packed`` exactly (the plumbing does not distort values), and
    the dense oracle agrees with it to float32 rounding."""
    hamiltonian = port_hamiltonian()
    internal = StatevectorExpectationEvaluator(hamiltonian, device="cpu")
    population = [EVQEIndividual.random_individual(N_QUBITS, 2, True, random_seed=s)
                  for s in range(4)]
    packed = PackedPopulation.pack(population)
    via_callback = _callback(
        type("Internal", (), {"evaluate_circuits": staticmethod(internal.evaluate_circuits)})
    ).evaluate_packed(packed)
    np.testing.assert_array_equal(via_callback, internal.evaluate_packed(packed))
    np.testing.assert_allclose(_callback(anchor_backend()).evaluate_packed(packed),
                               internal.evaluate_packed(packed), atol=1e-5)


@pytest.fixture(scope="module")
def both_solves():
    """One EVQE solve with host-stepped NFT per package through one dense
    oracle callback, each with a 64-shot configured sampler for the final
    distribution."""
    ours = EVQEMinimumEigensolver(_config(
        evaluator=_callback(anchor_backend()), population_size=5,
    )).compute_minimum_eigenvalue(port_hamiltonian())
    reference = build_hamiltonian()
    jax_settings = _settings(population_size=5)
    theirs = jax_solver.EVQEMinimumEigensolver(jax_solver.EVQEMinimumEigensolverConfiguration(
        optimizer=jax_optim.BatchedNFT(jax_optim.NFTConfig(maxiter=10)),
        evaluator=jax_external.CallbackCircuitEvaluator(
            anchor_backend().evaluate_circuits, N_QUBITS),
        **jax_settings,
    )).compute_minimum_eigenvalue(reference)
    return ours, theirs


def test_external_nft_solve_equals_the_jax_package(both_solves):
    ours, theirs = both_solves
    assert ours.generations == theirs.generations == 3
    assert ours.circuit_evaluations == theirs.circuit_evaluations
    for got, want in zip(ours.population_evaluation_results, theirs.population_evaluation_results):
        assert got.expectation_values == want.expectation_values
        assert [individual_to_plain(i) for i in got.population.individuals] == \
            [individual_to_plain(i) for i in want.population.individuals]
    assert ours.eigenvalue == theirs.eigenvalue
    assert individual_to_plain(ours.best_individual) == individual_to_plain(theirs.best_individual)
    states = set(ours.eigenstate) | set(theirs.eigenstate)
    for state in states:
        assert abs(ours.eigenstate.get(state, 0.0) - theirs.eigenstate.get(state, 0.0)) <= 1e-6
    likeliest = max(ours.eigenstate.items(), key=lambda kv: kv[1])[0]
    assert decode(likeliest) == decode(max(theirs.eigenstate.items(), key=lambda kv: kv[1])[0])


def _spsa_problem(pkg_genome, pkg_packing, seed_base):
    population = [pkg_genome.EVQEIndividual.random_individual(N_QUBITS, 2, True, random_seed=s)
                  for s in range(seed_base, seed_base + 3)]
    packed = pkg_packing.PackedPopulation.pack(population)
    coords_list = [packed.param_coordinates(i) for i in range(3)]
    k_max = max(c.shape[0] for c in coords_list)
    coords = np.zeros((3, k_max, 3), np.int32)
    for i, c in enumerate(coords_list):
        coords[i, : c.shape[0]] = c
    return packed, coords, packed.n_params.copy(), np.ones(3, bool)


@pytest.mark.parametrize("learning_rate", [0.2, None])
def test_host_spsa_equals_the_jax_package_and_descends(learning_rate):
    config = dict(maxiter=30, learning_rate=learning_rate, perturbation=0.15,
                  calibration_steps=4)
    backend = anchor_backend()
    packed, coords, n_free, active = _spsa_problem(
        port_genome, port_packing, 0,
    )
    external = _callback(backend)
    before = external.evaluate_packed(packed)
    angles, energies, nfev = BatchedSPSA(SPSAConfig(**config)).minimize(
        external, packed, coords, n_free, active, seed=5)
    after = external.evaluate_packed(packed, angles=angles)
    assert nfev == 61 + (0 if learning_rate else 8)
    assert after.sum() < before.sum()
    np.testing.assert_array_equal(energies, after)

    jax_packed, jax_coords, jax_free, jax_active = _spsa_problem(jax_genome, jax_packing, 0)
    jax_angles, jax_energies, jax_nfev = jax_optim.BatchedSPSA(
        jax_optim.SPSAConfig(**config)).minimize(
        jax_external.CallbackCircuitEvaluator(anchor_backend().evaluate_circuits, N_QUBITS),
        jax_packed, jax_coords, jax_free, jax_active, seed=5)
    assert nfev == jax_nfev
    np.testing.assert_array_equal(angles, np.asarray(jax_angles))
    np.testing.assert_array_equal(energies, np.asarray(jax_energies))


def test_host_nft_minimize_equals_the_jax_package():
    packed, coords, n_free, active = _spsa_problem(
        port_genome, port_packing, 3,
    )
    angles, energies, nfev = BatchedNFT(NFTConfig(maxiter=12, reset_interval=5)).minimize(
        _callback(anchor_backend()), packed, coords, n_free, active)
    jax_packed, jax_coords, jax_free, jax_active = _spsa_problem(jax_genome, jax_packing, 3)
    jax_angles, jax_energies, jax_nfev = jax_optim.BatchedNFT(
        jax_optim.NFTConfig(maxiter=12, reset_interval=5)).minimize(
        jax_external.CallbackCircuitEvaluator(anchor_backend().evaluate_circuits, N_QUBITS),
        jax_packed, jax_coords, jax_free, jax_active)
    assert nfev == jax_nfev
    np.testing.assert_array_equal(angles, np.asarray(jax_angles))
    np.testing.assert_array_equal(energies, np.asarray(jax_energies))


def test_cobyla_and_minimize_slots_take_a_callback_evaluator():
    packed, coords, n_free, active = _spsa_problem(
        port_genome, port_packing, 6,
    )
    external = _callback(anchor_backend())
    slots = (coords[:, None], n_free[:, None], active[:, None], np.zeros((3, 1), np.int64))
    assert BatchedNFT().minimize_slots(external, packed, *slots) is None
    assert BatchedSPSA().minimize_slots(external, packed, *slots) is None
    before = external.evaluate_packed(packed)
    angles, energies, nfev = ScipyCobyla(CobylaConfig(maxiter=20)).minimize(
        external, packed, coords, n_free, active)
    assert nfev > 0 and energies.sum() <= before.sum()
    np.testing.assert_array_equal(energies, external.evaluate_packed(packed, angles=angles))
