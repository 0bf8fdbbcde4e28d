"""The port's problem encoders and host oracles against the JAX package's
(CPU): every QUBO-family encoder's Pauli sum term for term (masks and
coefficients equal, in order) with its offset, the integer program's
decoding, the exact JSSP oracle's schedule and the bitstring objective's
validation.  All of it is host numpy in both packages, so equality is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from queasars_tpu.problems import qubo as jax_qubo
from queasars_tpu.problems.jssp.exact_solver import solve_jssp_exact as jax_solve_exact
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu.utils.bitstring_evaluation import BitstringEvaluator as JaxBitstringEvaluator
from queasars_tpu_torch.problems import (
    BoundedIntegerVariable,
    IntegerQuadraticProgram,
    decode_qubo_bits,
    maxcut_hamiltonian,
    qubo_hamiltonian,
)
from queasars_tpu_torch.problems import qubo
from queasars_tpu_torch.problems.jssp import random_job_shop_scheduling_instance, solve_jssp_exact
from queasars_tpu_torch.utils import BitstringEvaluator
from queasars_tpu_torch.utils.bitstring_evaluation import BitstringEvaluationException


def _same_terms(got, want):
    (op, offset), (op_ref, offset_ref) = got, want
    assert op.n_qubits == op_ref.n_qubits
    np.testing.assert_array_equal(op.z, op_ref.z)
    np.testing.assert_array_equal(op.x, op_ref.x)
    np.testing.assert_array_equal(op.coeffs, op_ref.coeffs)
    assert offset == offset_ref


def _graph(n, p, seed):
    rng = np.random.default_rng(seed)
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if rng.random() < p]
    return edges, [float(w) for w in rng.uniform(0.5, 2.0, len(edges))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qubo_terms_equal_jax(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(6, 6))
    q[rng.random((6, 6)) < 0.3] = 0.0
    linear = rng.normal(size=6)
    _same_terms(qubo_hamiltonian(q, linear, 1.5), jax_qubo.qubo_hamiltonian(q, linear, 1.5))
    _same_terms(qubo_hamiltonian(np.zeros((3, 3))), jax_qubo.qubo_hamiltonian(np.zeros((3, 3))))


@pytest.mark.parametrize("weighted", [False, True])
def test_maxcut_terms_equal_jax(weighted):
    edges, weights = _graph(7, 0.5, 3)
    w = weights if weighted else None
    _same_terms(maxcut_hamiltonian(7, edges, w), jax_qubo.maxcut_hamiltonian(7, edges, w))
    with pytest.raises(ValueError):
        maxcut_hamiltonian(3, [(0, 0)])


def test_tsp_and_colouring_terms_equal_jax():
    d = np.random.default_rng(5).uniform(1.0, 9.0, size=(3, 3))
    _same_terms(qubo.tsp_hamiltonian(d), jax_qubo.tsp_hamiltonian(d))
    _same_terms(qubo.tsp_hamiltonian(d, penalty=7.0), jax_qubo.tsp_hamiltonian(d, penalty=7.0))
    edges, _ = _graph(4, 0.6, 1)
    _same_terms(
        qubo.graph_coloring_hamiltonian(4, edges, 3, penalty=2.0, conflict_weight=0.5),
        jax_qubo.graph_coloring_hamiltonian(4, edges, 3, penalty=2.0, conflict_weight=0.5),
    )
    for state in (0, 0b100010001, 0b010001100, 511):
        assert qubo.decode_tsp_tour(state, 3) == jax_qubo.decode_tsp_tour(state, 3)
        assert qubo.decode_coloring(state, 3, 3) == jax_qubo.decode_coloring(state, 3, 3)
    assert qubo.tour_length([0, 2, 1], d) == jax_qubo.tour_length([0, 2, 1], d)


def test_integer_program_equals_jax():
    def build(module):
        program = module.IntegerQuadraticProgram()
        x = program.integer_var(0, 3, "x")
        y = program.integer_var(-2, 4, "y")
        program.minimize(quadratic={(x, x): 1.0, (x, y): -0.5, (y, y): 0.25},
                         linear={x: 0.3, y: -1.0}, constant=2.0)
        return program

    program, reference = build(qubo), build(jax_qubo)
    assert program.n_qubits == reference.n_qubits
    _same_terms(program.to_ising(), reference.to_ising())
    for state in range(1 << program.n_qubits):
        values = program.decode(state)
        assert values == reference.decode(state)
        assert program.objective_value(values) == reference.objective_value(values)
    variable = BoundedIntegerVariable("v", 1, 11)
    reference_variable = jax_qubo.BoundedIntegerVariable("v", 1, 11)
    assert variable.coefficients == reference_variable.coefficients
    assert decode_qubo_bits(0b1011, 5) == jax_qubo.decode_qubo_bits(0b1011, 5)
    assert isinstance(program, IntegerQuadraticProgram)


@pytest.mark.parametrize("seed", [0, 4])
def test_exact_jssp_oracle_equals_jax(seed):
    settings = dict(instance_name="ex", n_jobs=3, n_machines=2, relative_op_amount=0.7,
                    op_duration={1: 0.5, 2: 0.5}, random_seed=seed)
    got = solve_jssp_exact(random_job_shop_scheduling_instance(**settings))
    want = jax_solve_exact(jax_random_instance(**settings))
    assert got.makespan == want.makespan
    assert [[(op.operation.identifier, op.start_time) for op in ops]
            for ops in got.schedule.values()] == [
        [(op.operation.identifier, op.start_time) for op in ops]
        for ops in want.schedule.values()]
    assert solve_jssp_exact(random_job_shop_scheduling_instance(**settings),
                            makespan_limit=got.makespan - 1) is None


def test_bitstring_evaluator_validates_as_jax():
    fn = lambda bits: float(bits.count("1"))  # noqa: E731
    ours, reference = BitstringEvaluator(4, fn), JaxBitstringEvaluator(4, fn)
    assert ours.evaluate_bitstring("1011") == reference.evaluate_bitstring("1011") == 3.0
    for bad in ("101", "10a1"):
        with pytest.raises(BitstringEvaluationException):
            ours.evaluate_bitstring(bad)
    with pytest.raises(BitstringEvaluationException):
        BitstringEvaluator(2, lambda bits: "x").evaluate_bitstring("01")
    with pytest.raises(ValueError):
        BitstringEvaluator(0, fn)
