"""``AmplitudeShardedExpectationEvaluator`` of the port
(``queasars_tpu_torch/sim/sharded_evaluator.py``) against the JAX
package's on the same (2, 4) mesh shape (the port's cells ``["cpu"] * 8``,
the JAX package's 8 virtual CPU devices), on the same seeded population.

Every evaluation path agrees to 1e-5 * max|table| (general operators: to
1e-5 * sum|c|): exact energies on the fold and the per-gate route, shots
with and without CVaR, exact CVaR, ``precision``, the host-built table,
an array and an ``EVQEIndividual`` start state, a general operator's exact
energies and its grouped shots under both allocations.  Exact, shot,
exact-CVaR and grouped-shot energies are bit-identical across the 1x8,
2x4, 4x2 and 8x1 factorizations of the port's mesh, and the shot stream
advances its counter as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.paulis import pauli_z_string as jax_z
from queasars_tpu.problems.spin_chains import transverse_field_ising as jax_tfim
from queasars_tpu.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator as JaxEval
from queasars_tpu.sim.sharded_evaluator import pop_amp_mesh as jax_pop_amp_mesh
from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.parallel.amplitude import pop_amp_mesh
from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
from queasars_tpu_torch.sim.evaluators import CircuitEvaluatorException
from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator

N = 10
CELLS = ["cpu"] * 8
FACTORIZATIONS = [(1, 8), (2, 4), (4, 2), (8, 1)]

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's many small torch operations on one thread: under
    the suite's parallel workers, torch's intra-op pool on every worker
    oversubscribes the cores and multiplies these tests' time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _ising(sum_cls, z_string):
    rng = np.random.default_rng(0)
    weights = rng.normal(size=12)
    pairs = [rng.choice(N, size=2, replace=False) for _ in range(12)]
    return sum_cls.sum([z_string(int(a), N) @ z_string(int(b), N) * float(w)
                        for (a, b), w in zip(pairs, weights)]
                       + [z_string(q, N) * 0.3 for q in range(N)])


@pytest.fixture(scope="module")
def problem():
    ours = EVQEPopulation.random_population(N, 3, 5, True, random_seed=3)
    theirs = JaxPopulation.random_population(N, 3, 5, True, random_seed=3)
    return dict(
        packed=PackedPopulation.pack(list(ours.individuals)),
        packed_ref=JaxPacked.pack(list(theirs.individuals)),
        ising=_ising(PauliSum, pauli_z_string), ising_ref=_ising(JaxPauliSum, jax_z),
        tfim=transverse_field_ising(N, coupling=1.0, field=0.9),
        tfim_ref=jax_tfim(N, coupling=1.0, field=0.9),
        individual=ours.individuals[1], individual_ref=theirs.individuals[1],
    )


def _start_state():
    state = np.zeros(1 << N, complex)
    state[3], state[17], state[600] = 0.6, 0.48j, 0.64
    return state


PATHS = {
    "exact fold": dict(),
    "exact per-gate": dict(use_fold=False),
    "shots": dict(shots=256, seed=5),
    "shots CVaR": dict(shots=256, seed=5, alpha=0.3),
    "exact CVaR": dict(alpha=0.3),
    "exact CVaR per-gate": dict(alpha=0.3, use_fold=False),
    "precision": dict(precision=0.05, seed=2),
    "host table": dict(table_mode="host"),
    "array start": dict(initial_state="array"),
    "individual start": dict(initial_state="individual", use_fold=False),
    "general exact": dict(operator="tfim"),
    "general grouped": dict(operator="tfim", shots=128, seed=3),
    "general proportional": dict(operator="tfim", shots=128, seed=3,
                                 shot_allocation="proportional"),
}


def _kwargs(problem, settings, ref: bool):
    kwargs = dict(settings)
    operator = kwargs.pop("operator", "ising")
    start = kwargs.pop("initial_state", None)
    if start == "array":
        kwargs["initial_state"] = _start_state()
    elif start == "individual":
        kwargs["initial_state"] = problem["individual_ref" if ref else "individual"]
    return problem[operator + ("_ref" if ref else "")], kwargs


@pytest.mark.parametrize("path", list(PATHS))
def test_evaluator_path_matches_jax(problem, path):
    operator_ref, kwargs_ref = _kwargs(problem, PATHS[path], ref=True)
    operator, kwargs = _kwargs(problem, PATHS[path], ref=False)
    want = np.asarray(JaxEval(operator_ref, jax_pop_amp_mesh(2, 4), **kwargs_ref)
                      .evaluate_packed(problem["packed_ref"]))
    got = AmplitudeShardedExpectationEvaluator(
        operator, pop_amp_mesh(2, 4, devices=CELLS), **kwargs).evaluate_packed(problem["packed"])
    scale = float(np.abs(operator.coeffs).sum())
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)


@pytest.mark.parametrize("path", ["exact fold", "exact per-gate", "shots CVaR", "exact CVaR",
                                  "general exact", "general grouped"])
def test_every_factorization_gives_equal_bits(problem, path):
    operator, kwargs = _kwargs(problem, PATHS[path], ref=False)
    results = []
    for n_pop, n_amp in FACTORIZATIONS:
        evaluator = AmplitudeShardedExpectationEvaluator(
            operator, pop_amp_mesh(n_pop, n_amp, devices=CELLS), **kwargs)
        first = evaluator.evaluate_packed(problem["packed"])
        results.append((first, evaluator.evaluate_packed(problem["packed"])))
    for other in results[1:]:
        np.testing.assert_array_equal(other[0], results[0][0])
        np.testing.assert_array_equal(other[1], results[0][1])


def test_shot_stream_counter_and_overrides(problem):
    mesh = pop_amp_mesh(2, 4, devices=CELLS)
    evaluator = AmplitudeShardedExpectationEvaluator(problem["ising"], mesh, shots=64, seed=1)
    first = evaluator.evaluate_packed(problem["packed"])
    assert evaluator._counter == 1
    second = evaluator.evaluate_packed(problem["packed"])
    assert not np.array_equal(first, second)
    evaluator._counter = 0
    np.testing.assert_array_equal(evaluator.evaluate_packed(problem["packed"]), first)
    exact = AmplitudeShardedExpectationEvaluator(problem["ising"], mesh)
    angles = problem["packed"].angles + 0.25
    overridden = exact.evaluate_packed(problem["packed"], angles=angles)
    assert overridden.shape == (problem["packed"].n_individuals,)
    assert not np.array_equal(overridden, exact.evaluate_packed(problem["packed"]))


def test_refusals(problem):
    mesh = pop_amp_mesh(2, 4, devices=CELLS)
    with pytest.raises(CircuitEvaluatorException, match="diagonal"):
        AmplitudeShardedExpectationEvaluator(problem["tfim"], mesh, alpha=0.5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        AmplitudeShardedExpectationEvaluator(problem["ising"], mesh, shots=8, precision=0.1)
    for bad in (dict(alpha=0.0), dict(precision=-1.0), dict(table_mode="disk"),
                dict(shot_allocation="even")):
        with pytest.raises(ValueError):
            AmplitudeShardedExpectationEvaluator(problem["ising"], mesh, **bad)
    with pytest.raises(ValueError, match="folded_bits"):
        AmplitudeShardedExpectationEvaluator(
            problem["ising"], pop_amp_mesh(1, 16, devices=["cpu"] * 16), use_fold=True)
