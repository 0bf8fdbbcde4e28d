"""The port's SPSA, its termination checker and COBYLA against the JAX
package's, on one packed 7-qubit population (CPU).

The key stream is compared bit for bit: keys, probe keys, sampler uniforms
and the Rademacher directions.  Calibration magnitudes agree to 1e-5
relative.  Whole searches are compared as energies re-evaluated through the
JAX evaluator, to 1e-4 * max|table|.

SPSA at calibrated rates is chaotic: each step moves every coordinate by
about pi, so a difference in an angle grows by 3-10x per step (on this
JSSP table, the ulp-level rounding difference of the two simulators is
1e-5 rad after step 1 and 1e-2 rad after step 10).  So the calibrated exact
searches run 5 steps, where that growth stays inside the bar; at a fixed
learning rate of 2e-4 (steps of about 0.1 rad) the searches run 10 steps;
the sampled search runs 10, its shot energies being equal from equal keys.
COBYLA's decisions compare float32 energies, and past 20 iterations a near
tie on this table goes the other way in one of the two; it runs 20.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.optim.cobyla import CobylaConfig as JaxCobylaConfig
from queasars_tpu.optim.cobyla import ScipyCobyla as JaxCobyla
from queasars_tpu.optim.spsa import BatchedSPSA as JaxSPSA
from queasars_tpu.optim.spsa import SPSAConfig as JaxSPSAConfig
from queasars_tpu.optim.spsa import _spsa_calibrate
from queasars_tpu.optim.spsa_termination import SPSATerminationChecker as JaxChecker
from queasars_tpu.problems.jssp import JSSPDomainWallHamiltonianEncoder as JaxEncoder
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu_torch.optim import (
    BatchedSPSA,
    CobylaConfig,
    ScipyCobyla,
    SPSAConfig,
    SPSATerminationChecker,
)
from queasars_tpu_torch.optim.objective import objective_operands
from queasars_tpu_torch.optim.spsa import _probe_keys, _Search, rademacher
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance
from queasars_tpu_torch.sim.evaluators import (
    SamplerExpectationEvaluator,
    StatevectorExpectationEvaluator,
    packed_tensors,
)
from queasars_tpu_torch.utils import prng
from tests.test_torch_optim import _last_layer_coords, _problem

INSTANCE = dict(instance_name="t7", n_jobs=2, n_machines=2, relative_op_amount=0.5,
                op_duration={1: 0.5, 2: 0.5}, random_seed=0)
SEED = 3


@pytest.fixture(scope="module")
def jssp():
    """(port operator, JAX operator, max|table|) of a 7-qubit JSSP."""
    op = JSSPDomainWallHamiltonianEncoder(
        random_job_shop_scheduling_instance(**INSTANCE), makespan_limit=5
    ).get_problem_hamiltonian()
    op_ref = JaxEncoder(jax_random_instance(**INSTANCE), makespan_limit=5).get_problem_hamiltonian()
    return op, op_ref, float(np.abs(np.asarray(JaxEvaluator(op_ref)._table)).max())


def _last_layer_problem():
    p, q = _problem(7)
    coords, n_free = _last_layer_coords(p)
    last = p.layer_mask.sum(axis=1).astype(np.int32) - 1
    return p, q, coords, n_free, n_free > 0, last


def _close_as_energies(op_ref, q, a, a_ref, tol):
    ref = JaxEvaluator(op_ref)
    np.testing.assert_allclose(
        ref.evaluate_packed(q, angles=a), ref.evaluate_packed(q, angles=a_ref), atol=tol, rtol=0
    )


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("length", [1, 7, 33])
def test_rademacher_directions_equal_jax_bit_for_bit(seed, length):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    want = np.asarray(jax.random.rademacher(key, (length,), dtype=jnp.float32))
    got = rademacher(prng.fold_in(prng.PRNGKey(seed), 5), length)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_population_directions_and_shot_uniforms_equal_jax():
    """Per-individual keys, probe keys (step and calibration offsets),
    directions and shot uniforms, as the reference's vmaps draw them."""
    keys_ref = jax.random.split(jax.random.PRNGKey(SEED), 5)
    keys = prng.split(prng.PRNGKey(SEED), 5)
    for k in (0, 4, 1000 + 2):
        for probe in (0, 1, 2):
            want = jax.vmap(lambda pk: jax.random.fold_in(jax.random.fold_in(pk, k), probe))(keys_ref)
            got = _probe_keys(keys, k, probe)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
            np.testing.assert_array_equal(
                prng.uniform(got, (64,)).numpy(),
                np.asarray(jax.vmap(lambda pk: jax.random.uniform(pk, (64,)))(want)),
            )
        want_dir = jax.vmap(lambda pk: jax.random.rademacher(pk, (11,), dtype=jnp.float32))(
            jax.vmap(lambda pk: jax.random.fold_in(jax.random.fold_in(pk, k), 0))(keys_ref)
        )
        np.testing.assert_array_equal(rademacher(_probe_keys(keys, k, 0), 11).numpy(), want_dir)


@pytest.mark.parametrize("seed", [2**32 + 9, 2**40 + 2**31 + 3])
def test_prng_key_of_a_seed_past_32_bits_equals_jax(seed):
    """The JAX package runs with 64-bit types off: a seed keeps its low 32
    bits, so the port's keys must too."""
    np.testing.assert_array_equal(
        prng.PRNGKey(seed).numpy(), np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    )


def test_calibration_matches_jax(jssp):
    op, op_ref, _ = jssp
    p, q, coords, n_free, _, _ = _last_layer_problem()
    mask = (np.arange(coords.shape[1])[None, :] < n_free[:, None]).astype(np.float32)
    evaluator = StatevectorExpectationEvaluator(op, device="cpu")
    gt, ctrl, ang, lm = packed_tensors(p)
    search = _Search(objective_operands(evaluator), 7, (gt, ctrl, lm), None, ang.shape,
                     torch.as_tensor(coords, dtype=torch.long), torch.as_tensor(mask),
                     prng.split(prng.PRNGKey(SEED), p.n_individuals))
    got = search.calibrate(ang, SPSAConfig(calibration_steps=6)).numpy()
    ref = JaxEvaluator(op_ref)
    want = _spsa_calibrate(
        q.gate_types, q.controls, q.layer_mask, q.angles, coords, mask, ref._table,
        jnp.zeros(1), jnp.zeros(1, jnp.int32), jnp.float32(1.0),
        jax.random.split(jax.random.PRNGKey(SEED), q.n_individuals), None, jnp.float32(0.1),
        n_qubits=7, shots=0, use_cvar=False, use_shots=False, calibration_steps=6,
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize(
    "case, config",
    [
        ("exact", dict(maxiter=5, calibration_steps=5)),
        ("exact", dict(maxiter=10, learning_rate=2e-4)),
        ("prefix", dict(maxiter=5, calibration_steps=5)),
        ("sampler", dict(maxiter=10, calibration_steps=5)),
    ],
)
def test_minimize_matches_jax(jssp, case, config):
    """Full circuits (cache_prefix off), the prefix-transform path (the
    default for a last-layer search) and the sampler's prefix path."""
    op, op_ref, table_max = jssp
    p, q, coords, n_free, active, last = _last_layer_problem()
    active[1] = False
    if case == "sampler":
        evaluator, ref = SamplerExpectationEvaluator(op, shots=64, device="cpu"), JaxSampler(op_ref, shots=64)
    else:
        evaluator, ref = StatevectorExpectationEvaluator(op, device="cpu"), JaxEvaluator(op_ref)
    kwargs = dict(seed=SEED) if case == "exact" else dict(seed=SEED, last_layer=last)
    cache = False if case == "exact" else None
    a, e, nfev = BatchedSPSA(SPSAConfig(cache_prefix=cache, **config)).minimize(
        evaluator, p, coords, n_free, active, **kwargs)
    a_ref, e_ref, nfev_ref = JaxSPSA(JaxSPSAConfig(cache_prefix=cache is None, **config)).minimize(
        ref, q, coords, n_free, active, **kwargs)
    assert nfev == nfev_ref
    tol = 1e-4 * table_max
    _close_as_energies(op_ref, q, a, a_ref, tol)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)
    np.testing.assert_array_equal(a[1], q.angles[1])
    if case != "exact":
        for i in range(p.n_individuals):
            for layer in range(p.max_layers):
                if layer != last[i]:
                    np.testing.assert_array_equal(a[i, layer], q.angles[i, layer])


@pytest.mark.parametrize(
    "config", [dict(maxiter=4, learning_rate=2e-4), dict(maxiter=1, calibration_steps=3)]
)
def test_fused_slot_search_matches_jax(jssp, config):
    op, op_ref, table_max = jssp
    p, q = _problem(7, seed=5)
    pop, slots = p.n_individuals, 3
    real = p.layer_mask.sum(axis=1)
    coords = np.zeros((pop, slots, 3 * p.n_qubits, 3), np.int32)
    n_free = np.zeros((pop, slots), np.int32)
    slot_layers = np.full((pop, slots), p.max_layers, np.int32)
    for i in range(pop):
        for s in range(min(slots, real[i])):
            layer = (s * 2 + i) % real[i]
            c = p.layer_param_coordinates(i, layer)
            coords[i, s, : len(c)] = c
            n_free[i, s] = len(c)
            slot_layers[i, s] = layer
    active = n_free > 0
    seeds = np.array([11, 12, 13])
    a, e, n = BatchedSPSA(SPSAConfig(**config)).minimize_slots(
        StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active, slot_layers,
        seeds=seeds,
    )
    ref = JaxEvaluator(op_ref)
    a_ref, e_ref, n_ref = JaxSPSA(JaxSPSAConfig(cache_prefix=True, **config)).minimize_slots(
        ref, q, coords, n_free, active, slot_layers, seeds=seeds,
    )
    assert n == n_ref
    tol = 1e-4 * table_max
    _close_as_energies(op_ref, q, a, a_ref, tol)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)


def test_fused_slot_search_declines_where_the_cache_is_off(jssp):
    op, _, _ = jssp
    p, _ = _problem(7)
    shape = (p.n_individuals, 1)
    result = BatchedSPSA(SPSAConfig(cache_prefix=False)).minimize_slots(
        StatevectorExpectationEvaluator(op, device="cpu"), p, np.zeros((*shape, 1, 3), np.int32),
        np.ones(shape, np.int32), np.ones(shape, bool), np.zeros(shape, np.int32),
    )
    assert result is None


VALUE_SEQUENCES = [
    [10.0, 9.0, 8.99, 8.985, 8.984, 8.9839, 8.98389],
    [5.0, 5.0, 5.0, 4.0, 4.0, 4.0, 4.0, 4.0],
    [3.0, 2.5, 2.0, 1.9, 1.899, 1.8989, 1.7, 1.69999, 1.699989],
    [-1.0, -2.0, -2.0001, -2.00011, -3.0],
]


@pytest.mark.parametrize("values", VALUE_SEQUENCES)
@pytest.mark.parametrize("settings", [(1e-3, 0, None), (1e-3, 2, None), (1e-2, 1, 9)])
def test_termination_checker_decides_as_jax(values, settings):
    ours, ref = SPSATerminationChecker(*settings), JaxChecker(*settings)
    for run in range(2):  # the second run restarts the count: both reset
        for k, value in enumerate(values):
            args = dict(n_function_evaluations=2 * (k + 1), parameter_values=np.array([value, k]),
                        function_value=value, step_size=0.1, accepted=k % 4 != 3)
            assert ours.termination_check(**args) == ref.termination_check(**args)
        assert ours.function_value_history == ref.function_value_history
        assert ours.best_function_value == ref.best_function_value


def test_host_stepped_search_stops_each_individual_where_its_checker_does(jssp):
    op, op_ref, table_max = jssp
    p, q, coords, n_free, active, _ = _last_layer_problem()
    config = dict(maxiter=8, learning_rate=2e-4)

    def checkers(module):
        return [module(1e-3, 1, maxfev=2 + 2 * i) for i in range(p.n_individuals)]

    history = []
    original = _Search.steps

    def recording(self, angles, live, *args, **kwargs):
        history.append((angles.clone(), live.clone()))
        return original(self, angles, live, *args, **kwargs)

    _Search.steps = recording
    try:
        a, e, nfev = BatchedSPSA(SPSAConfig(**config)).minimize(
            StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active,
            seed=SEED, termination_checkers=checkers(SPSATerminationChecker))
    finally:
        _Search.steps = original
    a_ref, e_ref, nfev_ref = JaxSPSA(JaxSPSAConfig(**config)).minimize(
        JaxEvaluator(op_ref), q, coords, n_free, active, seed=SEED,
        termination_checkers=checkers(JaxChecker))
    assert nfev == nfev_ref
    tol = 1e-4 * table_max
    _close_as_energies(op_ref, q, a, a_ref, tol)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)
    # the steps run while someone is live, two evaluations each; individual
    # 0 stops at its maxfev after step 0; once stopped, an individual stays
    # stopped and its angles never move again
    live = np.stack([step_live.numpy() for _, step_live in history])
    assert nfev == 2 * len(history) and live[0].all() and not live[1:, 0].any()
    assert (live[1:] <= live[:-1]).all()
    for i in range(p.n_individuals):
        for angles, _ in history[int(live[:, i].sum()):]:
            np.testing.assert_array_equal(angles[i].numpy(), a[i])


def test_evaluator_without_operands_is_refused():
    """An evaluator without objective operands is no longer refused: it
    takes the host-stepped loop (``BatchedSPSA._minimize_host``), one
    ``evaluate_packed`` call per probe and a final one, and no minimize_slots
    (tests/test_torch_external.py holds the loop against the JAX package's)."""
    class External:
        calls = 0

        def evaluate_packed(self, packed, angles=None):
            External.calls += 1
            return np.zeros(packed.n_individuals)

    p, _, coords, n_free, active, _ = _last_layer_problem()
    optimizer = BatchedSPSA(SPSAConfig(maxiter=2, calibration_steps=3))
    angles, energies, nfev = optimizer.minimize(External(), p, coords, n_free, active)
    assert nfev == External.calls == 2 * 3 + 2 * 2 + 1
    assert angles.shape == p.angles.shape and energies.shape == (p.n_individuals,)


def test_cobyla_matches_jax(jssp):
    op, op_ref, table_max = jssp
    p, q, coords, n_free, active, _ = _last_layer_problem()
    active[3] = False
    a, e, nfev = ScipyCobyla(CobylaConfig(maxiter=20)).minimize(
        StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active)
    a_ref, e_ref, nfev_ref = JaxCobyla(JaxCobylaConfig(maxiter=20)).minimize(
        JaxEvaluator(op_ref), q, coords, n_free, active)
    tol = 1e-4 * table_max
    _close_as_energies(op_ref, q, a, a_ref, tol)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)
    assert nfev == nfev_ref
    np.testing.assert_array_equal(a[3], q.angles[3])


def test_routes_run_the_same_search_up_to_rounding(jssp, monkeypatch):
    """The slot and fold routes' plain versions (the fold route forced on
    the CPU) from the same keys: at a fixed rate of 2e-4 (steps of about
    0.1 rad) eight steps agree to 1e-5 * max|table|.  At calibrated rates
    the gap grows with the steps (here 1.3e-5 after one, 1.6e-4 after
    eight), as a chaotic map amplifies rounding; so whole calibrated
    searches of the two routes are not compared."""
    from queasars_tpu_torch.sim import fold_kernels, fold_pipeline

    op, _, table_max = jssp
    p, _, coords, n_free, active, last = _last_layer_problem()
    supported = fold_kernels.fold_supported

    def gap(**config) -> float:
        energies = []
        for fold in (False, True):
            monkeypatch.setattr(fold_kernels, "fold_supported", (
                lambda n, device, path="exact": fold_pipeline.LANE_BITS <= n <= fold_kernels._CAPS[path]
            ) if fold else supported)
            energies.append(BatchedSPSA(SPSAConfig(**config)).minimize(
                StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active,
                seed=SEED, last_layer=last)[1])
        return float(np.abs(energies[0] - energies[1]).max()) / table_max

    assert gap(maxiter=8, learning_rate=2e-4) <= 1e-5
