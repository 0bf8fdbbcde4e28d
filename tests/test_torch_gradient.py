"""The port's batched gradient descent against the JAX package's (CPU).

Both sides differentiate the same plain engines: the port with
``torch.autograd`` through its slot engine or kron-fold applier, the JAX
package with ``jax.grad`` through its jnp engines.  Inputs are packed
populations made from a numpy seed (P=5; 5 qubits, and 7 for the fold
applier, the JAX package's smallest folded size); every search runs 3-8
steps.  Each distinct search compiles once in the JAX package (about 8 s
here), so the cases are chosen to cover the paths with few compiles: SGD
runs with the CVaR objective.

Why few steps: Adam's early steps move each coordinate by about
lr * sign(g), so a coordinate whose gradient is zero up to rounding (a flat
phase) moves by lr in a direction rounding chooses, and the two packages'
angles differ there by up to lr per step while the energies agree.  So
searches are compared as energies, re-evaluated through the JAX evaluator at
both packages' angles, to 1e-5 * scale (scale = sum|c| of the operator); the
angles a search must leave alone (inactive individuals, other layers,
padding) are compared bit for bit.  The fold objective differentiates a
chain with a kink at a fresh layer's zero angles; the first step takes the
slot engine there in both packages.

Each comparison passes ``cache_prefix`` to both sides: the JAX package turns
the prefix cache and the fused slot search on by default only where its
kernels run, which its CPU never does, while the port's default follows the
kernel route (``optim/prefix.py::kernel_route``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.genome import EVQEIndividual as JaxIndividual
from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.optim import BatchedGradientDescent as JaxGradient
from queasars_tpu.optim import GradientDescentConfig as JaxConfig
from queasars_tpu.problems.spin_chains import transverse_field_ising as jax_tfim
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu.sim.fold_pipeline import simulate_circuits_folded as jax_folded
from queasars_tpu_torch.interop import packed_population_from_numpy
from queasars_tpu_torch.optim import BatchedGradientDescent, GradientDescentConfig
from queasars_tpu_torch.optim.objective import objective_operands
from queasars_tpu_torch.optim.gradient import _Objective, live_slots, simulate_slots
from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
from queasars_tpu_torch.sim.evaluators import (
    SamplerExpectationEvaluator,
    StatevectorExpectationEvaluator,
    packed_tensors,
)
from queasars_tpu_torch.sim.fold_pipeline import simulate_circuits_folded
from queasars_tpu_torch.sim.statevector import simulate_circuits
from tests.test_torch_optim import _last_layer_coords, _operators, _problem

N = 5
#: the fold tests' size (the JAX package's folded applier needs 7 qubits)
N_FOLD = 7


def _scale(op_ref) -> float:
    return float(np.abs(op_ref.coeffs).sum())


def _all_coords(packed):
    coords_list = [packed.param_coordinates(i) for i in range(packed.n_individuals)]
    k_max = max(c.shape[0] for c in coords_list)
    coords = np.zeros((packed.n_individuals, k_max, 3), np.int32)
    for i, c in enumerate(coords_list):
        coords[i, : c.shape[0]] = c
    return coords, packed.n_params.astype(np.int32).copy()


def _close_as_energies(op_ref, q, a, a_ref, tol, alpha=1.0):
    ref = JaxEvaluator(op_ref, alpha=alpha)
    np.testing.assert_allclose(
        ref.evaluate_packed(q, angles=a), ref.evaluate_packed(q, angles=a_ref), atol=tol, rtol=0
    )


def _untouched(a, angles, coords, n_free, active):
    """Every angle off the active individuals' valid coordinates is equal
    bit for bit."""
    keep = np.ones(angles.shape, bool)
    for i in np.nonzero(active)[0]:
        for l, q, k in coords[i, : n_free[i]]:
            keep[i, l, q, k] = False
    np.testing.assert_array_equal(a[keep], angles[keep])


def _operators_for(case):
    if case == "general":
        return transverse_field_ising(N, coupling=0.8, field=1.1), jax_tfim(N, coupling=0.8, field=1.1)
    return _operators(N)


@pytest.mark.parametrize(
    "case, alpha, config",
    [
        ("full", 1.0, dict(maxiter=8, learning_rate=0.05)),
        ("full", 0.4, dict(maxiter=8, learning_rate=0.02, method="sgd")),
        ("general", 1.0, dict(maxiter=6, learning_rate=0.05)),
        ("prefix", 1.0, dict(maxiter=8, learning_rate=0.05)),
    ],
)
def test_minimize_matches_jax(case, alpha, config):
    """Full circuits (the cache off), CVaR with SGD, a general operator's
    dense objective, and the last-layer prefix path (the cache on)."""
    op, op_ref = _operators_for(case)
    p, q = _problem(N)
    active = np.ones(p.n_individuals, bool)
    active[1] = False
    if case == "prefix":
        coords, n_free = _last_layer_coords(p)
        last = p.layer_mask.sum(axis=1).astype(np.int32) - 1
        kwargs = dict(seed=3, last_layer=last)
    else:
        coords, n_free = _all_coords(p)
        kwargs = dict(seed=3)
    cache = case == "prefix"
    a, e, nfev = BatchedGradientDescent(GradientDescentConfig(cache_prefix=cache, **config)).minimize(
        StatevectorExpectationEvaluator(op, alpha=alpha, device="cpu"), p, coords, n_free, active,
        **kwargs)
    a_ref, e_ref, nfev_ref = JaxGradient(JaxConfig(cache_prefix=cache, **config)).minimize(
        JaxEvaluator(op_ref, alpha=alpha), q, coords, n_free, active, **kwargs)
    assert nfev == nfev_ref == 2 * config["maxiter"]
    tol = 1e-5 * _scale(op_ref)
    _close_as_energies(op_ref, q, a, a_ref, tol, alpha)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)
    # the returned energies are those of the returned angles
    np.testing.assert_allclose(
        e, JaxEvaluator(op_ref, alpha=alpha).evaluate_packed(q, angles=a), atol=tol, rtol=0)
    _untouched(a, q.angles, coords, n_free, active)


def test_fused_slot_search_matches_jax():
    op, op_ref = _operators(N)
    p, q = _problem(N, seed=5)
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
    active[2, 1] = False
    seeds = np.array([11, 12, 13])
    config = dict(maxiter=5, learning_rate=0.05, cache_prefix=True)
    a, e, n = BatchedGradientDescent(GradientDescentConfig(**config)).minimize_slots(
        StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active, slot_layers,
        seeds=seeds)
    a_ref, e_ref, n_ref = JaxGradient(JaxConfig(**config)).minimize_slots(
        JaxEvaluator(op_ref), q, coords, n_free, active, slot_layers, seeds=seeds)
    assert n == n_ref == 10
    tol = 1e-5 * _scale(op_ref)
    _close_as_energies(op_ref, q, a, a_ref, tol)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)
    free = np.zeros(q.angles.shape, bool)
    for i in range(pop):
        for s in range(slots):
            if active[i, s]:
                for l, qb, k in coords[i, s, : n_free[i, s]]:
                    free[i, l, qb, k] = True
    np.testing.assert_array_equal(a[~free], q.angles[~free])


def _grown_problem():
    """A population whose last layer is freshly grown: all its angles are
    exactly 0, where the fold's CU3 eigendecomposition is degenerate."""
    base = EVQEPopulation.random_population(N_FOLD, 2, 4, True, random_seed=8)
    grown = [JaxIndividual.add_random_layers(ind, 1, False, random_seed=i)
             for i, ind in enumerate(base.individuals)]
    q = JaxPacked.pack(grown)
    p = packed_population_from_numpy(
        q.gate_types, q.controls, q.angles, q.layer_mask, q.param_mask, q.n_params, q.n_qubits)
    coords, n_free = _last_layer_coords(p)
    return p, q, coords, n_free


def test_fold_gradients_at_degenerate_angles_equal_jax():
    """The port's fold applier has finite gradients at a fresh CU3's zero
    angles (its square roots are guarded as the reference's are), zero at
    the kink and equal to the slot engine's elsewhere, as in the JAX
    package, and equal to the JAX package's fold gradients."""
    p, q, _, _ = _grown_problem()
    table = np.random.default_rng(1).normal(size=1 << N_FOLD).astype(np.float32)
    gt, ctrl, ang, lm = packed_tensors(p)

    def grad(sim):
        leaf = ang.clone().requires_grad_(True)
        states = sim(gt, ctrl, leaf, lm, N_FOLD)
        ((states[:, 0] ** 2 + states[:, 1] ** 2) @ torch.as_tensor(table)).sum().backward()
        return leaf.grad.numpy()

    def jax_grad(sim):
        def loss(a):
            states = sim(q.gate_types, q.controls, a, q.layer_mask, N_FOLD)
            return jnp.sum((states[:, 0] ** 2 + states[:, 1] ** 2) @ table)

        return np.asarray(jax.grad(loss)(jnp.asarray(q.angles)))

    g_fold, g_slot = grad(simulate_circuits_folded), grad(simulate_circuits)
    assert np.isfinite(g_fold).all() and np.isfinite(g_slot).all()
    degenerate = (q.gate_types == 3) & np.all(q.angles == 0.0, axis=-1)
    ok = ~np.broadcast_to(degenerate[..., None], g_fold.shape)
    assert degenerate.any()
    np.testing.assert_allclose(g_fold[ok], g_slot[ok], atol=5e-5)
    assert np.all(np.abs(g_fold[~ok]) < 1e-6)
    np.testing.assert_allclose(g_fold, jax_grad(jax_folded), atol=5e-5)


def test_folded_descent_from_fresh_layers_matches_jax():
    """``use_fold``: the first step differentiates through the slot engine
    (the kink warm-up), so the fresh layer moves; both packages reach the
    same energies.  At zero angles many coordinates have no first-order
    gradient, and Adam's first step moves each of them by lr in the
    direction rounding gives its gradient's sign; the energy then moves at
    second order, lr^2 times the curvature.  So this search takes lr = 2e-3,
    where that stays far inside the bar (at 0.05 it reaches 1.3e-3)."""
    op, op_ref = _operators(N_FOLD)
    p, q, coords, n_free = _grown_problem()
    active = n_free > 0
    config = dict(maxiter=3, learning_rate=2e-3, use_fold=True)
    a, e, _ = BatchedGradientDescent(GradientDescentConfig(cache_prefix=False, **config)).minimize(
        StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free, active, seed=5)
    a_ref, e_ref, _ = JaxGradient(JaxConfig(cache_prefix=False, **config)).minimize(
        JaxEvaluator(op_ref), q, coords, n_free, active, seed=5)
    last = p.layer_mask.sum(axis=1) - 1
    for i in np.nonzero(active)[0]:
        assert (a[i, last[i]] != q.angles[i, last[i]]).any()
    tol = 1e-5 * _scale(op_ref)
    _close_as_energies(op_ref, q, a, a_ref, tol)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)
    _untouched(a, q.angles, coords, n_free, active)


def test_skipped_slots_leave_the_states_bit_equal():
    """The objective applies only the slots some individual fills; the
    states equal the full slot engine's bit for bit."""
    p, _ = _problem(N, seed=2)
    gt, ctrl, ang, lm = packed_tensors(p)
    slots = live_slots(gt, lm)
    assert len(slots) < p.max_layers * N
    got = simulate_slots(gt, ctrl, ang, lm, N, None, slots)
    assert torch.equal(got, simulate_circuits(gt, ctrl, ang, lm, N))


def test_the_objective_equals_the_evaluator():
    op, op_ref = _operators(N)
    p, q = _problem(N)
    coords, n_free = _all_coords(p)
    evaluator = StatevectorExpectationEvaluator(op, device="cpu")
    gt, ctrl, ang, lm = packed_tensors(p)
    mask = torch.as_tensor(np.arange(coords.shape[1])[None] < n_free[:, None], dtype=torch.float32)
    objective = _Objective(objective_operands(evaluator), N, (gt, ctrl, lm), None,
                           torch.as_tensor(coords, dtype=torch.long), mask, ang.shape)
    for fold in (False, True):
        np.testing.assert_allclose(objective.energies(ang, fold).detach().numpy(),
                                   JaxEvaluator(op_ref).evaluate_packed(q),
                                   atol=1e-5 * _scale(op_ref), rtol=0)


def test_shot_and_unsupported_objectives_raise():
    op, _ = _operators(N)
    p, _ = _problem(N)
    coords, n_free = _all_coords(p)
    active = np.ones(p.n_individuals, bool)
    optimizer = BatchedGradientDescent(GradientDescentConfig(maxiter=2, cache_prefix=True))
    for evaluator in (SamplerExpectationEvaluator(op, shots=64, device="cpu"),
                      StatevectorExpectationEvaluator(op, precision=0.1, device="cpu")):
        with pytest.raises(ValueError, match="not differentiable"):
            optimizer.minimize(evaluator, p, coords, n_free, active)
        shape = (p.n_individuals, 1)
        assert optimizer.minimize_slots(
            evaluator, p, coords[:, None], n_free[:, None], active[:, None],
            np.zeros(shape, np.int32)) is None

    class Opaque:
        device = torch.device("cpu")

    with pytest.raises(ValueError, match="differentiable device objective"):
        optimizer.minimize(Opaque(), p, coords, n_free, active)
    with pytest.raises(ValueError):
        GradientDescentConfig(method="rmsprop")
    with pytest.raises(ValueError):
        GradientDescentConfig(maxiter=0)
    with pytest.raises(ValueError):
        GradientDescentConfig(learning_rate=0.0)
    # the reference's shot evaluator refuses alike
    with pytest.raises(ValueError, match="not differentiable"):
        _, q = _problem(N)
        JaxGradient(JaxConfig(maxiter=2)).minimize(
            JaxSampler(_operators(N)[1], shots=64), q, coords, n_free, active)


def test_nothing_to_optimize_returns_the_evaluators_energies():
    op, op_ref = _operators(N)
    p, q = _problem(N)
    coords, n_free = _all_coords(p)
    a, e, n = BatchedGradientDescent().minimize(
        StatevectorExpectationEvaluator(op, device="cpu"), p, coords, n_free,
        np.zeros(p.n_individuals, bool))
    assert n == 0
    np.testing.assert_array_equal(a, q.angles)
    np.testing.assert_allclose(e, JaxEvaluator(op_ref).evaluate_packed(q), atol=1e-5 * _scale(op_ref))
