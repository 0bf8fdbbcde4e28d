"""Five-point NFT (the exact two-frequency step for CU3 angles against
non-diagonal operators) and NFT's general-operator routing in the port,
against the JAX package's ``optim/nft.py`` on the CPU.

The fit's 5x5 inverse and its 512-point grid must hold the JAX package's
float32 values exactly (an off-by-one-ulp grid can move the argmin).  NFT
results compare as energies through the JAX package's exact evaluator, not
as raw angles (ROADMAP rule), at 1e-4 * sum|c|: ulp-level differences
inside each step compound over the steps.  The JAX package runs on its CPU
defaults here (``use_pallas`` resolves off: full-circuit objectives and,
with ``cache_prefix=True``, the fused slot scan); the port runs its one
route (prefix states, slot kernels' plain versions), the same mathematics.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from queasars_tpu.optim import nft as jax_nft
from queasars_tpu.optim.nft import BatchedNFT as JaxNFT
from queasars_tpu.optim.nft import NFTConfig as JaxNFTConfig
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEstimator
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.optim import nft as port_nft
from queasars_tpu_torch.sim.evaluators import (
    SamplerExpectationEvaluator,
    StatevectorExpectationEvaluator,
)
from tests.test_torch_general_evaluators import _tfim
from tests.test_torch_optim import _last_layer_coords, _operators, _problem


def _scale(op_ref):
    return float(np.abs(op_ref.coeffs).sum())


def test_five_point_inverse_and_grid_are_the_references():
    np.testing.assert_array_equal(port_nft._five_point_inverse(), jax_nft._five_point_inverse())
    assert port_nft._five_point_inverse().dtype == np.float32
    want = np.asarray(jnp.linspace(0.0, 4 * jnp.pi, 512, endpoint=False))
    np.testing.assert_array_equal(port_nft.five_point_grid().numpy(), want)


@pytest.mark.parametrize("maxiter, reset, five_point", [
    (20, 32, True), (20, 32, False), (33, 4, True), (1, 1, True), (40, 32, False),
])
def test_evaluation_counts_match_jax(maxiter, reset, five_point):
    ours = NFTConfig(maxiter=maxiter, reset_interval=reset, five_point=five_point)
    ref = JaxNFTConfig(maxiter=maxiter, reset_interval=reset, five_point=five_point)
    assert ours.n_circuit_evaluations() == ref.n_circuit_evaluations()


def test_publishes_exact_energies_matches_jax():
    diag, diag_ref = _operators(6)
    general, general_ref = _tfim(6)
    evaluators = [
        (StatevectorExpectationEvaluator(diag, device="cpu"), JaxEstimator(diag_ref)),
        (StatevectorExpectationEvaluator(general, device="cpu"), JaxEstimator(general_ref)),
        (SamplerExpectationEvaluator(general, shots=64, device="cpu"),
         JaxSampler(general_ref, shots=64)),
        (StatevectorExpectationEvaluator(general, precision=0.1, device="cpu"),
         JaxEstimator(general_ref, precision=0.1)),
    ]
    for five_point in (False, True):
        ours = BatchedNFT(NFTConfig(five_point=five_point))
        ref = JaxNFT(JaxNFTConfig(five_point=five_point))
        for e, e_ref in evaluators:
            assert ours.publishes_exact_energies(e) == ref.publishes_exact_energies(e_ref)
    assert BatchedNFT().publishes_exact_energies(evaluators[0][0])


def _check(op_ref, q, a, a_ref, e, e_ref, tol_scale=1e-4):
    tol = tol_scale * _scale(op_ref)
    np.testing.assert_allclose(e, e_ref, atol=tol, rtol=0)
    exact = JaxEstimator(op_ref)
    np.testing.assert_allclose(
        exact.evaluate_packed(q, angles=a), exact.evaluate_packed(q, angles=a_ref), atol=tol, rtol=0
    )


@pytest.mark.parametrize("kind", ["grouped-sampler", "diagonal-estimator", "general-estimator"])
def test_five_point_last_layer_search_matches_jax(kind):
    n = 6
    if kind == "diagonal-estimator":
        op, op_ref = _operators(n)
        ours, ref = StatevectorExpectationEvaluator(op, device="cpu"), JaxEstimator(op_ref)
    elif kind == "general-estimator":
        op, op_ref = _tfim(n)
        ours, ref = StatevectorExpectationEvaluator(op, device="cpu"), JaxEstimator(op_ref)
    else:
        op, op_ref = _tfim(n)
        ours, ref = (SamplerExpectationEvaluator(op, shots=512, seed=3, device="cpu"),
                     JaxSampler(op_ref, shots=512, seed=3))
    p, q = _problem(n, seed=4)
    coords, n_free = _last_layer_coords(p)
    active = n_free > 0
    active[1] = False
    last = p.layer_mask.sum(axis=1).astype(np.int32) - 1
    cfg = dict(maxiter=6, reset_interval=4, five_point=True)
    a, e, evals = BatchedNFT(NFTConfig(**cfg)).minimize(
        ours, p, coords, n_free, active, seed=11, last_layer=last)
    a_ref, e_ref, evals_ref = JaxNFT(JaxNFTConfig(**cfg)).minimize(
        ref, q, coords, n_free, active, seed=11, last_layer=last)
    assert evals == evals_ref == 26
    _check(op_ref, q, a, a_ref, e, e_ref)
    np.testing.assert_array_equal(a[1], q.angles[1])


@pytest.mark.parametrize("kind", ["grouped-sampler", "diagonal-estimator"])
def test_five_point_fused_slot_search_matches_jax(kind):
    n = 6
    if kind == "diagonal-estimator":
        op, op_ref = _operators(n, seed=3)
        ours, ref = StatevectorExpectationEvaluator(op, device="cpu"), JaxEstimator(op_ref)
    else:
        op, op_ref = _tfim(n)
        ours, ref = (SamplerExpectationEvaluator(op, shots=512, seed=1, device="cpu",
                                                 shot_allocation="proportional"),
                     JaxSampler(op_ref, shots=512, seed=1, shot_allocation="proportional"))
    p, q = _problem(n, seed=5)
    pop, slots = p.n_individuals, 2
    real = p.layer_mask.sum(axis=1)
    coords = np.zeros((pop, slots, 3 * n, 3), np.int32)
    n_free = np.zeros((pop, slots), np.int32)
    slot_layers = np.full((pop, slots), p.max_layers, np.int32)
    for i in range(pop):
        for s in range(min(slots, real[i])):
            layer = (s * 2 + i) % real[i]
            c = p.layer_param_coordinates(i, layer)
            coords[i, s, : len(c)] = c
            n_free[i, s] = len(c)
            slot_layers[i, s] = layer
    seeds = np.array([17, 2**31 - 5])
    cfg = dict(maxiter=4, reset_interval=3, five_point=True)
    a, e, evals = BatchedNFT(NFTConfig(**cfg)).minimize_slots(
        ours, p, coords, n_free, n_free > 0, slot_layers, seeds=seeds)
    a_ref, e_ref, evals_ref = JaxNFT(JaxNFTConfig(cache_prefix=True, **cfg)).minimize_slots(
        ref, q, coords, n_free, n_free > 0, slot_layers, seeds=seeds)
    assert evals == evals_ref
    _check(op_ref, q, a, a_ref, e, e_ref)


def test_exact_general_objective_has_no_fused_slot_search():
    """As in the JAX package (its general exact operands resolve
    ``use_pallas`` off), ``minimize_slots`` returns None for an exact
    estimator of a general operator; the parameter search then needs the
    per-slot loop."""
    op, op_ref = _tfim(5)
    p, q = _problem(5, seed=1)
    coords = np.zeros((p.n_individuals, 1, 15, 3), np.int32)
    n_free = np.zeros((p.n_individuals, 1), np.int32)
    layers = np.zeros((p.n_individuals, 1), np.int32)
    args = (coords, n_free, n_free > 0, layers)
    assert BatchedNFT().minimize_slots(StatevectorExpectationEvaluator(op, device="cpu"), p, *args) is None
    assert JaxNFT().minimize_slots(JaxEstimator(op_ref), q, *args) is None
