"""The port's sampler evaluator, shot-based estimator precision and batched
NFT with shots against the JAX package's, on one packed population and one
diagonal operator (n=7..8, CPU).

Both packages draw from equal threefry keys and add their running sums in
one order, so they draw the same shots from equal probabilities.  The two
statevector engines round differently (probabilities differ by up to
~1e-7), so a draw within that distance of a bin boundary may land in the
neighbouring bin: at least 99.5% of draws must be equal and every other one
must be such a boundary draw (within 1e-5 of the total mass).  Where every
draw of an individual agrees, its energy agrees to 1e-5 * max|table| (only
the float32 summation order differs: the JAX package's CPU path reduces
counts, the port's the shot multiset); a boundary draw may move it by at
most 2 * max|table| / (alpha * shots) per flipped draw.  NFT results are compared as energies through the JAX
evaluator, not as raw angles (ROADMAP rule: angles are ambiguous by pi on
flat coordinates), at 1e-4 * max|table|: ulp-level differences inside each
step compound over the steps."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.optim.nft import BatchedNFT as JaxNFT
from queasars_tpu.optim.nft import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEstimator
from queasars_tpu.sim.sampling import sample_indices as jax_sample_indices
from queasars_tpu.sim.statevector import probabilities as jax_probabilities
from queasars_tpu_torch.interop import sampler_state_from_plain, sampler_state_to_plain
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.optim import nft as port_nft
from queasars_tpu_torch.optim.objective import objective_operands
from queasars_tpu_torch.sim.evaluators import (
    SamplerExpectationEvaluator,
    StatevectorExpectationEvaluator,
    packed_tensors,
)
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.sim.statevector import probabilities
from queasars_tpu_torch.utils import prng
from tests.test_torch_optim import _last_layer_coords, _operators, _problem


def _tol(op_ref, scale=1e-5):
    return scale * float(np.abs(np.asarray(jax_table(op_ref))).max())


def _check_round(got, want, p, q, op_ref, seed, call, shots, alpha):
    """One evaluation round's energies against the JAX package's, draw by
    draw: the round's keys are split(fold_in(PRNGKey(seed), call), P)."""
    import chip_smoke

    keys = prng.split(prng.fold_in(prng.PRNGKey(seed), call), p.n_individuals)
    ref_keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), call), p.n_individuals)
    ref_probs = np.asarray(jax_probabilities(q.gate_types, q.controls, q.angles, q.layer_mask, q.n_qubits))
    ref_idx = np.stack([
        np.asarray(jax_sample_indices(k, jnp.asarray(pr), shots)) for k, pr in zip(ref_keys, ref_probs)
    ])
    idx = sample_indices(keys, probabilities(*packed_tensors(p), p.n_qubits), shots)
    frac = prng.uniform(keys, (shots,))
    share, not_boundary = chip_smoke.draw_agreement(
        torch.tensor(ref_probs), frac, idx, torch.tensor(ref_idx)
    )
    assert share >= 0.995 and not_boundary == 0, (share, not_boundary)
    flips = (idx.numpy() != ref_idx).sum(axis=1)
    table_max = _tol(op_ref, 1.0)
    allowed = _tol(op_ref) + flips * 2 * table_max / (alpha * shots)
    assert np.all(np.abs(got - want) <= allowed), (got - want, flips)
    return int(flips.sum())


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("n_qubits", [8, 12])
def test_sampler_evaluator_matches_jax_over_successive_calls(alpha, n_qubits):
    op, op_ref = _operators(n_qubits)
    p, q = _problem(n_qubits)
    ours = SamplerExpectationEvaluator(op, shots=512, alpha=alpha, seed=3, device="cpu")
    ref = JaxSampler(op_ref, shots=512, alpha=alpha, seed=3)
    for call in range(1, 4):
        got, want = ours.evaluate_packed(p), np.asarray(ref.evaluate_packed(q))
        assert ours._counter == ref._counter == call
        _check_round(got, want, p, q, op_ref, 3, call, 512, alpha)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_estimator_precision_is_a_sampler_of_ceil_p_minus_2_shots(alpha):
    op, op_ref = _operators(8)
    p, q = _problem(8)
    ours = StatevectorExpectationEvaluator(op, alpha=alpha, precision=0.05, seed=2, device="cpu")
    ref = JaxEstimator(op_ref, alpha=alpha, precision=0.05, seed=2)
    assert ours._precision_sampler.shots == ref._precision_sampler.shots == 400
    assert objective_operands(ours)["shots"] == 400
    for call in range(1, 4):
        got, want = ours.evaluate_packed(p), np.asarray(ref.evaluate_packed(q))
        assert ours._counter == ref._counter == call
        _check_round(got, want, p, q, op_ref, 2, call, 400, alpha)
    with pytest.raises(AttributeError):
        StatevectorExpectationEvaluator(op, device="cpu")._counter


def test_shot_stream_state_carries_across():
    """After the JAX evaluator has drawn rounds, the port evaluator set to
    its state draws the JAX evaluator's next keys and shots."""
    op, op_ref = _operators(8)
    p, q = _problem(8)
    ref = JaxSampler(op_ref, shots=256, seed=41)
    for _ in range(5):
        ref.evaluate_packed(q)
    ours = SamplerExpectationEvaluator(op, shots=256, seed=0, device="cpu")
    sampler_state_from_plain(ours, sampler_state_to_plain(ref))
    assert sampler_state_to_plain(ours) == sampler_state_to_plain(ref)
    np.testing.assert_array_equal(ours._next_keys(4).numpy(), np.asarray(ref._next_keys(4)).astype(np.int64))
    _check_round(ours.evaluate_packed(p), np.asarray(ref.evaluate_packed(q)), p, q, op_ref,
                 41, 7, 256, 1.0)


def test_nft_probe_keys_are_the_references():
    """Step k's probe keys fold k, then the probe id, into each
    individual's key from split(PRNGKey(seed), P)."""
    pop_keys = prng.split(prng.PRNGKey(123), 5)
    ref_keys = jax.random.split(jax.random.PRNGKey(123), 5)
    for k in (0, 1, 7, 31):
        for probe in (0, 1, 2):
            want = jax.vmap(lambda pk: jax.random.fold_in(jax.random.fold_in(pk, k), probe))(ref_keys)
            np.testing.assert_array_equal(
                port_nft._probe_keys(pop_keys, k, probe).numpy(), np.asarray(want).astype(np.int64)
            )
    assert port_nft._probe_keys(None, 3, 1) is None


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_last_layer_search_with_shots_matches_jax(alpha):
    op, op_ref = _operators(7)
    p, q = _problem(7)
    coords, n_free = _last_layer_coords(p)
    active = n_free > 0
    active[1] = False
    last = p.layer_mask.sum(axis=1).astype(np.int32) - 1
    ours = SamplerExpectationEvaluator(op, shots=512, alpha=alpha, seed=3, device="cpu")
    ref = JaxSampler(op_ref, shots=512, alpha=alpha, seed=3)
    optimizer = BatchedNFT(NFTConfig(maxiter=9, reset_interval=4))
    assert not optimizer.publishes_exact_energies(ours)
    a, e, n = optimizer.minimize(ours, p, coords, n_free, active, seed=11, last_layer=last)
    a_ref, e_ref, n_ref = JaxNFT(JaxNFTConfig(maxiter=9, reset_interval=4)).minimize(
        ref, q, coords, n_free, active, seed=11, last_layer=last
    )
    assert n == n_ref
    np.testing.assert_allclose(e, e_ref, atol=_tol(op_ref, 1e-4), rtol=0)
    exact = JaxEstimator(op_ref, alpha=alpha)
    np.testing.assert_allclose(
        exact.evaluate_packed(q, angles=a), exact.evaluate_packed(q, angles=a_ref),
        atol=_tol(op_ref, 1e-4), rtol=0,
    )
    np.testing.assert_array_equal(a[1], q.angles[1])


def test_fused_slot_search_with_shots_matches_jax():
    op, op_ref = _operators(7, seed=3)
    p, q = _problem(7, seed=5)
    pop, slots = p.n_individuals, 2
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
    seeds = np.array([17, 2**31 - 5])
    cfg = dict(maxiter=5, reset_interval=3)
    ours = SamplerExpectationEvaluator(op, shots=512, alpha=0.5, seed=1, device="cpu")
    ref = JaxSampler(op_ref, shots=512, alpha=0.5, seed=1)
    a, e, n = BatchedNFT(NFTConfig(**cfg)).minimize_slots(
        ours, p, coords, n_free, n_free > 0, slot_layers, seeds=seeds
    )
    a_ref, e_ref, n_ref = JaxNFT(JaxNFTConfig(cache_prefix=True, **cfg)).minimize_slots(
        ref, q, coords, n_free, n_free > 0, slot_layers, seeds=seeds
    )
    assert n == n_ref
    np.testing.assert_allclose(e, e_ref, atol=_tol(op_ref, 1e-4), rtol=0)
    exact = JaxEstimator(op_ref, alpha=0.5)
    np.testing.assert_allclose(
        exact.evaluate_packed(q, angles=a), exact.evaluate_packed(q, angles=a_ref),
        atol=_tol(op_ref, 1e-4), rtol=0,
    )


def test_full_circuit_search_with_precision_matches_jax():
    op, op_ref = _operators(7, seed=9)
    p, q = _problem(7, seed=2)
    coords = np.stack([p.param_coordinates(i)[:6] for i in range(p.n_individuals)])
    n_free = np.full(p.n_individuals, 6, np.int32)
    active = np.ones(p.n_individuals, bool)
    ours = StatevectorExpectationEvaluator(op, precision=0.05, device="cpu")
    ref = JaxEstimator(op_ref, precision=0.05)
    a, e, _ = BatchedNFT(NFTConfig(maxiter=7)).minimize(ours, p, coords, n_free, active, seed=4)
    a_ref, e_ref, _ = JaxNFT(JaxNFTConfig(maxiter=7)).minimize(ref, q, coords, n_free, active, seed=4)
    np.testing.assert_allclose(e, e_ref, atol=_tol(op_ref, 1e-4), rtol=0)
    exact = JaxEstimator(op_ref)
    np.testing.assert_allclose(
        exact.evaluate_packed(q, angles=a), exact.evaluate_packed(q, angles=a_ref),
        atol=_tol(op_ref, 1e-4), rtol=0,
    )
