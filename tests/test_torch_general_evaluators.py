"""The port's evaluators and population objective on general (non-diagonal)
operators against the JAX package's, on the CPU.

Sampled energies compare draw by draw, as tests/test_torch_sampler_
evaluator.py does for diagonal operators: both packages draw group g's shots
of individual p with ``fold_in(key_p, g)`` and add their running sums in one
order, so equal rotated probabilities give equal draws; the two statevector
engines round differently, so a draw within ~1e-7 of a bin boundary may land
in the neighbouring bin.  At least 99.5% of each group's draws must be equal
and every other one must be a boundary draw (within 1e-5 of the total
mass); an individual's energy then agrees to 1e-5 * sum|c| plus
2 * max|table_g| / S_g per flipped draw of group g.  Exact energies (dense
matvec, term scan) agree to 1e-5 * sum|c|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.optim.objective import objective_operands as jax_objective_operands
from queasars_tpu.optim.objective import population_energies as jax_population_energies
from queasars_tpu.problems import spin_chains as jax_chains
from queasars_tpu.sim.evaluators import CircuitEvaluatorException as JaxEvaluatorException
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEstimator
from queasars_tpu.sim.grouped_sampling import _rotated_probs as jax_rotated_probs
from queasars_tpu.sim.sampling import sample_indices as jax_sample_indices
from queasars_tpu.sim.statevector import simulate_circuits as jax_simulate
from queasars_tpu_torch.interop import pauli_sum_from_numpy
from queasars_tpu_torch.optim.objective import objective_operands, population_energies
from queasars_tpu_torch.sim.evaluators import (
    CircuitEvaluatorException,
    SamplerExpectationEvaluator,
    StatevectorExpectationEvaluator,
    packed_tensors,
)
from queasars_tpu_torch.sim.expectation import DenseHermitian, PauliTerms
from queasars_tpu_torch.sim.grouped_sampling import GroupedOperands, _rotated_probs
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.sim.statevector import simulate_circuits
from queasars_tpu_torch.utils import prng
from tests.test_torch_grouping import random_hermitian
from tests.test_torch_optim import _problem


def _tfim(n):
    op_ref = jax_chains.transverse_field_ising(n, coupling=1.0, field=0.9)
    return pauli_sum_from_numpy(n, op_ref.z, op_ref.x, op_ref.coeffs), op_ref


def _heisenberg(n):
    op_ref = jax_chains.heisenberg_chain(n, coupling=0.7)
    return pauli_sum_from_numpy(n, op_ref.z, op_ref.x, op_ref.coeffs), op_ref


def _scale(op_ref):
    return float(np.abs(op_ref.coeffs).sum())


def check_grouped_round(got, want, genome, genome_ref, ops, keys, shots, op_ref, initial=None):
    """Energies of one grouped evaluation round against the JAX package's,
    draw by draw per group (``keys`` [P, 2] the round's keys; ``shots`` an
    int or a per-group tuple).  The port's draws are the flat sampler's
    below n=14 and the slot sampled kernel's (plain version, the CPU's
    route) on the genome extended by the group's rotation from n=14 on.
    Returns the number of flipped draws."""
    import chip_smoke

    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.grouped_sampling import append_rotation_layer

    n = ops.rot_types.shape[1]
    n_groups = ops.tables.shape[0]
    counts = shots if isinstance(shots, tuple) else (shots,) * n_groups
    states = simulate_circuits(*genome, n, initial)
    states_ref = jax_simulate(*genome_ref, n, None if initial is None else jnp.asarray(initial.numpy()))
    ref_keys = jnp.asarray(keys.numpy().astype(np.uint32))
    allowed = np.full(len(got), 1e-5 * _scale(op_ref))
    flipped = 0
    for g, s in enumerate(counts):
        probs = _rotated_probs(states, ops.rot_types[g], ops.rot_angles[g], n)
        probs_ref = np.asarray(jax_rotated_probs(
            states_ref, jnp.asarray(ops.rot_types[g].numpy()), jnp.asarray(ops.rot_angles[g].numpy()), n))
        g_keys = prng.fold_in(keys, g)
        if n >= sk.SAMPLER_MIN_QUBITS:
            ext = append_rotation_layer(*genome, ops.rot_types[g], ops.rot_angles[g])
            idx = sk.sampled_shot_indices_plain(*ext, prng.uniform(g_keys, (s,)), n, initial)
        else:
            idx = sample_indices(g_keys, probs, s)
        ref_idx = np.stack([
            np.asarray(jax_sample_indices(jax.random.fold_in(k, g), jnp.asarray(p), s))
            for k, p in zip(ref_keys, probs_ref)
        ])
        share, not_boundary = chip_smoke.draw_agreement(
            torch.tensor(probs_ref), prng.uniform(g_keys, (s,)), idx, torch.tensor(ref_idx))
        assert share >= 0.995 and not_boundary == 0, (g, share, not_boundary)
        flips = (idx.numpy() != ref_idx).sum(axis=1)
        flipped += int(flips.sum())
        allowed += flips * 2 * float(ops.tables[g].abs().max()) / s
    assert np.all(np.abs(np.asarray(got) - np.asarray(want)) <= allowed), (got, want)
    return flipped


@pytest.mark.parametrize("n, allocation", [(6, "per_group"), (8, "proportional"), (7, "per_group")])
def test_grouped_sampler_evaluator_matches_jax_over_successive_calls(n, allocation):
    op, op_ref = _tfim(n) if n != 7 else _heisenberg(n)
    p, q = _problem(n, seed=n)
    ours = SamplerExpectationEvaluator(op, shots=512, seed=3, device="cpu",
                                       shot_allocation=allocation)
    ref = JaxSampler(op_ref, shots=512, seed=3, shot_allocation=allocation)
    assert ours._group_shots == ref._group_shots
    shots = ours._group_shots if ours._group_shots is not None else 512
    for call in range(1, 4):
        got, want = ours.evaluate_packed(p), np.asarray(ref.evaluate_packed(q))
        assert ours._counter == ref._counter == call
        keys = prng.split(prng.fold_in(prng.PRNGKey(3), call), p.n_individuals)
        check_grouped_round(got, want, packed_tensors(p), (q.gate_types, q.controls, q.angles,
                            q.layer_mask), ours._grouped, keys, shots, op_ref)


@pytest.mark.parametrize("n", [8, 13])
def test_statevector_evaluator_on_a_general_operator_matches_jax(n):
    op, op_ref = _heisenberg(n) if n == 8 else _tfim(n)
    p, q = _problem(n, pop=3, seed=n)
    ours = StatevectorExpectationEvaluator(op, device="cpu")
    operands = objective_operands(ours)
    assert operands["use_general"] and not operands["use_shots"]
    assert isinstance(operands["table"], DenseHermitian if n <= 12 else PauliTerms)
    np.testing.assert_allclose(
        ours.evaluate_packed(p), np.asarray(JaxEstimator(op_ref).evaluate_packed(q)),
        atol=1e-5 * _scale(op_ref), rtol=0,
    )


def test_estimator_precision_on_a_general_operator_samples_groups():
    op, op_ref = _tfim(7)
    p, q = _problem(7, seed=2)
    ours = StatevectorExpectationEvaluator(op, precision=0.05, seed=2, device="cpu")
    ref = JaxEstimator(op_ref, precision=0.05, seed=2)
    assert ours._precision_sampler.shots == ref._precision_sampler.shots == 400
    operands = objective_operands(ours)
    assert isinstance(operands["table"], GroupedOperands) and operands["shots"] == 400
    for call in range(1, 3):
        got, want = ours.evaluate_packed(p), np.asarray(ref.evaluate_packed(q))
        keys = prng.split(prng.fold_in(prng.PRNGKey(2), call), p.n_individuals)
        check_grouped_round(got, want, packed_tensors(p), (q.gate_types, q.controls, q.angles,
                            q.layer_mask), ours._precision_sampler._grouped, keys, 400, op_ref)


@pytest.mark.parametrize("n, shots", [(8, 256), (8, (100, 300)), (14, 128), (14, (60, 200))])
def test_grouped_objective_matches_jax(n, shots):
    """``population_energies`` with grouped operands: below n=14 the flat
    sampler on simulated states, at n=14 (the CPU's slot route) the slot
    sampled kernel's plain version once per group on the extended genome;
    with and without per-individual start states."""
    op, op_ref = _tfim(n)
    p, q = _problem(n, pop=3, layers=2, seed=n)
    genome, genome_ref = packed_tensors(p), (q.gate_types, q.controls, q.angles, q.layer_mask)
    ours = SamplerExpectationEvaluator(op, shots=128, device="cpu")
    ref_operands = jax_objective_operands(JaxSampler(op_ref, shots=128))["table"]
    keys = prng.split(prng.PRNGKey(9), 3)
    rng = np.random.default_rng(n)
    raw = rng.normal(size=(3, 2, 1 << n)).astype(np.float32)
    start = raw / np.sqrt((raw.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True)).astype(np.float32)
    for initial in (None, torch.tensor(start)):
        got = population_energies(
            *genome, ours._grouped, None, None, 1.0, keys, n_qubits=n, use_cvar=False,
            shots=shots, use_shots=True, initial_state=initial, use_general=True,
        )
        want = jax_population_energies(
            *genome_ref, ref_operands, jnp.zeros(1), jnp.zeros(1, jnp.int32), jnp.float32(1.0),
            jnp.asarray(keys.numpy().astype(np.uint32)), n_qubits=n, shots=shots, use_cvar=False,
            use_shots=True, use_general=True,
            initial_state=None if initial is None else jnp.asarray(initial.numpy()),
        )
        check_grouped_round(got.numpy(), np.asarray(want), genome, genome_ref, ours._grouped,
                            keys, shots, op_ref, initial)


@pytest.mark.parametrize("n", [6, 13])
def test_exact_general_objective_matches_jax(n):
    op, op_ref = _tfim(n)
    p, q = _problem(n, pop=3, layers=2, seed=1)
    operands = objective_operands(StatevectorExpectationEvaluator(op, device="cpu"))
    ref_operands = jax_objective_operands(JaxEstimator(op_ref))
    got = population_energies(*packed_tensors(p), n_qubits=n, **operands)
    want = jax_population_energies(
        q.gate_types, q.controls, q.angles, q.layer_mask, ref_operands["table"],
        ref_operands["sorted_energies"], ref_operands["energy_order"], ref_operands["alpha"],
        jnp.zeros((3, 2), jnp.uint32), n_qubits=n, shots=0, use_cvar=False, use_shots=False,
        use_general=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * _scale(op_ref), rtol=0)


def test_cvar_and_size_limits_are_refused_as_in_the_reference():
    op, op_ref = _tfim(5)
    for ours, ref in (
        (lambda: SamplerExpectationEvaluator(op, shots=64, alpha=0.5, device="cpu"),
         lambda: JaxSampler(op_ref, shots=64, alpha=0.5)),
        (lambda: StatevectorExpectationEvaluator(op, alpha=0.5, device="cpu"),
         lambda: JaxEstimator(op_ref, alpha=0.5)),
        (lambda: StatevectorExpectationEvaluator(op, alpha=0.5, precision=0.1, device="cpu"),
         lambda: JaxEstimator(op_ref, alpha=0.5, precision=0.1)),
    ):
        with pytest.raises(JaxEvaluatorException) as want:
            ref()
        with pytest.raises(CircuitEvaluatorException) as got:
            ours()
        assert str(got.value) == str(want.value)
    big, _ = _tfim(33)
    with pytest.raises(CircuitEvaluatorException, match="n<=32"):
        StatevectorExpectationEvaluator(big, device="cpu")
    with pytest.raises(ValueError, match="shot_allocation"):
        SamplerExpectationEvaluator(op, shots=64, device="cpu", shot_allocation="even")


def test_random_operator_operands_follow_the_evaluator_kind():
    op_ref = random_hermitian(6, 9, 2)
    op = pauli_sum_from_numpy(6, op_ref.z, op_ref.x, op_ref.coeffs)
    sampler = SamplerExpectationEvaluator(op, shots=90, device="cpu", shot_allocation="proportional")
    operands = objective_operands(sampler)
    assert operands["use_general"] and operands["use_shots"] and not operands["use_cvar"]
    assert isinstance(operands["shots"], tuple) and sum(operands["shots"]) == 90
    assert sampler._table is None and objective_operands(
        SamplerExpectationEvaluator(op, shots=90, device="cpu"))["shots"] == 90
    diagonal = objective_operands(StatevectorExpectationEvaluator(_problem_operator(), device="cpu"))
    assert not diagonal["use_general"]


def _problem_operator():
    from tests.test_torch_optim import _operators

    return _operators(6)[0]
