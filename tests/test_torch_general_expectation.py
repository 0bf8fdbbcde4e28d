"""General (non-diagonal) expectations and the fold pipeline's rotation
helpers of the port against the JAX package's, on the CPU.

- The matrix-free term scan (``general_pauli_expectation_real``) on random
  normalised states at n in {6, 10, 13}, and the dense Hermitian matvec
  (n <= 12, the evaluator's range) through the JAX package's
  ``_energies_dense``: both to 1e-5 * sum|c| (float32 sums in another
  order).
- The grouped exact energies (rotate every QWC group, contract its table)
  against the term scan, to 1e-5 * sum|c|.
- ``rotation_layer_factors`` and ``extend_fold_pipeline_with_rotation``
  against the JAX versions (integer fields equal, factors to 1e-6), and the
  extension against a full rebuild with the rotation layer appended, as
  tests/test_fold_pipeline.py pins it in the JAX package: the base layers
  are the base pipeline's own tensors and the appended layer equals the
  rebuild's exactly, every integer field too; the rebuild's base factors
  and phases match to 1e-6 (PyTorch's CPU math may round a CU3
  eigendecomposition's last bits differently in a batch of another
  length).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.sim.evaluators import _energies_dense as jax_energies_dense
from queasars_tpu.sim.expectation import general_pauli_expectation_real as jax_general
from queasars_tpu.sim.fold_pipeline import build_fold_pipeline as jax_build
from queasars_tpu.sim.fold_pipeline import extend_fold_pipeline_with_rotation as jax_extend
from queasars_tpu.sim.fold_pipeline import rotation_layer_factors as jax_rotation_factors
from queasars_tpu.sim.grouped_sampling import grouped_operands as jax_grouped_operands
from queasars_tpu_torch.interop import genome_tensors_from_numpy, pauli_sum_from_numpy
from queasars_tpu_torch.optim.objective import population_energies
from queasars_tpu_torch.sim.expectation import (
    DenseHermitian,
    PauliTerms,
    dense_expectation,
    general_pauli_expectation_real,
    pauli_terms,
)
from queasars_tpu_torch.sim.fold_pipeline import (
    build_fold_pipeline,
    extend_fold_pipeline_with_rotation,
    rotation_layer_factors,
)
from queasars_tpu_torch.sim.grouped_sampling import (
    append_rotation_layer,
    grouped_exact_energies_from_states,
    grouped_operands,
)
from queasars_tpu_torch.sim.statevector import simulate_circuits
from tests.test_torch_grouping import CASES, random_hermitian


def _random_states(n, pop, seed):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(pop, 2, 1 << n)).astype(np.float32)
    return raw / np.sqrt((raw.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True)).astype(np.float32)


def _terms(op):
    terms = pauli_terms(op)
    assert isinstance(terms, PauliTerms) and terms.coeffs_re.dtype == torch.float32
    return terms


def _genomes(n, pop=3, layers=2, seed=0):
    population = EVQEPopulation.random_population(n, layers, pop, True, random_seed=seed)
    q = JaxPacked.pack(list(population.individuals))
    return (q.gate_types, q.controls, q.angles, q.layer_mask)


@pytest.mark.parametrize("n", [6, 10, 13])
@pytest.mark.parametrize("kind", ["tfim", "heisenberg", "random"])
def test_term_scan_matches_jax(n, kind):
    from queasars_tpu.problems import spin_chains as chains

    op_ref = {
        "tfim": lambda: chains.transverse_field_ising(n, 1.0, 0.9),
        "heisenberg": lambda: chains.heisenberg_chain(n, periodic=True),
        "random": lambda: random_hermitian(n, 15, n),
    }[kind]()
    op = pauli_sum_from_numpy(n, op_ref.z, op_ref.x, op_ref.coeffs)
    states = _random_states(n, 3, n)
    args = (op_ref.coeffs.real.astype(np.float32), op_ref.coeffs.imag.astype(np.float32),
            op_ref.z[:, 0].astype(np.uint32), op_ref.x[:, 0].astype(np.uint32))
    want = np.array([float(jax_general(jnp.asarray(s), *map(jnp.asarray, args))) for s in states])
    got = general_pauli_expectation_real(torch.tensor(states), *_terms(op))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(op_ref.coeffs).sum(), rtol=0)
    if n <= 12:  # the dense path, in float64 on the host as the oracle
        h = op.to_dense_matrix()
        psi = states[:, 0] + 1j * states[:, 1]
        exact = np.einsum("pi,ij,pj->p", psi.conj(), h, psi).real
        dense = dense_expectation(
            torch.tensor(states),
            DenseHermitian(torch.tensor(h.real.astype(np.float32)),
                           torch.tensor(h.imag.astype(np.float32))),
        )
        np.testing.assert_allclose(dense.numpy(), exact, atol=1e-5 * np.abs(op_ref.coeffs).sum())


@pytest.mark.parametrize("n", [6, 10])
def test_dense_objective_matches_jax_energies_dense(n):
    op_ref = random_hermitian(n, 12, 3 * n)
    op = pauli_sum_from_numpy(n, op_ref.z, op_ref.x, op_ref.coeffs)
    genome = _genomes(n, seed=n)
    h = op_ref.to_dense_matrix()
    want = np.asarray(jax_energies_dense(
        *genome, jnp.asarray(h.real.astype(np.float32)), jnp.asarray(h.imag.astype(np.float32)), n))
    dense = DenseHermitian(torch.tensor(h.real.astype(np.float32)),
                           torch.tensor(h.imag.astype(np.float32)))
    tensors = genome_tensors_from_numpy(*genome)
    kwargs = dict(sorted_energies=None, energy_order=None, alpha=1.0, n_qubits=n,
                  use_cvar=False, use_general=True)
    got = population_energies(*tensors, dense, **kwargs)
    scan = population_energies(*tensors, _terms(op), **kwargs)
    tol = 1e-5 * np.abs(op_ref.coeffs).sum()
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    np.testing.assert_allclose(scan.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("case", ["tfim-6", "heisenberg-5", "random-9", "molecular-10"])
def test_grouped_exact_energies_equal_the_term_scan(case):
    op_ref = CASES[case]()
    op = pauli_sum_from_numpy(op_ref.n_qubits, op_ref.z, op_ref.x, op_ref.coeffs)
    states = torch.tensor(_random_states(op.n_qubits, 4, 1))
    got = grouped_exact_energies_from_states(states, grouped_operands(op))
    want = general_pauli_expectation_real(states, *_terms(op))
    torch.testing.assert_close(got, want, atol=1e-5 * float(np.abs(op.coeffs).sum()), rtol=0)


@pytest.mark.parametrize("n", [7, 10, 14, 15])
def test_rotation_helpers_match_jax_and_a_full_rebuild(n):
    op_ref = CASES["molecular-14"]() if n == 14 else random_hermitian(n, 10, n)
    rot_types, rot_angles, _, _ = jax_grouped_operands(op_ref)
    rt, ra = torch.tensor(np.asarray(rot_types)), torch.tensor(np.asarray(rot_angles))
    factors, active = rotation_layer_factors(rt, ra, n)
    factors_ref, active_ref = jax_rotation_factors(rot_types, rot_angles, n)
    np.testing.assert_allclose(factors.numpy(), np.asarray(factors_ref), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(active.numpy(), np.asarray(active_ref))
    assert active.dtype == torch.float32

    genome = _genomes(n, pop=3, layers=2, seed=n)
    tensors = genome_tensors_from_numpy(*genome)
    base = build_fold_pipeline(*tensors, n, absorb_diag=True)
    base_ref = jax_build(*genome, n, absorb_diag=True)
    for g in range(rt.shape[0]):
        extended = extend_fold_pipeline_with_rotation(base, rt[g], ra[g], n)
        rebuilt = build_fold_pipeline(*append_rotation_layer(*tensors, rt[g], ra[g]), n,
                                      absorb_diag=True)
        reference = jax_extend(base_ref, rot_types[g], rot_angles[g], n)
        assert torch.equal(extended.factors[:, :-1], base.factors)
        assert torch.equal(extended.factors[:, -1], rebuilt.factors[:, -1])
        for name, got, full, want in zip(extended._fields, extended, rebuilt, reference):
            if got.dtype == torch.int32:
                assert torch.equal(got, full), name
            else:
                torch.testing.assert_close(got, full, atol=1e-6, rtol=0)
            if name in ("factors", "diag_phase", "abs_phase"):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_append_rotation_layer_applies_last():
    """A masked-off layer before the appended rotation is skipped: the
    extended genome's state is the rotation applied to the circuit's."""
    genome = genome_tensors_from_numpy(*_genomes(8, pop=2, layers=2, seed=4))
    gt, ctrl, ang, mask = genome
    mask = mask.clone()
    mask[0, -1] = False
    op_ref = random_hermitian(8, 10, 5)
    ops = grouped_operands(pauli_sum_from_numpy(8, op_ref.z, op_ref.x, op_ref.coeffs))
    ext = append_rotation_layer(gt, ctrl, ang, mask, ops.rot_types[0], ops.rot_angles[0])
    assert [t.shape[1] for t in ext] == [gt.shape[1] + 1] * 3 + [mask.shape[1] + 1]
    assert bool(ext[3][:, -1].all()) and bool((ext[1][:, -1] == -1).all())
    states = simulate_circuits(gt, ctrl, ang, mask, 8)
    rotated = simulate_circuits(*[t[:, -1:] for t in ext], 8, states)
    torch.testing.assert_close(simulate_circuits(*ext, 8), rotated, atol=1e-6, rtol=0)
