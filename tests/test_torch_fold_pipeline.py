"""The port's kron-fold pipeline against the JAX package's.

``build_fold_pipeline`` on the same numpy genomes in both packages: the
integer fields (compacted controls and targets, counts, group activity)
must agree exactly, the float32 factors and phases to 1e-6 (the two
packages evaluate the same closed-form eigendecomposition with their own
cos/sin/atan2, which differ in the last ulps).  The plain appliers are held
against the dense kron oracle and the slot engine.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation
from queasars_tpu.sim.fold_pipeline import build_fold_pipeline as jax_build
from queasars_tpu.sim.fold_pipeline import cu3_slot_factors_reference as jax_cu3_factors
from queasars_tpu_torch.interop import fold_pipeline_from_numpy, genome_tensors_from_numpy
from queasars_tpu_torch.sim import fold_pipeline as fp
from queasars_tpu_torch.sim.statevector import simulate_circuits

INTEGER_FIELDS = ("diag_ctrl", "diag_tgt", "diag_count", "group_active", "abs_ctrl", "abs_tgt",
                  "abs_count")
FLOAT_FIELDS = ("factors", "diag_phase", "abs_phase")


def genome(n_qubits, layers, pop, seed):
    """Seeded genomes with CU3 slots and a masked padded layer."""
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=layers + 1)
    mask = packed.layer_mask.copy()
    mask[0, layers - 1] = False
    assert (packed.gate_types == 3).any()
    return packed.gate_types, packed.controls, packed.angles, mask


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("n_qubits", [7, 8, 10, 15])
def test_build_matches_jax(n_qubits, absorb):
    g = genome(n_qubits, 3, 5, seed=n_qubits)
    want = jax_build(*g, n_qubits, absorb_diag=absorb)
    got = fp.build_fold_pipeline(*genome_tensors_from_numpy(*g), n_qubits, absorb_diag=absorb)
    for name in INTEGER_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert getattr(got, name).dtype == torch.int32, name
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, err_msg=name)
    if absorb:
        assert int(got.abs_count.sum()) > 0, "the case should absorb some phases"


def test_cu3_eigendecomposition_matches_jax():
    for angles in ((0.7, -1.3, 2.1), (0.0, 0.4, 0.4), (np.pi, 0.2, -2.9)):
        v, ph0, ph1 = fp.cu3_slot_factors_reference(*angles)
        v_ref, ph0_ref, ph1_ref = jax_cu3_factors(*angles)
        np.testing.assert_allclose(v.numpy(), v_ref, atol=1e-6)
        np.testing.assert_allclose([ph0, ph1], [ph0_ref, ph1_ref], atol=1e-6)


def test_interop_carries_a_jax_pipeline():
    n = 9
    want = jax_build(*genome(n, 2, 3, seed=4), n, absorb_diag=True)
    got = fold_pipeline_from_numpy(want)
    for name in fp.FoldPipeline._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        assert getattr(got, name).is_contiguous()
    with pytest.raises(ValueError):
        fold_pipeline_from_numpy(tuple(want)[:-1])


@pytest.mark.parametrize("absorb", [False, True])
def test_plain_applier_matches_dense_oracle_and_slot_engine(absorb):
    n = 8
    tensors = genome_tensors_from_numpy(*genome(n, 3, 4, seed=9))
    pipeline = fp.build_fold_pipeline(*tensors, n, absorb_diag=absorb)
    rng = np.random.default_rng(3)
    initial = rng.normal(size=(4, 2, 1 << n)).astype(np.float32)
    initial = torch.from_numpy(initial / np.sqrt((initial**2).sum(axis=(1, 2), keepdims=True)))
    for init in (None, initial):
        plain = fp.apply_fold_pipeline_plain(pipeline, n, init)
        torch.testing.assert_close(plain, fp.apply_fold_pipeline_reference(pipeline, n, init),
                                   atol=2e-6, rtol=0)
        torch.testing.assert_close(plain, simulate_circuits(*tensors, n, init), atol=5e-6, rtol=0)
    torch.testing.assert_close(fp.simulate_circuits_folded(*tensors, n),
                               simulate_circuits(*tensors, n), atol=5e-6, rtol=0)


def test_group_bounds():
    assert fp.group_bounds(7) == [(0, 7)]
    assert fp.group_bounds(10) == [(0, 7), (7, 3)]
    assert fp.group_bounds(20) == [(0, 7), (7, 7), (14, 6)]
    assert fp.group_bounds(22) == [(0, 7), (7, 7), (14, 8)]
    assert [fp.n_axis_groups(n) for n in (7, 14, 15, 22)] == [1, 2, 3, 3]
