"""The port's population mesh (``queasars_tpu_torch/parallel``) against the
JAX package's (``queasars_tpu/parallel``, on its 8-device CPU mesh).

The padding rule equals the JAX package's for 1, 2, 3, 4 and 8 blocks.
``sharded_population_energies`` on eight CPU blocks equals the JAX function
on its eight devices to 1e-5 * max|table|, and the port's 1- and 8-block
calls are bit-identical; ``sharded_training_step`` is held to the JAX
package's through the evaluator's energies at the returned angles (raw NFT
angles are ambiguous by pi on flat coordinates).  Then the mesh object
itself (explicit, repeated and default devices, the refusal of more
devices than are visible), ``run_population_sharded``'s padding and
operand placement, and the batch-invariant ``atan2`` that keeps a
population of 40 bit-identical across block counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.parallel import mesh as jax_mesh
from queasars_tpu.parallel import population_mesh as jax_population_mesh
from queasars_tpu.parallel import sharded_population_energies as jax_sharded_energies
from queasars_tpu.parallel import sharded_training_step as jax_training_step
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.paulis import pauli_z_string as jax_z_string
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.parallel import (
    pad_population_axis,
    population_mesh,
    population_pad_multiple,
    run_population_sharded,
    shard_packed,
    sharded_population_energies,
    sharded_training_step,
)
from queasars_tpu_torch.parallel.mesh import mesh_of, to_device
from queasars_tpu_torch.paulis import PauliSum, diagonal_energy_table, pauli_z_string
from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
from queasars_tpu_torch.sim.expectation import PauliTerms
from queasars_tpu_torch.utils.batch_invariant import atan2, scope

N = 4


def cpu_mesh(blocks: int):
    return population_mesh(devices=["cpu"] * blocks)


def _problem(pop, seed, n=N):
    """(port packed, JAX packed, port table, JAX table, port operator, JAX
    operator) of a seeded random population under sum_q Z_q."""
    op = PauliSum.sum([pauli_z_string(q, n) for q in range(n)])
    op_ref = JaxPauliSum.sum([jax_z_string(q, n) for q in range(n)])
    ours = EVQEPopulation.random_population(n, 2, pop, True, random_seed=seed)
    theirs = JaxPopulation.random_population(n, 2, pop, True, random_seed=seed)
    return (PackedPopulation.pack(list(ours.individuals)),
            JaxPacked.pack(list(theirs.individuals)),
            diagonal_energy_table(op, dtype=torch.float32),
            jax_table(op_ref, dtype=np.float32), op, op_ref)


@pytest.mark.parametrize("blocks", [1, 2, 3, 4, 8])
def test_padding_rule_equals_jax(blocks):
    ours = cpu_mesh(blocks)
    theirs = jax_population_mesh(blocks)
    assert population_pad_multiple(ours) == jax_mesh.population_pad_multiple(theirs)
    multiple = population_pad_multiple(ours)
    for pop in (1, 3, multiple, multiple + 1, 2 * multiple - 1):
        array = np.arange(pop * 6, dtype=np.float32).reshape(pop, 2, 3)
        want = jax_mesh.pad_population_axis(array, multiple)
        got = pad_population_axis(array, multiple)
        np.testing.assert_array_equal(got, want)
        padded = pad_population_axis(torch.as_tensor(array), multiple)
        assert isinstance(padded, torch.Tensor)
        np.testing.assert_array_equal(padded.numpy(), want)


def test_sharded_energies_equal_jax_and_across_block_counts():
    packed, packed_ref, table, table_ref, op, _ = _problem(pop=12, seed=0)
    one = sharded_population_energies(cpu_mesh(1), packed, table)
    eight = sharded_population_energies(cpu_mesh(8), packed, table)
    np.testing.assert_array_equal(one, eight)
    theirs = jax_sharded_energies(jax_population_mesh(8), packed_ref, table_ref)
    np.testing.assert_allclose(eight, theirs, rtol=0, atol=1e-5 * np.abs(table_ref).max())
    direct = StatevectorExpectationEvaluator(op, device="cpu").evaluate_packed(packed)
    np.testing.assert_array_equal(eight, direct)


def test_sharded_training_step_equals_jax_through_the_evaluator():
    packed, packed_ref, table, table_ref, op, op_ref = _problem(pop=16, seed=1)
    width = int(packed.n_params.max())
    coords = np.stack([
        np.pad(packed.param_coordinates(i), ((0, width - packed.n_params[i]), (0, 0)))
        for i in range(packed.n_individuals)
    ])
    n_free = np.asarray(packed.n_params)
    active = np.ones(packed.n_individuals, bool)
    angles8, energies8 = sharded_training_step(cpu_mesh(8), packed, table, coords, n_free, active)
    angles1, energies1 = sharded_training_step(cpu_mesh(1), packed, table, coords, n_free, active)
    np.testing.assert_array_equal(angles8, angles1)
    np.testing.assert_array_equal(energies8, energies1)
    ref_angles, ref_energies = jax_training_step(
        jax_population_mesh(8), packed_ref, table_ref, coords, n_free, active)
    ours = StatevectorExpectationEvaluator(op, device="cpu").evaluate_packed(packed, angles8)
    theirs = JaxEvaluator(op_ref).evaluate_packed(packed_ref, np.asarray(ref_angles))
    tol = 1e-5 * np.abs(table_ref).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol)
    np.testing.assert_allclose(energies8, ref_energies, rtol=0, atol=tol)
    before = StatevectorExpectationEvaluator(op, device="cpu").evaluate_packed(packed)
    assert energies8.sum() < before.sum()


def test_shard_packed_layout():
    packed = _problem(pop=16, seed=0)[0]
    placed, original = shard_packed(packed, cpu_mesh(8))
    assert original == 16
    blocks = placed["angles"]
    assert len(blocks) == 8
    assert {tuple(b.shape) for b in blocks} == {(2, *packed.angles.shape[1:])}
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), packed.angles)
    placed, _ = shard_packed(_problem(pop=5, seed=0)[0], cpu_mesh(2))
    assert [tuple(b.shape[:1]) for b in placed["layer_mask"]] == [(4,), (4,)]
    assert not torch.cat(placed["layer_mask"])[5:].any()


def test_the_mesh_object(monkeypatch):
    repeated = cpu_mesh(4)
    assert repeated.size == 4 and repeated.ranks == (0, 0, 0, 0)
    assert repeated.local_blocks() == [0, 1, 2, 3]
    assert all(d == torch.device("cpu") for d in repeated.devices)
    assert mesh_of(3, "cpu").devices == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            population_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_of(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert population_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert population_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="exceeds the 2 visible"):
        population_mesh(3)
    # an explicit device list overrides n_devices, as in the JAX package
    assert population_mesh(1, devices=["cpu", "cpu"]).size == 2


def test_run_population_sharded_pads_places_and_trims():
    seen = []

    def fn(pa, ra):
        values, nothing, flags = pa
        (scale, terms), = ra
        seen.append((values.shape[0], values.device, nothing, terms.z_masks))
        assert scale.device == values.device
        return values * scale, flags.to(torch.int64)

    terms = PauliTerms(torch.ones(2), torch.zeros(2), (1, 2), (0, 0))
    values = torch.arange(10, dtype=torch.float32)
    flags = torch.arange(10) % 2 == 0
    out, ints = run_population_sharded(
        cpu_mesh(4), fn, (values, None, flags), ((torch.tensor(2.0), terms),))
    assert [s[0] for s in seen] == [4, 4, 4, 4]
    assert all(s[2] is None and s[3] == (1, 2) for s in seen)
    np.testing.assert_array_equal(out.numpy(), 2 * values.numpy())
    np.testing.assert_array_equal(ints.numpy(), flags.numpy().astype(np.int64))
    moved = to_device({"a": [terms, None, 3.0]}, "cpu")
    assert isinstance(moved["a"][0], PauliTerms) and moved["a"][1:] == [None, 3.0]


def test_atan2_does_not_depend_on_the_tensor_size():
    """torch's CPU atan2 runs vector code over whole chunks and scalar code
    over the rest, which round differently; in ``batch_invariant.scope``
    (where the mesh's blocks run) the port's ``atan2`` gives an element the
    same bits in a tensor of any size."""
    rng = np.random.default_rng(3)
    y = torch.as_tensor(rng.normal(size=70).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=70).astype(np.float32))
    assert torch.equal(atan2(y, x), torch.atan2(y, x))  # outside the scope: torch's
    with scope():
        whole = atan2(y, x)
        for size in (1, 2, 5, 16, 33, 64):
            for start in range(0, 70 - size, 7):
                part = atan2(y[start:start + size], x[start:start + size])
                assert torch.equal(part, whole[start:start + size]), (size, start)
    np.testing.assert_allclose(whole.numpy(), np.arctan2(y.numpy(), x.numpy()), rtol=0,
                               atol=2.5e-7)


def test_nft_population_of_40_is_bit_identical_on_1_and_8_blocks():
    """Pins the batch-invariance repair: NFT on n=4, P=40 (seed 4), whose
    1-block call computes the 3-point fit's atan2 in one vector of 40
    elements and whose 8-block call in blocks of 5; with torch.atan2 the
    two differed in the last bit."""
    packed, _, _, _, op, _ = _problem(pop=40, seed=4)
    width = int(packed.n_params.max())
    coords = np.stack([
        np.pad(packed.param_coordinates(i), ((0, width - packed.n_params[i]), (0, 0)))
        for i in range(packed.n_individuals)
    ])
    results = []
    for blocks in (1, 8):
        evaluator = StatevectorExpectationEvaluator(op, device="cpu")
        evaluator.set_mesh(cpu_mesh(blocks))
        results.append(BatchedNFT(NFTConfig(maxiter=12)).minimize(
            evaluator, packed, coords, np.asarray(packed.n_params),
            np.ones(packed.n_individuals, bool)))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])
