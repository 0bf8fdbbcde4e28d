"""The port's compacted-gate module against the JAX package's, on the CPU.

The compaction must equal the JAX package's field by field; the plain
versions of the two kernels are held against the Pallas kernels in
interpret mode (as tests/test_compact_kernels.py runs them) at the JAX
test's tolerances -- probabilities 1e-6 absolute, energies 1e-5 *
max|table| -- and against the port's slot plain versions bit for bit (the
same gates in the same order with the same per-pair arithmetic).  Inputs
are made from numpy seeds and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation
from queasars_tpu.sim import compact_kernels as jax_compact
from queasars_tpu_torch.interop import compact_gates_from_numpy, genome_tensors_from_numpy
from queasars_tpu_torch.sim import compact_kernels as ck
from queasars_tpu_torch.sim import slot_kernels as sk

#: (n_qubits, layers, population, seed, min_layers): the JAX test's shapes,
#: the last one packed into padded layers (zero-width segments)
CASES = [(7, 3, 5, 7, None), (10, 4, 5, 10, None), (7, 2, 4, 5, 4)]


def _packed(n_qubits, layers, pop, seed, min_layers):
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    return PackedPopulation.pack(list(population.individuals), min_layers=min_layers)


def _both(case):
    """The JAX package's and the port's compaction of one packed genome."""
    packed = _packed(*case)
    n = case[0]
    want = jax_compact.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, n)
    got = ck.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, n, device="cpu")
    return packed, want, got


@pytest.mark.parametrize("case", CASES)
def test_compaction_equals_the_jax_package(case):
    packed, want, got = _both(case)
    for field in ("qubits", "controls", "angle_index", "boundaries"):
        value = getattr(got, field)
        assert value.dtype == torch.int32 and value.device.type == "cpu"
        np.testing.assert_array_equal(value.numpy(), getattr(want, field), err_msg=field)
    assert got.max_gates == want.max_gates
    assert (got.n_qubits, got.n_layers) == (want.n_qubits, want.n_layers)
    assert got.max_count == int(want.boundaries[:, -1].max())
    # padded layers contribute zero-width segments
    real = packed.layer_mask.sum(axis=1)
    for p in range(packed.n_individuals):
        for layer in range(int(real[p]), packed.max_layers):
            assert got.boundaries[p, 2 * layer] == got.boundaries[p, 2 * layer + 2]


def test_compaction_accepts_the_ports_genome_tensors():
    packed = _packed(*CASES[1])
    gt, ctrl, _, mask = genome_tensors_from_numpy(
        packed.gate_types, packed.controls, packed.angles, packed.layer_mask)
    mask[1, 0] = False
    from_tensors = ck.compact_gates(gt, ctrl, mask, 10, bucket=8, device="cpu")
    from_numpy = ck.compact_gates(
        packed.gate_types, packed.controls, mask.numpy(), 10, bucket=8, device="cpu")
    want = jax_compact.compact_gates(packed.gate_types, packed.controls, mask.numpy(), 10, bucket=8)
    for field in ("qubits", "controls", "angle_index", "boundaries"):
        assert torch.equal(getattr(from_tensors, field), getattr(from_numpy, field))
        np.testing.assert_array_equal(getattr(from_tensors, field).numpy(), getattr(want, field))
    assert from_tensors.max_gates % 8 == 0


def test_compaction_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    packed = _packed(*CASES[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, 7)


@pytest.mark.parametrize("case", CASES)
def test_compact_probs_match_the_pallas_kernel(case):
    packed, want, got = _both(case)
    ref = np.asarray(jax_compact.compact_probs(want, packed.angles, interpret=True))
    ck.reset_launch_counts()
    probs = ck.compact_probs(got, torch.as_tensor(packed.angles))
    assert ck.launch_counts["compact_probs"] == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(probs.numpy(), ref, atol=1e-6)


def test_compact_energies_match_the_pallas_kernel():
    n = 10
    rng = np.random.default_rng(1)
    packed = _packed(n, 4, 6, 3, None)
    want = jax_compact.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, n)
    got = ck.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, n, device="cpu")
    table = rng.normal(size=1 << n).astype(np.float32) * 20
    ref = np.asarray(
        jax_compact.compact_energies_exact(want, packed.angles, jnp.asarray(table), interpret=True)
    )
    energies = ck.compact_energies_exact(got, torch.as_tensor(packed.angles), torch.from_numpy(table))
    assert energies.shape == (6,)
    np.testing.assert_allclose(energies.numpy(), ref, atol=1e-5 * np.abs(table).max(), rtol=0)


@pytest.mark.parametrize("n_qubits,layers,pop,seed", [(7, 3, 5, 2), (11, 5, 9, 4)])
def test_plain_versions_equal_the_slot_plain_versions_bit_for_bit(n_qubits, layers, pop, seed):
    packed = _packed(n_qubits, layers, pop, seed, layers + 1)
    gt, ctrl, ang, mask = genome_tensors_from_numpy(
        packed.gate_types, packed.controls, packed.angles, packed.layer_mask)
    mask[0, 1] = False
    assert (gt == 3).any()
    compact = ck.compact_gates(gt, ctrl, mask, n_qubits, device="cpu")
    table = torch.from_numpy(np.random.default_rng(seed).normal(size=1 << n_qubits) * 30).float()
    assert torch.equal(ck.compact_probs_plain(compact, ang),
                       sk.population_probs_plain(gt, ctrl, ang, mask, n_qubits))
    assert torch.equal(ck.compact_energies_exact_plain(compact, ang, table),
                       sk.energies_exact_plain(gt, ctrl, ang, mask, table, n_qubits))


def test_padded_entries_are_never_visited():
    n = 10
    packed = _packed(n, 4, 6, 3, None)
    compact = ck.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, n,
                               device="cpu")
    counts = compact.boundaries[:, -1]
    assert int(counts.min()) < compact.max_gates
    angles = torch.as_tensor(packed.angles)
    want = ck.compact_probs(compact, angles)
    # padding made to look like real gates: a qubit, a control and the
    # angle triple of the individual's first active gate
    pad = torch.arange(compact.max_gates)[None, :] >= counts[:, None]
    compact.qubits[pad] = 3
    compact.controls[pad] = 5
    compact.angle_index[pad] = compact.angle_index[:, :1].expand_as(pad)[pad]
    assert torch.equal(ck.compact_probs(compact, angles), want)


def test_interop_round_trips_a_jax_compaction():
    packed = _packed(*CASES[2])
    want = jax_compact.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, 7)
    got = compact_gates_from_numpy(
        want.qubits, want.controls, want.angle_index, want.boundaries, want.n_qubits,
        want.n_layers, device="cpu")
    for field in ("qubits", "controls", "angle_index", "boundaries"):
        value = getattr(got, field)
        assert value.dtype == torch.int32
        np.testing.assert_array_equal(value.numpy(), getattr(want, field))
    assert (got.n_qubits, got.n_layers, got.max_gates) == (7, want.n_layers, want.max_gates)
    assert got.max_count == int(want.boundaries[:, -1].max())
    native = ck.compact_gates(packed.gate_types, packed.controls, packed.layer_mask, 7,
                              device="cpu")
    angles = torch.as_tensor(packed.angles)
    assert torch.equal(ck.compact_probs(got, angles), ck.compact_probs(native, angles))


def test_bench_shape_compaction_statistics():
    """bench.py's workload as the port builds it (chip_smoke.random_genomes:
    n=20, P=32, 5 real layers in the 6-layer bucket, seed 0)."""
    from queasars_tpu_torch.genome import EVQEPopulation as PortPopulation
    from queasars_tpu_torch.genome import PackedPopulation as PortPacked
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    population = PortPopulation.random_population(20, 5, 32, True, random_seed=0)
    packed = PortPacked.pack(list(population.individuals), min_layers=5)
    gt, ctrl, _, mask = packed_tensors(packed, device="cpu")
    assert tuple(gt.shape) == (32, 6, 20)
    compact = ck.compact_gates(gt, ctrl, mask, 20, device="cpu")
    counts = compact.boundaries[:, -1].numpy()
    assert (counts.min(), counts.max(), compact.max_gates, compact.max_count) == (63, 70, 80, 70)
    assert round(float(counts.mean()), 1) == 67.3
    active = mask[:, :, None] & ((gt == 1) | (gt == 3))
    assert int(active.sum()) == int(counts.sum()) == 2155


def test_port_compact_tool_refuses_without_a_card():
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "port_compact.py")], cwd=repo,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "speedup" not in proc.stdout


def _expand_lists(compact):
    """Each individual's list, layer segment by layer segment, as [P, L, n]
    slot tables: gate type (CU3 where the control is >= 0, else U3) and
    control, -1 where no gate.  Checks on the way the contract the kernel's
    gate source reads: segments in order, at most n gates each, lane qubits
    (q < 7) before the row split and row qubits after it, qubits strictly
    ascending (no (layer, qubit) twice) and angle_index == l * n + q."""
    n, n_layers = compact.n_qubits, compact.n_layers
    qubits, controls, index, bounds = (
        getattr(compact, f).numpy() for f in ("qubits", "controls", "angle_index", "boundaries"))
    pop = qubits.shape[0]
    types = np.zeros((pop, n_layers, n), np.int32)
    ctrls = np.full((pop, n_layers, n), -1, np.int32)
    assert (bounds[:, 0] == 0).all() and (np.diff(bounds, axis=1) >= 0).all()
    assert (bounds[:, -1] <= compact.max_gates).all()
    for p in range(pop):
        for layer in range(n_layers):
            lo, split, hi = bounds[p, 2 * layer: 2 * layer + 3]
            assert hi - lo <= n
            seg = qubits[p, lo:hi]
            assert ((seg >= 0) & (seg < n)).all() and (np.diff(seg) > 0).all()
            assert (seg[: split - lo] < ck.LANE_BITS).all()
            assert (seg[split - lo:] >= ck.LANE_BITS).all()
            np.testing.assert_array_equal(index[p, lo:hi], layer * n + seg)
            types[p, layer, seg] = np.where(controls[p, lo:hi] >= 0, 3, 1)
            ctrls[p, layer, seg] = controls[p, lo:hi]
    return types, ctrls


def _contract_genome(n_qubits, seed):
    """A packed random genome with a padded layer, individual 1's first
    layer masked off and individual 2 without any gate."""
    packed = _packed(n_qubits, 3, 5, seed, 4)
    gate_types, controls, mask = packed.gate_types.copy(), packed.controls, packed.layer_mask.copy()
    mask[1, 0] = False
    gate_types[2] = 0
    assert (gate_types == 3).any()
    return gate_types, controls, mask


def _assert_lists_hold_the_active_slots(compact, gate_types, controls, mask):
    types, ctrls = _expand_lists(compact)
    active = ((gate_types == 1) | (gate_types == 3)) & mask[:, :, None]
    np.testing.assert_array_equal(types, np.where(active, gate_types, 0))
    np.testing.assert_array_equal(ctrls, np.where(active & (gate_types == 3), controls, -1))


@pytest.mark.parametrize("n_qubits", [3, 13, 14, 23])
def test_lists_expand_to_the_genomes_active_slots(n_qubits):
    gate_types, controls, mask = _contract_genome(n_qubits, n_qubits)
    compact = ck.compact_gates(gate_types, controls, mask, n_qubits, device="cpu")
    assert int(compact.boundaries[2, -1]) == 0
    _assert_lists_hold_the_active_slots(compact, gate_types, controls, mask)


def test_a_jax_made_compaction_keeps_the_list_contract():
    n = 14
    gate_types, controls, mask = _contract_genome(n, 3)
    want = jax_compact.compact_gates(gate_types, controls, mask, n)
    got = compact_gates_from_numpy(
        want.qubits, want.controls, want.angle_index, want.boundaries, want.n_qubits,
        want.n_layers, device="cpu")
    _assert_lists_hold_the_active_slots(got, gate_types, controls, mask)


def test_design_bytes_counted_from_the_lists_equal_the_slot_engines():
    """chip_smoke.compact_engine_bytes (from the boundaries) against
    chip_smoke.slot_engine_bytes (from the genome) at bench.py's shape and
    on a genome with a masked layer and a gateless individual."""
    import chip_smoke

    population = EVQEPopulation.random_population(20, 5, 32, True, random_seed=0)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=5)
    for gate_types, controls, mask in ((packed.gate_types, packed.controls, packed.layer_mask),
                                       _contract_genome(20, 5)):
        compact = ck.compact_gates(gate_types, controls, mask, 20, device="cpu")
        want = chip_smoke.slot_engine_bytes(
            torch.as_tensor(gate_types), torch.as_tensor(mask), 20)
        assert chip_smoke.compact_engine_bytes(compact, 20) == want > 0


def test_the_kernels_refuse_widths_past_the_engines():
    n, pop = 32, 2
    compact = ck.CompactGates(*(torch.zeros((pop, 16), dtype=torch.int32) for _ in range(3)),
                              torch.zeros((pop, 3), dtype=torch.int32), n, 1, 0)
    with pytest.raises(ValueError, match="n_qubits <= 31"):
        ck._check(compact, torch.zeros((pop, 1, n, 3)))
