"""The kron-fold route against the benchmark's plain float64 reference
(``benchmark/reference/statevector.py``, which imports nothing of the port).

Seeded random EVQE populations of mixed depth at n = 8-10 (every gate kind:
identity, U3, the control half and the rotation half of CU3, with controls
and targets in both axis groups, the higher one included), packed with
``pack_min_layers``, go through :func:`build_fold_pipeline` (absorbed phases
on, as the port's route builds it) and the fold kernels' plain versions,
from |0...0> and from a seeded start state per individual.  The reference
simulates each individual's serialized circuit gate by gate.

Tolerances: the port keeps float32 amplitudes, so a state after ~7 kron
layers and the phase passes is off by a few float32 ulps of its largest
amplitude (readings up to 6.3e-7 here): amplitudes and probabilities within
1e-5, energies within 1e-5 * max|table| (16x room).  The same reference in
bfloat16 (8 mantissa bits) reads 1.5e-3 or more on energies and amplitudes
and 2.9e-4 on probabilities, and fails every tolerance.
"""

from __future__ import annotations

import functools

import pytest
import torch

from benchmark import program
from benchmark.reference import statevector
from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.genome.gates import EVQEGateType
from queasars_tpu_torch.sim import fold_kernels
from queasars_tpu_torch.sim.evaluators import packed_tensors
from queasars_tpu_torch.sim.fold_pipeline import LANE_BITS, build_fold_pipeline

AMPLITUDE_TOL = 1e-5
PROBABILITY_TOL = 1e-5
ENERGY_TOL = 1e-5  # times max|table|
PACK_MIN_LAYERS = 6
CASES = [(n, seed) for n in (8, 9, 10) for seed in (0, 1, 2)]


@functools.lru_cache(maxsize=None)
def _case(n: int, seed: int):
    """Individuals of 2-5 layers, their packed genome tensors, an energy
    table and a float32 start state per individual (the reference starts
    from the same rounded values)."""
    individuals = []
    for k, layers in enumerate((2, 3, 5, 4)):
        individuals += EVQEPopulation.random_population(
            n, layers, 3, True, random_seed=1000 * n + 10 * seed + k).individuals
    packed = PackedPopulation.pack(individuals, min_layers=PACK_MIN_LAYERS)
    generator = torch.Generator().manual_seed(seed)
    table = (torch.rand(1 << n, generator=generator, dtype=torch.float64) * 8 - 3).float()
    start = torch.randn(len(individuals), 2, 1 << n, generator=generator, dtype=torch.float64)
    start = (start / start.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()).float()
    return individuals, packed, table, start


def _port(n, seed, from_start):
    individuals, packed, table, start = _case(n, seed)
    pipeline = build_fold_pipeline(*packed_tensors(packed), n, absorb_diag=True)
    initial = start if from_start else None
    return (fold_kernels.energies_exact_folded_plain(pipeline, table, n, initial),
            fold_kernels.population_probs_folded_plain(pipeline, n, initial),
            fold_kernels.population_states_folded_plain(pipeline, n, initial))


def _reference(n, seed, from_start, dtype=torch.float64):
    """Per individual: (energy, probabilities, (re, im)) in float64, the
    circuit simulated in ``dtype``."""
    individuals, _, table, start = _case(n, seed)
    out = []
    for p, individual in enumerate(individuals):
        initial = (start[p, 0], start[p, 1]) if from_start else None
        re, im = statevector.final_state(program.circuit(individual), dtype=dtype,
                                         initial=initial)
        probs = re * re + im * im
        energy = float((probs * table.to(dtype)).sum())
        out.append((energy, probs.double(), (re.double(), im.double())))
    return out


def _gaps(port, reference, table):
    energies, probs, states = port
    scale = float(table.abs().max())
    energy = max(abs(float(energies[p]) - e) / scale for p, (e, _, _) in enumerate(reference))
    probability = max(float((probs[p].double() - pr).abs().max())
                      for p, (_, pr, _) in enumerate(reference))
    amplitude = max(max(float((states[p, 0].double() - re).abs().max()),
                        float((states[p, 1].double() - im).abs().max()))
                    for p, (_, _, (re, im)) in enumerate(reference))
    return {"energy": energy, "probability": probability, "amplitude": amplitude}


@pytest.mark.parametrize("n, seed", CASES)
def test_the_populations_hold_every_gate_kind_in_both_axis_groups(n, seed):
    _, packed, _, _ = _case(n, seed)
    on = torch.as_tensor(packed.layer_mask)[:, :, None].expand(*packed.gate_types.shape)
    kinds = torch.as_tensor(packed.gate_types)[on]
    assert set(kinds.tolist()) == {k.value for k in EVQEGateType}
    crot = (torch.as_tensor(packed.gate_types) == EVQEGateType.CONTROLLED_ROTATION.value) & on
    controls = torch.as_tensor(packed.controls)[crot]
    targets = crot.nonzero()[:, 2]
    high = controls >= LANE_BITS
    assert high.any() and (~high).any()
    assert ((targets < LANE_BITS) & high).any()
    if n > LANE_BITS + 1:  # control and target both in the higher group
        assert ((targets >= LANE_BITS) & high).any()
    assert len({int(m) for m in torch.as_tensor(packed.layer_mask).sum(dim=1)}) == 4


@pytest.mark.parametrize("from_start", [False, True], ids=["zero", "start"])
@pytest.mark.parametrize("n, seed", CASES)
def test_fold_energies_equal_the_reference(n, seed, from_start):
    gaps = _gaps(_port(n, seed, from_start), _reference(n, seed, from_start), _case(n, seed)[2])
    assert gaps["energy"] <= ENERGY_TOL, gaps


@pytest.mark.parametrize("from_start", [False, True], ids=["zero", "start"])
@pytest.mark.parametrize("n, seed", CASES)
def test_fold_probabilities_equal_the_reference(n, seed, from_start):
    gaps = _gaps(_port(n, seed, from_start), _reference(n, seed, from_start), _case(n, seed)[2])
    assert gaps["probability"] <= PROBABILITY_TOL, gaps


@pytest.mark.parametrize("from_start", [False, True], ids=["zero", "start"])
@pytest.mark.parametrize("n, seed", CASES)
def test_fold_states_equal_the_reference(n, seed, from_start):
    gaps = _gaps(_port(n, seed, from_start), _reference(n, seed, from_start), _case(n, seed)[2])
    assert gaps["amplitude"] <= AMPLITUDE_TOL, gaps


@pytest.mark.parametrize("from_start", [False, True], ids=["zero", "start"])
@pytest.mark.parametrize("n", [8, 10])
def test_the_reference_in_bfloat16_fails_every_tolerance(n, from_start):
    lower = _reference(n, 0, from_start, dtype=torch.bfloat16)
    truth = _reference(n, 0, from_start)
    energies = torch.tensor([e for e, _, _ in lower], dtype=torch.float64)
    probs = torch.stack([p for _, p, _ in lower])
    states = torch.stack([torch.stack(s) for _, _, s in lower])
    gaps = _gaps((energies, probs, states), truth, _case(n, 0)[2])
    assert gaps["energy"] > ENERGY_TOL, gaps
    assert gaps["probability"] > PROBABILITY_TOL, gaps
    assert gaps["amplitude"] > AMPLITUDE_TOL, gaps
