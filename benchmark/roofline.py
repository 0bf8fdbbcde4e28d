"""The least time the H100 could take for the circuit simulations it is
handed: the larger of the bytes over the memory bandwidth and the FLOPs
over the float32 rate.

The rules are frozen here from the port's smoke script (``chip_smoke.py``:
``circuit_flops``, ``bound``, ``genome_bytes``, ``sweep_plan``,
``sweep_flops`` and the rows' bounds), so that a later change to the
program or its scripts cannot make the count stale:

- a U3 on one amplitude pair takes 24 FLOPs; a CU3 acts on half the pairs;
- an energy takes 5 FLOPs per amplitude, a probability 3;
- each input is read once and each output written once: the genome (20
  bytes per slot and one per layer flag), the float32 table, a start state
  of [P, 2, 2^n] float32 planes, and the outputs (energies, states or
  probabilities);
- an NFT layer sweep takes, per rebuild step, the swept layer without the
  probed gate and the probed gate's pair sums (28 FLOPs per pair it acts
  on, 5 per amplitude it does not), and per step at which an individual's
  probed qubit changes, two gates and the new pair sums.

Work is counted from what each call is handed at the port's evaluation
entry points, never from which kernel ran.
"""

from __future__ import annotations

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
FLOPS_PER_PAIR = 24
FLOPS_PER_AMPLITUDE_ENERGY = 5
FLOPS_PER_AMPLITUDE_PROB = 3
FLOPS_PER_PAIR_SUMS = 28
FLOPS_PER_AMPLITUDE_OFF = 5
GATE_ROT, GATE_CROT = 1, 3


def circuit_flops(gate_types: np.ndarray, layer_mask: np.ndarray, n_qubits: int) -> float:
    """FLOPs of the active slots: a U3 touches every amplitude pair, a CU3
    the half whose control bit is set."""
    on = layer_mask[:, :, None]
    rot = int(((gate_types == GATE_ROT) & on).sum())
    crot = int(((gate_types == GATE_CROT) & on).sum())
    pairs = 1 << (n_qubits - 1)
    return FLOPS_PER_PAIR * (rot * pairs + crot * pairs / 2)


def genome_bytes(gate_types: np.ndarray, layer_mask: np.ndarray) -> int:
    """Gate type, control and three angles per slot, one flag per layer."""
    return gate_types.size * (4 + 4 + 12) + layer_mask.size


def least_seconds(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time of the work and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def energies_work(gate_types, layer_mask, n_qubits: int, from_state: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of exact diagonal energies [P] of the circuits under
    ``layer_mask``, from |0...0> or from a per-individual start state."""
    pop, dim = gate_types.shape[0], 1 << n_qubits
    moved = genome_bytes(gate_types, layer_mask) + 4 * dim + 4 * pop
    moved += 8 * dim * pop if from_state else 0
    return moved, circuit_flops(gate_types, layer_mask, n_qubits) + (
        FLOPS_PER_AMPLITUDE_ENERGY * dim * pop)


def states_work(gate_types, layer_mask, n_qubits: int, from_state: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the [P, 2, 2^n] states after the circuits."""
    pop, dim = gate_types.shape[0], 1 << n_qubits
    moved = genome_bytes(gate_types, layer_mask) + 8 * dim * pop
    moved += 8 * dim * pop if from_state else 0
    return moved, circuit_flops(gate_types, layer_mask, n_qubits)


def probs_work(gate_types, layer_mask, n_qubits: int, from_state: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the [P, 2^n] measurement probabilities."""
    pop, dim = gate_types.shape[0], 1 << n_qubits
    moved = genome_bytes(gate_types, layer_mask) + 4 * dim * pop
    moved += 8 * dim * pop if from_state else 0
    return moved, circuit_flops(gate_types, layer_mask, n_qubits) + (
        FLOPS_PER_AMPLITUDE_PROB * dim * pop)


def sweep_plan(layer_gate_types, qubits, n_free, active, maxiter: int, reset_interval: int):
    """Each rebuild step's probed qubit per individual and every transition
    (individual, last qubit, next qubit) of an NFT layer sweep whose
    individual ``p`` cycles over the qubits ``qubits[p, :n_free[p]]``."""
    pop = layer_gate_types.shape[0]

    def probed(k):
        return [int(qubits[p, k % max(int(n_free[p]), 1)]) for p in range(pop)]

    rebuilds, transitions = [], []
    for k in range(max(maxiter, 1)):
        now = probed(k)
        if k % reset_interval == 0:
            rebuilds.append(now)
            continue
        last = probed(k - 1)
        transitions += [(p, last[p], now[p]) for p in range(pop)
                        if active[p] and n_free[p] > 0 and last[p] != now[p]]
    return rebuilds, transitions


def sweep_flops(layer_gate_types: np.ndarray, n_qubits: int, rebuilds, transitions) -> float:
    """FLOPs of a layer sweep's schedule (see :func:`sweep_plan`)."""
    gt = layer_gate_types
    pairs, dim = 1 << (n_qubits - 1), 1 << n_qubits

    def gate(p, q):
        return FLOPS_PER_PAIR * pairs * {GATE_ROT: 1.0, GATE_CROT: 0.5}.get(int(gt[p, q]), 0.0)

    def sums(p, q):
        acting = pairs // 2 if gt[p, q] == GATE_CROT else pairs
        return FLOPS_PER_PAIR_SUMS * acting + FLOPS_PER_AMPLITUDE_OFF * (dim - 2 * acting)

    total = 0.0
    for probed in rebuilds:
        for p, q in enumerate(probed):
            total += sum(gate(p, r) for r in range(n_qubits) if r != q) + sums(p, q)
    for p, last, q in transitions:
        total += gate(p, last) + gate(p, q) + sums(p, q)
    return total


def layer_sweep_work(gate_types, layer_mask, last_layer, coords_qa, n_free, active,
                     n_qubits: int, maxiter: int, reset_interval: int,
                     from_state: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of a last-layer NFT sweep handed whole genomes: the
    prefix before each individual's ``last_layer`` and the sweep of that
    layer.  Reads the genome, the table, the coordinates and the start
    state; writes the swept layer's angles and the energies."""
    pop, dim = gate_types.shape[0], 1 << n_qubits
    rows = np.arange(pop)
    layers = np.arange(layer_mask.shape[1])
    prefix = layer_mask & (layers[None, :] < last_layer[:, None])
    swept = gate_types[rows, last_layer]
    rebuilds, transitions = sweep_plan(swept, coords_qa[:, :, 0].clip(0, n_qubits - 1), n_free,
                                       active, maxiter, reset_interval)
    moved = (genome_bytes(gate_types, layer_mask) + 4 * dim
             + pop * (coords_qa.shape[1] * 8 + 2 * n_qubits * 12 + 9))
    moved += 8 * dim * pop if from_state else 0
    flops = circuit_flops(gate_types, prefix, n_qubits) + sweep_flops(
        swept, n_qubits, rebuilds, transitions)
    return moved, flops
