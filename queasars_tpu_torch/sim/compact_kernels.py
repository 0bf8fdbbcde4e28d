"""The compacted-gate kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``queasars_tpu/sim/compact_kernels.py``.  The slot kernels
(``sim/slot_kernels.py``) visit every (layer, qubit) slot of the genome and
skip the empty ones inside the launch; here the host first compacts each
individual's genome into the list of its active gates only
(:func:`compact_gates`), and the kernels walk that list:

==================================  ======================================
wrapper                             replaces (queasars_tpu/sim/
                                    compact_kernels.py)
==================================  ======================================
:func:`compact_energies_exact`      ``compact_energies_exact`` (:338)
:func:`compact_probs`               ``compact_probs`` (:353)
==================================  ======================================

The list is sorted by (layer, axis group, qubit), the axis groups being
the TPU layout's lane qubits (q < 7) and row qubits (q >= 7): that is
ascending qubit order within a layer, the order in which the slot kernels
apply a layer.

The kernels live in ``queasars_tpu_torch/csrc/compact_kernels.cu``.  The
list feeds the slot kernels' circuit engine (``csrc/slot_engine.cuh``)
through a gate source of its own: the same passes over 2^13-amplitude
shared-memory tiles (one launch for the whole circuit at n <= 13, one per
layer and window above, two windows at n <= 22), each pass reading only
its individual's layer segments, the angle triples straight from the live
``[P, L, n, 3]`` angles through ``angle_index`` (no gathered copy), and
never an entry past the individual's count.  The pair arithmetic
(``csrc/common.cuh::u3_apply``) and the energy reduction are the slot
kernels' own, so both kernels give rows 1's and 4's bits exactly on the
same genome.  Bound like the slot kernels: two read+write passes of the
planes per layer with a gate (16 MB per pass and individual at n=20).

Each wrapper takes its plain version (``*_plain``, beside it here) only
because the tensors it was given lie on the CPU.  On CUDA tensors it
launches the kernel or raises; it never falls back.  ``launch_counts``
counts kernel launches (one per wrapper call that launched).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from queasars_tpu_torch.sim.slot_kernels import ENGINE_MAX_QUBITS
from queasars_tpu_torch.sim.statevector import (
    GATE_CROT,
    GATE_ROT,
    apply_u3_pairs,
    init_states,
    u3_entries,
)
from queasars_tpu_torch.utils import cuda_lib
from queasars_tpu_torch.utils.cuda_lib import expect, on_cuda, stream
from queasars_tpu_torch.utils.device import resolve_device

#: qubits below this index sit on the TPU layout's lane axis; the compacted
#: list keeps the JAX package's (lane, row) segments of each layer
LANE_BITS = 7

launch_counts: dict[str, int] = {
    "compact_energies_exact": 0,
    "compact_probs": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@dataclass
class CompactGates:
    """Compacted gate lists of a packed population, on one device.

    ``G`` is the bucketed largest active-gate count over the population.

    - ``qubits`` [P, G] int32 — target qubit per gate
    - ``controls`` [P, G] int32 — control qubit per gate, -1 for plain U3
    - ``angle_index`` [P, G] int32 — flat (layer * n_qubits + qubit) index
      of the gate's angle triple in the [P, L*n, 3] angle view
    - ``boundaries`` [P, 2L+1] int32 — segment starts: gates
      [boundaries[2l], boundaries[2l+1]) are layer l's lane-axis gates
      (q < 7), [boundaries[2l+1], boundaries[2l+2]) its row-axis gates;
      ``boundaries[:, 2L]`` is each individual's count
    - ``max_count`` — the largest count, known on the host

    Padded entries (qubit 0, control -1, angle index 0) lie past each
    individual's count and are never visited.
    """

    qubits: torch.Tensor
    controls: torch.Tensor
    angle_index: torch.Tensor
    boundaries: torch.Tensor
    n_qubits: int
    n_layers: int
    max_count: int

    @property
    def max_gates(self) -> int:
        return int(self.qubits.shape[1])


def _host(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def compact_gates(
    gate_types, controls, layer_mask, n_qubits: int, bucket: int = 16, device=None
) -> CompactGates:
    """Compact [P, L, n] genome structure tensors (numpy, or the port's
    genome tensors) into per-individual active-gate lists on ``device``
    (the card unless the caller asks for the CPU); see
    :class:`CompactGates`.

    ``bucket`` pads the gate dimension so that similar populations share
    few shapes.  The same lists, padding and boundaries as the JAX
    package's ``compact_gates``."""
    device = resolve_device(device)
    gate_types = _host(gate_types)
    controls = _host(controls)
    layer_mask = _host(layer_mask).astype(bool)
    pop, n_layers, _ = gate_types.shape

    active = ((gate_types == GATE_ROT) | (gate_types == GATE_CROT)) & layer_mask[:, :, None]
    flat = active.reshape(pop, n_layers * n_qubits)
    counts = flat.sum(axis=1)
    max_count = int(counts.max(initial=0))
    g_max = -(-max(max_count, 1) // bucket) * bucket

    # within a layer the lane-axis group then the row-axis group, each in
    # ascending qubit order: ascending (layer, qubit), the flat index order
    rows, cols = np.nonzero(flat)
    pos = np.cumsum(flat, axis=1)[rows, cols] - 1
    qubits = np.zeros((pop, g_max), np.int32)
    ctrl = np.full((pop, g_max), -1, np.int32)
    angle_index = np.zeros((pop, g_max), np.int32)
    qubits[rows, pos] = cols % n_qubits
    crot = gate_types.reshape(pop, -1)[rows, cols] == GATE_CROT
    ctrl[rows, pos] = np.where(crot, controls.reshape(pop, -1)[rows, cols], -1)
    angle_index[rows, pos] = cols

    segments = np.stack(
        [active[:, :, :LANE_BITS].sum(axis=2), active[:, :, LANE_BITS:].sum(axis=2)], axis=2
    ).reshape(pop, 2 * n_layers)
    boundaries = np.zeros((pop, 2 * n_layers + 1), np.int32)
    boundaries[:, 1:] = np.cumsum(segments, axis=1)
    return CompactGates(
        *(torch.as_tensor(a, device=device) for a in (qubits, ctrl, angle_index, boundaries)),
        n_qubits=int(n_qubits), n_layers=int(n_layers), max_count=max_count,
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gate_entries(compact: CompactGates, angles: torch.Tensor) -> list[torch.Tensor]:
    """U3 entries of every compacted gate: 8 tensors [P, G] (re, im of u00,
    u01, u10, u11).  Each slot's entries come from the very call the slot
    engine makes (``u3_entries`` of that slot's [P] angle batch), then are
    gathered by ``angle_index`` over the [P, L*n] slot view: PyTorch's CPU
    trigonometry rounds by its position in a batch, so computing them on
    gathered angles could part from the slot engine in the last bit."""
    pop, n_layers, n_qubits = angles.shape[:3]
    per_slot = [u3_entries(angles[:, l, q]) for l in range(n_layers) for q in range(n_qubits)]
    index = compact.angle_index.long()
    return [
        torch.gather(torch.stack([slot[e][part] for slot in per_slot], dim=1), 1, index)
        for e in range(4)
        for part in range(2)
    ]


def _compact_states_plain(compact: CompactGates, angles: torch.Tensor) -> torch.Tensor:
    """States [P, 2, 2^n] after each individual's compacted gate list,
    applied gate by gate up to its own count with the slot engine's pair
    arithmetic; the individuals whose g-th gate has one qubit go together."""
    pop, n = angles.shape[0], compact.n_qubits
    state = init_states(pop, n, device=angles.device)
    entries = _gate_entries(compact, angles)
    counts = _host(compact.boundaries[:, -1])
    qubits = _host(compact.qubits)
    for g in range(compact.max_count):
        live = counts > g
        for q in np.unique(qubits[live, g]):
            idx = torch.as_tensor(np.nonzero(live & (qubits[:, g] == q))[0], device=angles.device)
            control = compact.controls[idx, g]
            gate = [(entries[2 * e][idx, g], entries[2 * e + 1][idx, g]) for e in range(4)]
            on = torch.ones_like(control, dtype=torch.bool)
            state[idx] = apply_u3_pairs(state[idx], int(q), gate, on, control >= 0, control, n)
    return state


def compact_probs_plain(compact: CompactGates, angles: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`compact_probs`."""
    states = _compact_states_plain(compact, angles)
    return states[:, 0, :] ** 2 + states[:, 1, :] ** 2


def compact_energies_exact_plain(
    compact: CompactGates, angles: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`compact_energies_exact`."""
    return (compact_probs_plain(compact, angles) * table).sum(dim=-1)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _lists(compact: CompactGates) -> tuple:
    return (compact.qubits, compact.controls, compact.angle_index, compact.boundaries)


def _check(compact: CompactGates, angles: torch.Tensor) -> int:
    pop, g_max, n, n_layers = angles.shape[0], compact.max_gates, compact.n_qubits, compact.n_layers
    if not 1 <= n <= ENGINE_MAX_QUBITS:
        raise ValueError(f"the compacted-gate kernels need 1 <= n_qubits <= {ENGINE_MAX_QUBITS}")
    for name, t in zip(("qubits", "controls", "angle_index"), _lists(compact)):
        expect(t, name, torch.int32, (pop, g_max))
    expect(compact.boundaries, "boundaries", torch.int32, (pop, 2 * n_layers + 1))
    # angle_index is flat into the [P, L*n, 3] view of contiguous angles
    expect(angles, "angles", torch.float32, (pop, n_layers, n, 3))
    if not 0 <= compact.max_count <= g_max:
        raise ValueError(f"max_count {compact.max_count} outside [0, {g_max}]")
    return pop


def compact_probs(compact: CompactGates, angles: torch.Tensor) -> torch.Tensor:
    """Measurement probabilities [P, 2^n] after each individual's compacted
    gate list, from |0...0>; ``angles`` is the live [P, L, n, 3] tensor."""
    if not on_cuda(*_lists(compact), angles):
        return compact_probs_plain(compact, angles)
    pop = _check(compact, angles)
    dim = 1 << compact.n_qubits
    probs = torch.empty((pop, dim), dtype=torch.float32, device=angles.device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=angles.device)
    status = cuda_lib.load().qt_compact_probs(
        probs.data_ptr(), work.data_ptr(), *(t.data_ptr() for t in _lists(compact)),
        angles.data_ptr(), pop, compact.max_gates, compact.max_count, compact.n_layers,
        compact.n_qubits, stream(),
    )
    cuda_lib.check(status, "qt_compact_probs")
    launch_counts["compact_probs"] += 1
    return probs


def compact_energies_exact(
    compact: CompactGates, angles: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Exact diagonal energies [P]: sum_i |psi_i|^2 * table[i] after each
    individual's compacted gate list, from |0...0>, with the slot kernels'
    deterministic reduction (equal inputs give equal bits)."""
    if not on_cuda(*_lists(compact), angles, table):
        return compact_energies_exact_plain(compact, angles, table)
    pop = _check(compact, angles)
    dim = 1 << compact.n_qubits
    expect(table, "table", torch.float32, (dim,))
    kernels = cuda_lib.load()
    device = angles.device
    out = torch.empty(pop, dtype=torch.float32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    partial = torch.empty(
        (pop, kernels.qt_energy_partials(compact.n_qubits)), dtype=torch.float32, device=device
    )
    status = kernels.qt_compact_energies_exact(
        out.data_ptr(), work.data_ptr(), partial.data_ptr(),
        *(t.data_ptr() for t in _lists(compact)), angles.data_ptr(), table.data_ptr(),
        pop, compact.max_gates, compact.max_count, compact.n_layers, compact.n_qubits, stream(),
    )
    cuda_lib.check(status, "qt_compact_energies_exact")
    launch_counts["compact_energies_exact"] += 1
    return out
