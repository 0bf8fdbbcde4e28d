"""The kron-fold circuit kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``queasars_tpu/sim/pallas_fold_kernels.py``.  Six wrappers,
each the port of one Pallas kernel, driven by a :class:`FoldPipeline`
(``sim/fold_pipeline.py``):

====================================  ===========================================
wrapper                               replaces (queasars_tpu/sim/
                                      pallas_fold_kernels.py)
====================================  ===========================================
:func:`energies_exact_folded`         ``pallas_energies_exact_folded`` (:743)
:func:`population_states_folded`      ``pallas_population_states_folded`` (:1195)
:func:`nft_layer_sweep_folded`        ``pallas_nft_layer_sweep_folded`` (:1623)
:func:`population_probs_folded`       ``pallas_population_probs_folded`` (:699)
:func:`sampled_shot_indices_folded`   ``pallas_sampled_shot_energies_folded``
                                      (:795), up to its energy gather
:func:`grouped_shot_indices_folded`   ``pallas_grouped_shot_energies_folded``
                                      (:1043), up to its energy gathers
====================================  ===========================================

The kernels live in ``queasars_tpu_torch/csrc/fold_kernels.cu``; its header
says how they are laid out on the H100.  One circuit engine carries all six:
each kron layer is applied factor by factor (2x2 per qubit, qubit 0 first,
the plain version's order) in at most two passes over tiles of 2^13
amplitudes held in shared memory -- pass A over bits 0-12, pass B over bits
13..n-1, which also applies the layer's controlled-diagonal phases -- so the
engine is bound by the bytes of those passes and the arithmetic of its
factors, no longer by dense group products.  The TPU kernels' SMEM
packing, VMEM chunking, dense MXU group matrices and bf16x3 limb emulation
have no counterpart: the CUDA kernels read the pipeline tensors as they
are and compute in fp32 (the TPU's sampled kernel ran single-pass bf16;
here it is fp32 like the rest, closer to the exact state).  The sampled
kernels end in the hierarchical inverse CDF shared with the slot sampler
(``csrc/sampler.cuh``); the grouped one runs the circuit once and then,
per QWC measurement group, that group's rotation kron layer through the
same passes into a second buffer, and the epilogue.  The folded NFT sweep
builds each individual's BASE (the swept layer's REST applied to the
prefix) with this engine on the first step and every ``reset_interval``
steps; between those it shares the slot sweep's fused transition pass and
step (``csrc/sweep.cuh``).

Each wrapper takes its plain version (``*_plain``, beside it here) only
because the tensors it was given lie on the CPU.  On CUDA tensors it
launches the kernel or raises; it never falls back.  ``launch_counts``
counts kernel launches (one per wrapper call that launched).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from queasars_tpu_torch.sim.fold_pipeline import (
    LANE_BITS,
    FoldPipeline,
    _apply_factors,
    apply_fold_pipeline_plain,
    build_fold_pipeline,
    group_bounds,
    n_axis_groups,
)
from queasars_tpu_torch.sim.sampling import hierarchical_sample_plain
from queasars_tpu_torch.sim.slot_kernels import (
    SAMPLER_MIN_QUBITS,
    check_uniforms,
    sampler_scratch,
    sweep_transitions,
)
from queasars_tpu_torch.sim.statevector import GATE_CROT, GATE_ROT
from queasars_tpu_torch.utils import cuda_lib
from queasars_tpu_torch.utils.cuda_lib import expect, on_cuda, ptr, stream

launch_counts: dict[str, int] = {
    "energies_exact_folded": 0,
    "population_states_folded": 0,
    "nft_layer_sweep_folded": 0,
    "population_probs_folded": 0,
    "sampled_shot_indices_folded": 0,
    "grouped_shot_indices_folded": 0,
}

#: the folded in-kernel sampler's largest size (the slot sampler's is 20)
SAMPLER_MAX_QUBITS = 21
#: largest n per path (the reference's caps: its sampler's scratch and its
#: sweep's four resident state planes)
_CAPS = {"exact": 22, "sampler": SAMPLER_MAX_QUBITS, "sweep": 20}
#: most measurement groups the one-launch grouped sampler takes (the
#: reference's bound on its static per-group unroll)
GROUPED_MAX_GROUPS = 64


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def fold_supported(n_qubits: int, device, path: str = "exact") -> bool:
    """True when the fold kernels apply: tensors on a CUDA device and
    7 <= n <= 22 (``path="exact"``, also probabilities and states),
    n <= 21 (``path="sampler"``) or n <= 20 (``path="sweep"``)."""
    if path not in _CAPS:
        raise ValueError(f"unknown fold path {path!r}; expected one of {sorted(_CAPS)}")
    return torch.device(device).type == "cuda" and LANE_BITS <= n_qubits <= _CAPS[path]


# ---------------------------------------------------------------------------
# argument checks shared by the CUDA paths
# ---------------------------------------------------------------------------


def _check_pipeline(pipeline: FoldPipeline, n_qubits: int) -> tuple[int, int, int]:
    """(P, kron layers, diagonal slots) of a pipeline in the kernels'
    contract; raises on a wrong dtype, shape or layout."""
    if n_qubits < LANE_BITS:
        raise ValueError("the fold kernels need n_qubits >= 7")
    pop, n_kron = pipeline.factors.shape[0], pipeline.factors.shape[1]
    n_layers, d_slots = n_kron - 1, pipeline.diag_ctrl.shape[2]
    n_groups = n_axis_groups(n_qubits)
    expect(pipeline.factors, "factors", torch.float32, (pop, n_kron, n_qubits, 2, 2, 2))
    for prefix in ("diag", "abs"):
        expect(getattr(pipeline, f"{prefix}_ctrl"), f"{prefix}_ctrl", torch.int32,
                (pop, n_layers, d_slots))
        expect(getattr(pipeline, f"{prefix}_tgt"), f"{prefix}_tgt", torch.int32,
                (pop, n_layers, d_slots))
        expect(getattr(pipeline, f"{prefix}_phase"), f"{prefix}_phase", torch.float32,
                (pop, n_layers, d_slots, 2, 2))
        expect(getattr(pipeline, f"{prefix}_count"), f"{prefix}_count", torch.int32,
                (pop, n_layers))
    expect(pipeline.group_active, "group_active", torch.int32, (pop, n_kron, n_groups))
    return pop, n_kron, d_slots


def _pipeline_ptrs(pipeline: FoldPipeline) -> list[int]:
    """The ten pipeline tensors' device pointers, in the C entry points'
    order (the FoldPipeline field order)."""
    return [t.data_ptr() for t in pipeline]


# ---------------------------------------------------------------------------
# population_states_folded
# ---------------------------------------------------------------------------


def population_states_folded_plain(pipeline: FoldPipeline, n_qubits: int, initial=None):
    """Plain version of :func:`population_states_folded`."""
    return apply_fold_pipeline_plain(pipeline, n_qubits, initial)


def population_states_folded(pipeline: FoldPipeline, n_qubits: int, initial=None):
    """Statevector planes [P, 2, 2^n] after each pipeline's circuit, from
    |0...0> or per-individual ``initial`` [P, 2, 2^n] states (the reference
    starts from |0...0> only; the optional start state is the port's)."""
    if not on_cuda(*pipeline, initial):
        return population_states_folded_plain(pipeline, n_qubits, initial)
    pop, n_kron, d_slots = _check_pipeline(pipeline, n_qubits)
    dim = 1 << n_qubits
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    out = torch.empty((pop, 2, dim), dtype=torch.float32, device=pipeline.factors.device)
    status = cuda_lib.load().qt_fold_states(
        out.data_ptr(), ptr(initial), *_pipeline_ptrs(pipeline),
        pop, n_kron, n_qubits, d_slots, stream(),
    )
    cuda_lib.check(status, "qt_fold_states")
    launch_counts["population_states_folded"] += 1
    return out


# ---------------------------------------------------------------------------
# population_probs_folded
# ---------------------------------------------------------------------------


def population_probs_folded_plain(pipeline: FoldPipeline, n_qubits: int, initial=None):
    """Plain version of :func:`population_probs_folded`."""
    states = apply_fold_pipeline_plain(pipeline, n_qubits, initial)
    return states[:, 0] ** 2 + states[:, 1] ** 2


def population_probs_folded(pipeline: FoldPipeline, n_qubits: int, initial=None):
    """Measurement probabilities [P, 2^n] after each pipeline's circuit."""
    if not on_cuda(*pipeline, initial):
        return population_probs_folded_plain(pipeline, n_qubits, initial)
    pop, n_kron, d_slots = _check_pipeline(pipeline, n_qubits)
    dim = 1 << n_qubits
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    device = pipeline.factors.device
    probs = torch.empty((pop, dim), dtype=torch.float32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    status = cuda_lib.load().qt_fold_probs(
        probs.data_ptr(), work.data_ptr(), ptr(initial), *_pipeline_ptrs(pipeline),
        pop, n_kron, n_qubits, d_slots, stream(),
    )
    cuda_lib.check(status, "qt_fold_probs")
    launch_counts["population_probs_folded"] += 1
    return probs


# ---------------------------------------------------------------------------
# energies_exact_folded
# ---------------------------------------------------------------------------


def energies_exact_folded_plain(pipeline: FoldPipeline, table, n_qubits: int, initial=None):
    """Plain version of :func:`energies_exact_folded`."""
    return (population_probs_folded_plain(pipeline, n_qubits, initial) * table).sum(dim=-1)


def energies_exact_folded(pipeline: FoldPipeline, table, n_qubits: int, initial=None):
    """Exact diagonal energies [P]: sum_i |psi_i|^2 * table[i] after each
    pipeline's circuit (from |0...0> or per-individual ``initial``).  The
    reduction is deterministic: equal inputs give equal bits."""
    if not on_cuda(*pipeline, table, initial):
        return energies_exact_folded_plain(pipeline, table, n_qubits, initial)
    pop, n_kron, d_slots = _check_pipeline(pipeline, n_qubits)
    dim = 1 << n_qubits
    expect(table, "table", torch.float32, (dim,))
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    kernels = cuda_lib.load()
    device = pipeline.factors.device
    out = torch.empty(pop, dtype=torch.float32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    partial = torch.empty(
        (pop, kernels.qt_energy_partials(n_qubits)), dtype=torch.float32, device=device
    )
    status = kernels.qt_fold_energies(
        out.data_ptr(), work.data_ptr(), partial.data_ptr(), ptr(initial), table.data_ptr(),
        *_pipeline_ptrs(pipeline), pop, n_kron, n_qubits, d_slots, stream(),
    )
    cuda_lib.check(status, "qt_fold_energies")
    launch_counts["energies_exact_folded"] += 1
    return out


# ---------------------------------------------------------------------------
# sampled_shot_indices_folded
# ---------------------------------------------------------------------------


def sampled_shot_indices_folded_plain(pipeline: FoldPipeline, u_frac, n_qubits: int, initial=None):
    """Plain version of :func:`sampled_shot_indices_folded`."""
    probs = population_probs_folded_plain(pipeline, n_qubits, initial)
    return hierarchical_sample_plain(probs, u_frac)


def sampled_shot_indices_folded(pipeline: FoldPipeline, u_frac, n_qubits: int, initial=None):
    """Sampled basis indices int32 [P, S] after each pipeline's circuit
    (from |0...0> or per-individual ``initial``) at the uniforms ``u_frac``
    [P, S] in [0, 1), by the slot sampler's hierarchical inverse CDF
    (14 <= n <= 21).  The caller gathers ``table[indices]``."""
    if not on_cuda(*pipeline, u_frac, initial):
        return sampled_shot_indices_folded_plain(pipeline, u_frac, n_qubits, initial)
    if not SAMPLER_MIN_QUBITS <= n_qubits <= SAMPLER_MAX_QUBITS:
        raise ValueError(
            f"the folded sampler needs {SAMPLER_MIN_QUBITS} <= n_qubits <= {SAMPLER_MAX_QUBITS}"
        )
    pop, n_kron, d_slots = _check_pipeline(pipeline, n_qubits)
    dim = 1 << n_qubits
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    shots = check_uniforms(u_frac, pop)
    device = pipeline.factors.device
    out = torch.empty((pop, shots), dtype=torch.int32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    scratch = sampler_scratch(pop, n_qubits, device)
    status = cuda_lib.load().qt_sampled_shot_indices_folded(
        out.data_ptr(), work.data_ptr(), scratch.data_ptr(), u_frac.data_ptr(), ptr(initial),
        *_pipeline_ptrs(pipeline), pop, n_kron, n_qubits, d_slots, shots, stream(),
    )
    cuda_lib.check(status, "qt_sampled_shot_indices_folded")
    launch_counts["sampled_shot_indices_folded"] += 1
    return out


# ---------------------------------------------------------------------------
# grouped_shot_indices_folded
# ---------------------------------------------------------------------------


def grouped_fold_supported(n_qubits: int, device, n_meas_groups: int) -> bool:
    """True when the one-launch grouped sampler applies: the folded
    sampler's path (CUDA tensors, n <= 21) and at most
    :data:`GROUPED_MAX_GROUPS` measurement groups, as the reference's
    ``grouped_fold_supported`` (pallas_fold_kernels.py:1017); like every
    in-kernel sampler it also needs n >= 14, which its callers check."""
    return fold_supported(n_qubits, device, "sampler") and n_meas_groups <= GROUPED_MAX_GROUPS


def grouped_shot_indices_folded_plain(
    pipeline: FoldPipeline, rot_factors, rot_active, u_fracs, n_qubits: int, initial=None
):
    """Plain version of :func:`grouped_shot_indices_folded`: the plain fold
    circuit once, then per group the plain rotation kron layer and the
    hierarchical sampler (``rot_active`` is implied by the factors here)."""
    base = apply_fold_pipeline_plain(pipeline, n_qubits, initial)
    state = torch.complex(base[:, 0], base[:, 1])
    pop = state.shape[0]
    out = []
    for g, frac in enumerate(u_fracs):
        factors = rot_factors[g].expand(pop, *rot_factors[g].shape)
        rotated = _apply_factors(state, factors, n_qubits)
        out.append(hierarchical_sample_plain(rotated.real**2 + rotated.imag**2, frac))
    return tuple(out)


def grouped_shot_indices_folded(
    pipeline: FoldPipeline, rot_factors, rot_active, u_fracs, n_qubits: int, initial=None,
    rotate=None,
):
    """Sampled basis indices per QWC measurement group after each pipeline's
    circuit (from |0...0> or per-individual ``initial`` [P, 2, 2^n]): the
    circuit runs once, then group g applies its rotation kron layer
    (``rot_factors`` [G, n, 2, 2, 2], active axis groups ``rot_active``
    [G, n_axis_groups] 0/1) and samples at its uniforms ``u_fracs[g]``
    [P, S_g].  Returns a tuple of G int32 [P, S_g]; the caller gathers
    ``tables[g][indices]``.  Equal bits to :func:`sampled_shot_indices_folded`
    on ``extend_fold_pipeline_with_rotation(pipeline, ...)`` per group.

    ``rotate`` (G host booleans, None: read from ``rot_active``, which
    waits for the card) says which groups rotate at all; the others sample
    the circuit's own state."""
    u_fracs = tuple(u_fracs)
    if not on_cuda(*pipeline, rot_factors, rot_active, initial, *u_fracs):
        return grouped_shot_indices_folded_plain(
            pipeline, rot_factors, rot_active, u_fracs, n_qubits, initial
        )
    n_meas = rot_factors.shape[0]
    device = pipeline.factors.device
    if (
        n_qubits < SAMPLER_MIN_QUBITS
        or not grouped_fold_supported(n_qubits, device, n_meas)
        or len(u_fracs) != n_meas
    ):
        raise ValueError(
            f"the grouped sampler needs {SAMPLER_MIN_QUBITS} <= n_qubits <= {SAMPLER_MAX_QUBITS}, "
            f"1 <= groups <= {GROUPED_MAX_GROUPS} and one uniform array per group"
        )
    pop, n_kron, d_slots = _check_pipeline(pipeline, n_qubits)
    dim, n_groups = 1 << n_qubits, n_axis_groups(n_qubits)
    expect(rot_factors, "rot_factors", torch.float32, (n_meas, n_qubits, 2, 2, 2))
    expect(rot_active, "rot_active", torch.float32, (n_meas, n_groups))
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    shots = [check_uniforms(frac, pop) for frac in u_fracs]
    if rotate is None:
        rotate = rot_active.bool().any(dim=1).tolist()
    rotate = [bool(r) for r in rotate]
    frac = torch.cat([f.reshape(-1) for f in u_fracs])
    out = torch.empty(frac.numel(), dtype=torch.int32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    rotated = torch.empty_like(work) if any(rotate) else None
    scratch = sampler_scratch(pop, n_qubits, device)
    # the rotation layers as one-kron-layer pipelines of the population
    # ([G, P, 1, n, 2, 2, 2] and [G, P, 1, n_groups])
    factors = rot_factors[:, None, None].expand(n_meas, pop, 1, *rot_factors.shape[1:])
    factors = factors.contiguous()
    active = rot_active.to(torch.int32)[:, None, None].expand(n_meas, pop, 1, n_groups)
    active = active.contiguous()
    host_shots = (ctypes.c_int * n_meas)(*shots)
    host_rotate = (ctypes.c_int * n_meas)(*map(int, rotate))
    status = cuda_lib.load().qt_grouped_shot_indices_folded(
        out.data_ptr(), work.data_ptr(), ptr(rotated), scratch.data_ptr(), frac.data_ptr(),
        ptr(initial), *_pipeline_ptrs(pipeline), factors.data_ptr(), active.data_ptr(),
        ctypes.addressof(host_shots), ctypes.addressof(host_rotate),
        n_meas, pop, n_kron, n_qubits, d_slots, stream(),
    )
    cuda_lib.check(status, "qt_grouped_shot_indices_folded")
    launch_counts["grouped_shot_indices_folded"] += 1
    offsets = np.cumsum([0] + [pop * s for s in shots])
    return tuple(
        out[int(lo):int(hi)].view(pop, s) for lo, hi, s in zip(offsets[:-1], offsets[1:], shots)
    )


# ---------------------------------------------------------------------------
# nft_layer_sweep_folded
# ---------------------------------------------------------------------------


def fold_sweep_metadata(gate_types, controls, n_qubits: int):
    """Host-side static metadata of a swept layer ([P, n] ``gate_types`` and
    ``controls``, numpy): (diag_ctrl [P,1,D], diag_tgt [P,1,D], slot_of_q
    [P,1,n], diag_count [P,1,1], group_active [P,2,G]), int32 numpy.

    The layer's gate structure is fixed during a sweep (only angles move),
    so the CU3 compaction (``build_fold_pipeline``'s front-compaction order)
    and the two kron layers' group activity are computed once per launch.
    """
    gate_types = np.asarray(gate_types)
    controls = np.asarray(controls)
    pop, n = gate_types.shape
    if n != n_qubits:
        raise ValueError("gate_types last axis must equal n_qubits")
    d_slots = max(n_qubits // 2, 1)
    n_groups = n_axis_groups(n_qubits)
    diag_ctrl = np.full((pop, 1, d_slots), -1, np.int32)
    diag_tgt = np.full((pop, 1, d_slots), -1, np.int32)
    slot_of_q = np.full((pop, 1, n), -1, np.int32)
    diag_count = np.zeros((pop, 1, 1), np.int32)
    group_active = np.zeros((pop, 2, n_groups), np.int32)
    is_crot = gate_types == GATE_CROT
    is_gate = (gate_types == GATE_ROT) | is_crot
    for p in range(pop):
        j = 0
        for q in range(n):
            if is_crot[p, q]:
                diag_ctrl[p, 0, j] = controls[p, q]
                diag_tgt[p, 0, j] = q
                slot_of_q[p, 0, q] = j
                j += 1
        diag_count[p, 0, 0] = j
    for g, (lo, m) in enumerate(group_bounds(n_qubits)):
        # vdag kron layer: non-identity only on CU3 targets
        group_active[:, 0, g] = is_crot[:, lo:lo + m].any(axis=1)
        # main kron layer: non-identity on every gated qubit
        group_active[:, 1, g] = is_gate[:, lo:lo + m].any(axis=1)
    return diag_ctrl, diag_tgt, slot_of_q, diag_count, group_active


def _layer_controls(diag_ctrl, slot_of_q):
    """[P, n] controls of the swept layer from its metadata (-1 where a
    qubit holds no CU3)."""
    slots = slot_of_q[:, 0].long()
    controls = torch.gather(diag_ctrl[:, 0].long(), 1, slots.clamp(min=0))
    return torch.where(slots >= 0, controls, torch.full_like(controls, -1)).to(torch.int32)


def nft_layer_sweep_folded_plain(
    gate_types, angles, coords, n_free, active, prefix, table,
    diag_ctrl, diag_tgt, slot_of_q, diag_count, group_active,
    n_qubits, maxiter, reset_interval,
):
    """Plain version of :func:`nft_layer_sweep_folded`: every probe's
    energy from the swept layer's fold pipeline applied to the prefix
    states (the same step rule as the slot sweep)."""
    from queasars_tpu_torch.optim.nft_math import layer_sweep_plain

    pop = gate_types.shape[0]
    gt1 = gate_types[:, None, :]
    ctrl1 = _layer_controls(diag_ctrl, slot_of_q)[:, None, :]
    mask1 = torch.ones((pop, 1), dtype=torch.bool, device=angles.device)

    def energy(a):
        pipeline = build_fold_pipeline(gt1, ctrl1, a[:, None], mask1, n_qubits)
        return energies_exact_folded_plain(pipeline, table, n_qubits, prefix)

    return layer_sweep_plain(energy, angles, coords, n_free, active, maxiter, reset_interval)


def nft_layer_sweep_folded(
    gate_types, angles, coords, n_free, active, prefix, table,
    diag_ctrl, diag_tgt, slot_of_q, diag_count, group_active,
    n_qubits, maxiter, reset_interval,
):
    """The whole last-layer NFT sweep of every individual with rest-base
    folded probes, from its cached prefix state: returns (layer angles
    [P, n, 3], final energies [P]).

    :param gate_types: [P, n] int32 the swept layer's slots
    :param angles: [P, n, 3] the layer's start angles
    :param coords: [P, K, 2] int32 (qubit, angle) per free coordinate
    :param n_free: [P] int32 valid coordinates; ``active`` [P] bool
    :param prefix: [P, 2, 2^n] states after the frozen prefix layers
    :param table: [2^n] diagonal energy table
    :param diag_ctrl: ... ``group_active``: :func:`fold_sweep_metadata`'s
        arrays as int32 tensors on the same device

    On the card the fold engine builds each individual's BASE (REST applied
    to the prefix) on the first step and every ``reset_interval`` steps;
    between rebuilds the slot sweep's fused pass updates it and its nine
    pair sums when the probed qubit changes (``csrc/sweep.cuh``).  The steps
    that need that pass are read from the free coordinates first
    (``slot_kernels.sweep_transitions``, one wait); then the step loop only
    enqueues launches.
    """
    meta = (diag_ctrl, diag_tgt, slot_of_q, diag_count, group_active)
    tensors = (gate_types, angles, coords, n_free, active, prefix, table) + meta
    if not on_cuda(*tensors):
        return nft_layer_sweep_folded_plain(
            gate_types, angles, coords, n_free, active, prefix, table, *meta,
            n_qubits, maxiter, reset_interval,
        )
    if not LANE_BITS <= n_qubits <= _CAPS["sweep"]:
        raise ValueError(f"the folded sweep needs 7 <= n_qubits <= {_CAPS['sweep']}")
    pop, dim = gate_types.shape[0], 1 << n_qubits
    k_max, d_slots = coords.shape[1], diag_ctrl.shape[2]
    n_groups = n_axis_groups(n_qubits)
    expect(gate_types, "gate_types", torch.int32, (pop, n_qubits))
    expect(angles, "angles", torch.float32, (pop, n_qubits, 3))
    expect(coords, "coords", torch.int32, (pop, k_max, 2))
    expect(n_free, "n_free", torch.int32, (pop,))
    expect(active, "active", torch.bool, (pop,))
    expect(prefix, "prefix", torch.float32, (pop, 2, dim))
    expect(table, "table", torch.float32, (dim,))
    expect(diag_ctrl, "diag_ctrl", torch.int32, (pop, 1, d_slots))
    expect(diag_tgt, "diag_tgt", torch.int32, (pop, 1, d_slots))
    expect(slot_of_q, "slot_of_q", torch.int32, (pop, 1, n_qubits))
    expect(diag_count, "diag_count", torch.int32, (pop, 1, 1))
    expect(group_active, "group_active", torch.int32, (pop, 2, n_groups))
    if k_max < 1 or maxiter < 0 or reset_interval < 1:
        raise ValueError("need k_max >= 1, maxiter >= 0 and reset_interval >= 1")
    kernels = cuda_lib.load()
    device = angles.device

    def scratch(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    out_angles = torch.empty_like(angles)
    z = scratch(pop)
    # factors [P, 2, n, 8], phases [P, 1, D, 4], probed qubit [P], layer
    # controls [P, n], BASE planes, pair-sum partials, pair sums [P, 9];
    # held here until the call has enqueued everything
    work = [
        scratch(pop, 2, n_qubits, 8), scratch(pop, 1, d_slots, 4),
        scratch(pop, dtype=torch.int32), scratch(pop, n_qubits, dtype=torch.int32),
        scratch(pop, 2, dim), scratch(pop, 9, kernels.qt_sweep_partials(n_qubits)),
        scratch(pop, 9),
    ]
    # the wait comes last, so the checks and allocations overlap earlier work
    transitions = sweep_transitions(coords, n_free, active, n_qubits, maxiter)
    status = kernels.qt_fold_nft_sweep(
        out_angles.data_ptr(), z.data_ptr(), *(t.data_ptr() for t in work),
        transitions.ctypes.data, *(t.data_ptr() for t in tensors),
        pop, n_qubits, k_max, d_slots, maxiter, reset_interval, stream(),
    )
    cuda_lib.check(status, "qt_fold_nft_sweep")
    launch_counts["nft_layer_sweep_folded"] += 1
    return out_angles, z
