"""The slot-circuit kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``queasars_tpu/sim/pallas_kernels.py``.  Four wrappers, each
the port of one Pallas kernel, with the same tensor contract:

=============================  ===========================================
wrapper                        replaces (queasars_tpu/sim/pallas_kernels.py)
=============================  ===========================================
:func:`energies_exact`         ``pallas_energies_exact`` (:367)
:func:`population_states`      ``pallas_population_states`` (:326)
:func:`nft_layer_sweep`        ``pallas_nft_layer_sweep`` (:837)
:func:`population_probs`       ``pallas_population_probs`` (:267)
=============================  ===========================================

The kernels live in ``queasars_tpu_torch/csrc/slot_kernels.cu``; its header
says how each one is laid out on the H100.  What bounds them: every active
gate slot streams the population's state planes through device memory once
(32 bytes per amplitude pair: 16 read, 16 written), so the gate passes are
bound by bytes at 3.35 TB/s, not by the few FLOPs per pair; the energy and
probability passes read (and write) each plane once more.  The TPU kernels
avoid that traffic by keeping a state in VMEM; an SM's 227 KB cannot hold
an 8 MB state, so the first design here streams each slot through L2/HBM
and leaves tiling of low-qubit slot runs in shared memory for later work.

Each wrapper takes its plain version (``*_plain``, beside it here) only
because the tensors it was given lie on the CPU.  On CUDA tensors it
launches the kernel or raises; it never falls back.  ``launch_counts``
counts kernel launches (one per wrapper call that launched), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.sim.statevector import probabilities, simulate_circuits

launch_counts: dict[str, int] = {
    "energies_exact": 0,
    "population_states": 0,
    "nft_layer_sweep": 0,
    "population_probs": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# argument checks shared by the CUDA paths
# ---------------------------------------------------------------------------


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the card, False when every one lies on
    the CPU; anything else (mixed or another device) is refused."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors must all lie on one CUDA device or all on the CPU: {devices}")
    return True


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_genome(gate_types, controls, angles, layer_mask, n_qubits):
    pop, n_layers = gate_types.shape[0], gate_types.shape[1]
    _expect(gate_types, "gate_types", torch.int32, (pop, n_layers, n_qubits))
    _expect(controls, "controls", torch.int32, (pop, n_layers, n_qubits))
    _expect(angles, "angles", torch.float32, (pop, n_layers, n_qubits, 3))
    _expect(layer_mask, "layer_mask", torch.bool, (pop, n_layers))
    return pop, n_layers


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _library():
    from queasars_tpu_torch.utils import cuda_lib

    return cuda_lib


# ---------------------------------------------------------------------------
# population_states
# ---------------------------------------------------------------------------


def population_states_plain(gate_types, controls, angles, layer_mask, n_qubits, initial=None):
    """Plain version of :func:`population_states`."""
    return simulate_circuits(gate_types, controls, angles, layer_mask, n_qubits, initial)


def population_states(gate_types, controls, angles, layer_mask, n_qubits, initial=None):
    """Statevector planes [P, 2, 2^n] after each genome's circuit, from
    |0...0> or from per-individual ``initial`` [P, 2, 2^n] states."""
    tensors = (gate_types, controls, angles, layer_mask) + (() if initial is None else (initial,))
    if not _on_cuda(*tensors):
        return population_states_plain(gate_types, controls, angles, layer_mask, n_qubits, initial)
    pop, n_layers = _check_genome(gate_types, controls, angles, layer_mask, n_qubits)
    if initial is not None:
        _expect(initial, "initial", torch.float32, (pop, 2, 1 << n_qubits))
    out = torch.empty((pop, 2, 1 << n_qubits), dtype=torch.float32, device=angles.device)
    lib = _library()
    status = lib.load().qt_population_states(
        out.data_ptr(), _ptr(initial), gate_types.data_ptr(), controls.data_ptr(),
        angles.data_ptr(), layer_mask.data_ptr(), pop, n_layers, n_qubits, _stream(),
    )
    lib.check(status, "qt_population_states")
    launch_counts["population_states"] += 1
    return out


# ---------------------------------------------------------------------------
# energies_exact
# ---------------------------------------------------------------------------


def energies_exact_plain(gate_types, controls, angles, layer_mask, table, n_qubits, initial=None):
    """Plain version of :func:`energies_exact`."""
    probs = probabilities(gate_types, controls, angles, layer_mask, n_qubits, initial)
    return (probs * table).sum(dim=-1)


def energies_exact(gate_types, controls, angles, layer_mask, table, n_qubits, initial=None):
    """Exact diagonal energies [P]: sum_i |psi_i|^2 * table[i] after each
    genome's circuit (from |0...0> or per-individual ``initial``).  The
    reduction is deterministic: equal inputs give equal bits."""
    tensors = (gate_types, controls, angles, layer_mask, table)
    tensors += () if initial is None else (initial,)
    if not _on_cuda(*tensors):
        return energies_exact_plain(
            gate_types, controls, angles, layer_mask, table, n_qubits, initial
        )
    pop, n_layers = _check_genome(gate_types, controls, angles, layer_mask, n_qubits)
    dim = 1 << n_qubits
    _expect(table, "table", torch.float32, (dim,))
    if initial is not None:
        _expect(initial, "initial", torch.float32, (pop, 2, dim))
    lib = _library()
    kernels = lib.load()
    device = angles.device
    out = torch.empty(pop, dtype=torch.float32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    partial = torch.empty(
        (pop, kernels.qt_energy_partials(n_qubits)), dtype=torch.float32, device=device
    )
    status = kernels.qt_energies_exact(
        out.data_ptr(), work.data_ptr(), partial.data_ptr(), _ptr(initial),
        gate_types.data_ptr(), controls.data_ptr(), angles.data_ptr(), layer_mask.data_ptr(),
        table.data_ptr(), pop, n_layers, n_qubits, _stream(),
    )
    lib.check(status, "qt_energies_exact")
    launch_counts["energies_exact"] += 1
    return out


# ---------------------------------------------------------------------------
# population_probs
# ---------------------------------------------------------------------------


def population_probs_plain(gate_types, controls, angles, layer_mask, n_qubits, initial=None):
    """Plain version of :func:`population_probs`."""
    return probabilities(gate_types, controls, angles, layer_mask, n_qubits, initial)


def population_probs(gate_types, controls, angles, layer_mask, n_qubits, initial=None):
    """Measurement probabilities [P, 2^n] after each genome's circuit."""
    tensors = (gate_types, controls, angles, layer_mask) + (() if initial is None else (initial,))
    if not _on_cuda(*tensors):
        return population_probs_plain(gate_types, controls, angles, layer_mask, n_qubits, initial)
    pop, n_layers = _check_genome(gate_types, controls, angles, layer_mask, n_qubits)
    dim = 1 << n_qubits
    if initial is not None:
        _expect(initial, "initial", torch.float32, (pop, 2, dim))
    device = angles.device
    probs = torch.empty((pop, dim), dtype=torch.float32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    lib = _library()
    status = lib.load().qt_population_probs(
        probs.data_ptr(), work.data_ptr(), _ptr(initial), gate_types.data_ptr(),
        controls.data_ptr(), angles.data_ptr(), layer_mask.data_ptr(),
        pop, n_layers, n_qubits, _stream(),
    )
    lib.check(status, "qt_population_probs")
    launch_counts["population_probs"] += 1
    return probs


# ---------------------------------------------------------------------------
# nft_layer_sweep
# ---------------------------------------------------------------------------


def nft_layer_sweep_plain(
    gate_types, controls, angles, coords, n_free, active, prefix, table,
    n_qubits, maxiter, reset_interval,
):
    """Plain version of :func:`nft_layer_sweep` (same step rule: probes at
    +-pi/2, 3-point sinusoid update, z0 re-measured every
    ``reset_interval`` steps)."""
    from queasars_tpu_torch.optim.nft_math import layer_sweep_plain

    pop = gate_types.shape[0]
    gt1, ctrl1 = gate_types[:, None, :], controls[:, None, :]
    mask1 = torch.ones((pop, 1), dtype=torch.bool, device=angles.device)

    def energy(a):
        return energies_exact_plain(gt1, ctrl1, a[:, None], mask1, table, n_qubits, prefix)

    return layer_sweep_plain(energy, angles, coords, n_free, active, maxiter, reset_interval)


def nft_layer_sweep(
    gate_types, controls, angles, coords, n_free, active, prefix, table,
    n_qubits, maxiter, reset_interval,
):
    """The whole last-layer NFT sweep of every individual, from its cached
    prefix state: returns (layer angles [P, n, 3], final energies [P]).

    :param gate_types: [P, n] int32 the swept layer's slots (``controls``
        likewise)
    :param angles: [P, n, 3] the layer's start angles
    :param coords: [P, K, 2] int32 (qubit, angle) per free coordinate
    :param n_free: [P] int32 valid coordinates; ``active`` [P] bool
    :param prefix: [P, 2, 2^n] states after the frozen prefix layers
    :param table: [2^n] diagonal energy table

    On the card the step loop only enqueues launches: nothing synchronises
    until the caller reads the results.
    """
    tensors = (gate_types, controls, angles, coords, n_free, active, prefix, table)
    if not _on_cuda(*tensors):
        return nft_layer_sweep_plain(
            gate_types, controls, angles, coords, n_free, active, prefix, table,
            n_qubits, maxiter, reset_interval,
        )
    pop, dim = gate_types.shape[0], 1 << n_qubits
    k_max = coords.shape[1]
    _expect(gate_types, "gate_types", torch.int32, (pop, n_qubits))
    _expect(controls, "controls", torch.int32, (pop, n_qubits))
    _expect(angles, "angles", torch.float32, (pop, n_qubits, 3))
    _expect(coords, "coords", torch.int32, (pop, k_max, 2))
    _expect(n_free, "n_free", torch.int32, (pop,))
    _expect(active, "active", torch.bool, (pop,))
    _expect(prefix, "prefix", torch.float32, (pop, 2, dim))
    _expect(table, "table", torch.float32, (dim,))
    if k_max < 1 or maxiter < 0 or reset_interval < 1:
        raise ValueError("need k_max >= 1, maxiter >= 0 and reset_interval >= 1")
    lib = _library()
    kernels = lib.load()
    device = angles.device
    out_angles = torch.empty_like(angles)
    z = torch.empty(pop, dtype=torch.float32, device=device)
    probe = torch.empty((2 * pop, n_qubits, 3), dtype=torch.float32, device=device)
    work = torch.empty((2 * pop, 2, dim), dtype=torch.float32, device=device)
    partial = torch.empty(
        (2 * pop, kernels.qt_energy_partials(n_qubits)), dtype=torch.float32, device=device
    )
    z13 = torch.empty(2 * pop, dtype=torch.float32, device=device)
    status = kernels.qt_nft_layer_sweep(
        out_angles.data_ptr(), z.data_ptr(), probe.data_ptr(), work.data_ptr(),
        partial.data_ptr(), z13.data_ptr(), gate_types.data_ptr(), controls.data_ptr(),
        angles.data_ptr(), coords.data_ptr(), n_free.data_ptr(), active.data_ptr(),
        prefix.data_ptr(), table.data_ptr(), pop, n_qubits, k_max, maxiter, reset_interval,
        _stream(),
    )
    lib.check(status, "qt_nft_layer_sweep")
    launch_counts["nft_layer_sweep"] += 1
    return out_angles, z
