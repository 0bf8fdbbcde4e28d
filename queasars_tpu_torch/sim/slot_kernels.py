"""The slot-circuit kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``queasars_tpu/sim/pallas_kernels.py``.  Five wrappers, each
the port of one Pallas kernel, with the same tensor contract:

=============================  ===========================================
wrapper                        replaces (queasars_tpu/sim/pallas_kernels.py)
=============================  ===========================================
:func:`energies_exact`         ``pallas_energies_exact`` (:367)
:func:`population_states`      ``pallas_population_states`` (:326)
:func:`nft_layer_sweep`        ``pallas_nft_layer_sweep`` (:837)
:func:`population_probs`       ``pallas_population_probs`` (:267)
:func:`sampled_shot_indices`   ``pallas_sampled_shot_energies`` (:660), up
                               to its energy gather
=============================  ===========================================

:func:`sample_planes` runs the sampled kernels' shared epilogue alone
(``csrc/sampler.cuh``), on given state planes.  :class:`NFTSteps` is a
port-only kernel with no Pallas counterpart: the three-point NFT step's
bookkeeping around the probes (``csrc/nft_step.cu``), one launch a step of
``optim/nft.py::_nft_steps`` on the card.

The kernels live in ``queasars_tpu_torch/csrc/slot_kernels.cu``; its header
says how each one is laid out on the H100.  One circuit engine runs under
all five: each layer's slots are applied in two passes over 2^13-amplitude
shared-memory tiles (the slots on qubits 0-12, then those on 13..n-1; one
launch for the whole circuit at n <= 13), so a layer streams the planes
through device memory twice however many of its slots are active.  That
traffic (16 MB per pass and individual at n=20) and the 28 separately
rounded operations per amplitude pair and active slot bound it about
equally.  The energy and probability passes read (and write) each plane
once more; the sampled kernel runs the same circuit, then a hierarchical
inverse CDF that reads the planes once more (bytes-bound as well).  The NFT
sweep keeps one BASE state per individual (the swept layer without the
probed qubit's gate, applied to the prefix): the engine builds it on the
first step and every ``reset_interval`` steps, and between those one fused
pass per change of probed qubit redoes and undoes a gate in place and writes
the nine pair sums the 3-point update needs (``csrc/sweep.cuh``, shared
with the folded sweep), so a sweep streams its planes about once per
change of qubit instead of running two probe circuits per step.

Each wrapper takes its plain version (``*_plain``, beside it here) only
because the tensors it was given lie on the CPU.  On CUDA tensors it
launches the kernel or raises; it never falls back.  ``launch_counts``
counts kernel launches (one per wrapper call that launched), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.sim.sampling import hierarchical_sample_plain
from queasars_tpu_torch.sim.statevector import probabilities, simulate_circuits
from queasars_tpu_torch.utils import cuda_lib
from queasars_tpu_torch.utils.cuda_lib import expect, on_cuda, ptr, stream
from queasars_tpu_torch.utils.profiling import span

launch_counts: dict[str, int] = {
    "energies_exact": 0,
    "population_states": 0,
    "nft_layer_sweep": 0,
    "population_probs": 0,
    "sampled_shot_indices": 0,
    "sample_planes": 0,
    "nft_step": 0,
}

#: the engine's largest size (in-state indices are 32-bit)
ENGINE_MAX_QUBITS = 31
#: the in-kernel samplers' smallest size (the block hierarchy needs 128 rows
#: of 128 lanes) and the slot sampler's largest (the reference's cap; the
#: fold sampler reaches 21, ``fold_kernels.SAMPLER_MAX_QUBITS``)
SAMPLER_MIN_QUBITS = 14
SAMPLER_MAX_QUBITS = 20


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# argument checks shared by the CUDA paths
# ---------------------------------------------------------------------------


def _check_width(n_qubits: int) -> None:
    if not 1 <= n_qubits <= ENGINE_MAX_QUBITS:
        raise ValueError(f"the slot kernels need 1 <= n_qubits <= {ENGINE_MAX_QUBITS}")


def _check_genome(gate_types, controls, angles, layer_mask, n_qubits):
    _check_width(n_qubits)
    pop, n_layers = gate_types.shape[0], gate_types.shape[1]
    expect(gate_types, "gate_types", torch.int32, (pop, n_layers, n_qubits))
    expect(controls, "controls", torch.int32, (pop, n_layers, n_qubits))
    expect(angles, "angles", torch.float32, (pop, n_layers, n_qubits, 3))
    expect(layer_mask, "layer_mask", torch.bool, (pop, n_layers))
    return pop, n_layers


# ---------------------------------------------------------------------------
# population_states
# ---------------------------------------------------------------------------


def population_states_plain(gate_types, controls, angles, layer_mask, n_qubits, initial=None):
    """Plain version of :func:`population_states`."""
    return simulate_circuits(gate_types, controls, angles, layer_mask, n_qubits, initial)


def population_states(gate_types, controls, angles, layer_mask, n_qubits, initial=None):
    """Statevector planes [P, 2, 2^n] after each genome's circuit, from
    |0...0> or from per-individual ``initial`` [P, 2, 2^n] states."""
    if not on_cuda(gate_types, controls, angles, layer_mask, initial):
        return population_states_plain(gate_types, controls, angles, layer_mask, n_qubits, initial)
    pop, n_layers = _check_genome(gate_types, controls, angles, layer_mask, n_qubits)
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, 1 << n_qubits))
    out = torch.empty((pop, 2, 1 << n_qubits), dtype=torch.float32, device=angles.device)
    status = cuda_lib.load().qt_population_states(
        out.data_ptr(), ptr(initial), gate_types.data_ptr(), controls.data_ptr(),
        angles.data_ptr(), layer_mask.data_ptr(), pop, n_layers, n_qubits, stream(),
    )
    cuda_lib.check(status, "qt_population_states")
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
    if not on_cuda(gate_types, controls, angles, layer_mask, table, initial):
        return energies_exact_plain(
            gate_types, controls, angles, layer_mask, table, n_qubits, initial
        )
    pop, n_layers = _check_genome(gate_types, controls, angles, layer_mask, n_qubits)
    dim = 1 << n_qubits
    expect(table, "table", torch.float32, (dim,))
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    kernels = cuda_lib.load()
    device = angles.device
    out = torch.empty(pop, dtype=torch.float32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    partial = torch.empty(
        (pop, kernels.qt_energy_partials(n_qubits)), dtype=torch.float32, device=device
    )
    status = kernels.qt_energies_exact(
        out.data_ptr(), work.data_ptr(), partial.data_ptr(), ptr(initial),
        gate_types.data_ptr(), controls.data_ptr(), angles.data_ptr(), layer_mask.data_ptr(),
        table.data_ptr(), pop, n_layers, n_qubits, stream(),
    )
    cuda_lib.check(status, "qt_energies_exact")
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
    if not on_cuda(gate_types, controls, angles, layer_mask, initial):
        return population_probs_plain(gate_types, controls, angles, layer_mask, n_qubits, initial)
    pop, n_layers = _check_genome(gate_types, controls, angles, layer_mask, n_qubits)
    dim = 1 << n_qubits
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    device = angles.device
    probs = torch.empty((pop, dim), dtype=torch.float32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    status = cuda_lib.load().qt_population_probs(
        probs.data_ptr(), work.data_ptr(), ptr(initial), gate_types.data_ptr(),
        controls.data_ptr(), angles.data_ptr(), layer_mask.data_ptr(),
        pop, n_layers, n_qubits, stream(),
    )
    cuda_lib.check(status, "qt_population_probs")
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


def sweep_transitions(coords, n_free, active, n_qubits, maxiter):
    """The sweep kernels' host schedule: uint8 numpy [max(maxiter, 1)], 1 at
    step k >= 1 where some individual the sweep moves (``active`` and
    ``n_free > 0``) probes another qubit than at step k - 1, so its BASE
    needs a transition pass.  Copies ``coords``' qubits, ``n_free`` and
    ``active`` to the host (a wait when they lie on the card)."""
    import numpy as np

    flags = np.zeros(max(maxiter, 1), np.uint8)
    if maxiter < 2:
        return flags
    with span("wait.sweep_transitions"):
        qubits = coords.cpu().numpy()[:, :, 0].clip(0, n_qubits - 1)
        n_free, active = n_free.cpu().numpy(), active.cpu().numpy()
    idx = np.arange(maxiter)[None, :] % np.maximum(n_free, 1)[:, None]
    probed = np.take_along_axis(qubits, idx, axis=1)
    moves = (active & (n_free > 0))[:, None] & (probed[:, 1:] != probed[:, :-1])
    flags[1:] = moves.any(axis=0)
    return flags


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

    On the card the sweep keeps one BASE state per individual (the swept
    layer without the probed qubit's gate, applied to the prefix): the slot
    engine builds it on the first step and every ``reset_interval`` steps,
    and one fused pass per change of probed qubit updates it and its nine
    pair sums (``csrc/sweep.cuh``).  The steps that need that pass are read
    from the free coordinates first (:func:`sweep_transitions`, one wait);
    then the step loop only enqueues launches.
    """
    tensors = (gate_types, controls, angles, coords, n_free, active, prefix, table)
    if not on_cuda(*tensors):
        return nft_layer_sweep_plain(
            gate_types, controls, angles, coords, n_free, active, prefix, table,
            n_qubits, maxiter, reset_interval,
        )
    _check_width(n_qubits)
    pop, dim = gate_types.shape[0], 1 << n_qubits
    k_max = coords.shape[1]
    expect(gate_types, "gate_types", torch.int32, (pop, n_qubits))
    expect(controls, "controls", torch.int32, (pop, n_qubits))
    expect(angles, "angles", torch.float32, (pop, n_qubits, 3))
    expect(coords, "coords", torch.int32, (pop, k_max, 2))
    expect(n_free, "n_free", torch.int32, (pop,))
    expect(active, "active", torch.bool, (pop,))
    expect(prefix, "prefix", torch.float32, (pop, 2, dim))
    expect(table, "table", torch.float32, (dim,))
    if k_max < 1 or maxiter < 0 or reset_interval < 1:
        raise ValueError("need k_max >= 1, maxiter >= 0 and reset_interval >= 1")
    kernels = cuda_lib.load()
    device = angles.device
    out_angles = torch.empty_like(angles)
    z = torch.empty(pop, dtype=torch.float32, device=device)
    # BASE planes, pair-sum partials, pair sums, probed qubit, REST gate types
    work = [
        torch.empty((pop, 2, dim), dtype=torch.float32, device=device),
        torch.empty((pop, 9, kernels.qt_sweep_partials(n_qubits)), dtype=torch.float32,
                    device=device),
        torch.empty((pop, 9), dtype=torch.float32, device=device),
        torch.empty(pop, dtype=torch.int32, device=device),
        torch.empty((pop, n_qubits), dtype=torch.int32, device=device),
    ]
    # the wait comes last, so the checks and allocations overlap earlier work
    transitions = sweep_transitions(coords, n_free, active, n_qubits, maxiter)
    status = kernels.qt_nft_layer_sweep(
        out_angles.data_ptr(), z.data_ptr(), *(t.data_ptr() for t in work),
        transitions.ctypes.data, *(t.data_ptr() for t in tensors),
        pop, n_qubits, k_max, maxiter, reset_interval, stream(),
    )
    cuda_lib.check(status, "qt_nft_layer_sweep")
    launch_counts["nft_layer_sweep"] += 1
    return out_angles, z


# ---------------------------------------------------------------------------
# sampled_shot_indices and the sampler epilogue
# ---------------------------------------------------------------------------


def check_uniforms(u_frac: torch.Tensor, pop: int) -> int:
    if u_frac.dim() != 2 or u_frac.shape[0] != pop or u_frac.shape[1] < 1:
        raise ValueError(f"u_frac must be [{pop}, shots], got {tuple(u_frac.shape)}")
    expect(u_frac, "u_frac", torch.float32, (pop, u_frac.shape[1]))
    return u_frac.shape[1]


def sampler_scratch(pop: int, n_qubits: int, device) -> torch.Tensor:
    """The sampler epilogue's scratch for ``pop`` individuals."""
    floats = cuda_lib.load().qt_sampler_scratch(n_qubits)
    return torch.empty((pop, floats), dtype=torch.float32, device=device)


def sample_planes_plain(states, u_frac, n_qubits):
    """Plain version of :func:`sample_planes`."""
    return hierarchical_sample_plain(states[:, 0] ** 2 + states[:, 1] ** 2, u_frac)


def sample_planes(states, u_frac, n_qubits):
    """Sampled basis indices int32 [P, S] of state planes [P, 2, 2^n]
    (14 <= n <= 21) at the uniforms ``u_frac`` [P, S] in [0, 1): the
    sampled kernels' epilogue alone."""
    if not on_cuda(states, u_frac):
        return sample_planes_plain(states, u_frac, n_qubits)
    if not SAMPLER_MIN_QUBITS <= n_qubits <= 21:
        raise ValueError("the sampler epilogue needs 14 <= n_qubits <= 21")
    pop = states.shape[0]
    expect(states, "states", torch.float32, (pop, 2, 1 << n_qubits))
    shots = check_uniforms(u_frac, pop)
    out = torch.empty((pop, shots), dtype=torch.int32, device=states.device)
    scratch = sampler_scratch(pop, n_qubits, states.device)
    status = cuda_lib.load().qt_sample_planes(
        out.data_ptr(), scratch.data_ptr(), u_frac.data_ptr(), states.data_ptr(),
        pop, n_qubits, shots, stream(),
    )
    cuda_lib.check(status, "qt_sample_planes")
    launch_counts["sample_planes"] += 1
    return out


def sampled_shot_indices_plain(
    gate_types, controls, angles, layer_mask, u_frac, n_qubits, initial=None
):
    """Plain version of :func:`sampled_shot_indices`: the plain circuit's
    probabilities through the same three-level arithmetic."""
    probs = probabilities(gate_types, controls, angles, layer_mask, n_qubits, initial)
    return hierarchical_sample_plain(probs, u_frac)


def sampled_shot_indices(
    gate_types, controls, angles, layer_mask, u_frac, n_qubits, initial=None
):
    """Sampled basis indices int32 [P, S] after each genome's circuit (from
    |0...0> or per-individual ``initial``), at the uniforms ``u_frac``
    [P, S] in [0, 1): ``u = frac * total`` resolved by the hierarchical
    inverse CDF (14 <= n <= 20).  The caller gathers ``table[indices]``."""
    if not on_cuda(gate_types, controls, angles, layer_mask, u_frac, initial):
        return sampled_shot_indices_plain(
            gate_types, controls, angles, layer_mask, u_frac, n_qubits, initial
        )
    if not SAMPLER_MIN_QUBITS <= n_qubits <= SAMPLER_MAX_QUBITS:
        raise ValueError(
            f"the slot sampler needs {SAMPLER_MIN_QUBITS} <= n_qubits <= {SAMPLER_MAX_QUBITS}"
        )
    pop, n_layers = _check_genome(gate_types, controls, angles, layer_mask, n_qubits)
    dim = 1 << n_qubits
    if initial is not None:
        expect(initial, "initial", torch.float32, (pop, 2, dim))
    shots = check_uniforms(u_frac, pop)
    device = angles.device
    out = torch.empty((pop, shots), dtype=torch.int32, device=device)
    work = torch.empty((pop, 2, dim), dtype=torch.float32, device=device)
    scratch = sampler_scratch(pop, n_qubits, device)
    status = cuda_lib.load().qt_sampled_shot_indices(
        out.data_ptr(), work.data_ptr(), scratch.data_ptr(), u_frac.data_ptr(), ptr(initial),
        gate_types.data_ptr(), controls.data_ptr(), angles.data_ptr(), layer_mask.data_ptr(),
        pop, n_layers, n_qubits, shots, stream(),
    )
    cuda_lib.check(status, "qt_sampled_shot_indices")
    launch_counts["sampled_shot_indices"] += 1
    return out


# ---------------------------------------------------------------------------
# nft_step: the three-point NFT step's bookkeeping (port-only)
# ---------------------------------------------------------------------------


class NFTSteps:
    """One ``_nft_steps`` call's three-point steps on the card, one launch of
    ``qt_nft_step`` (``csrc/nft_step.cu``) a step.

    Its plain version is ``optim/nft.py::_nft_steps_torch``, the PyTorch
    loop the CPU runs, whose bits it keeps.  :attr:`angles` is a copy of the
    given angles that the steps move in place; :attr:`plus` and
    :attr:`minus` hold the current step's probes, each a copy of
    :attr:`angles` with the step's coordinate at +-pi/2; :attr:`z` is the
    recycled z0.  The constructor's launch writes the copy and step 0's
    probes; :meth:`step` takes step k's three energies, moves the angles and
    z and writes step k+1's probes.  Each launch makes the angles' card
    current and goes to that card's current stream, where the objective's
    kernels put the energies, whichever card the caller has current.
    """

    def __init__(self, angles, coords, n_free, active):
        if not on_cuda(angles, coords, n_free, active):
            raise ValueError("NFTSteps runs on the card; the CPU takes _nft_steps_torch")
        angles = angles.contiguous()
        pop, n_layers, n_qubits, _ = angles.shape
        expect(angles, "angles", torch.float32, (pop, n_layers, n_qubits, 3))
        if coords.dim() != 3 or coords.shape[0] != pop or coords.shape[2] != 3:
            raise ValueError(f"coords must be [{pop}, K, 3], got {tuple(coords.shape)}")
        self._coords = coords.to(torch.int32).contiguous()
        self._n_free = n_free.to(torch.int32).contiguous()
        self._active = active.to(torch.bool).contiguous()
        expect(self._n_free, "n_free", torch.int32, (pop,))
        expect(self._active, "active", torch.bool, (pop,))
        self.angles = torch.empty_like(angles)
        self.plus = torch.empty_like(angles)
        self.minus = torch.empty_like(angles)
        self.z = torch.empty(pop, dtype=torch.float32, device=angles.device)
        self._sizes = (pop, n_layers * n_qubits * 3, coords.shape[1], n_qubits)
        self._device = angles.device
        self._launch(angles, None, None, None, -1, 0)

    def step(self, k: int, z0, z1, z3, probe_next: bool) -> torch.Tensor:
        """Step ``k``'s update from its energies ``z0`` (the reset probe's or
        the recycled :attr:`z`), ``z1`` (the +pi/2 probe's) and ``z3``
        (the -pi/2 probe's), each [P] float32; with ``probe_next``, step
        k+1's probes.  Returns :attr:`z`."""
        z0, z1, z3 = z0.contiguous(), z1.contiguous(), z3.contiguous()
        on_cuda(self.angles, z0, z1, z3)
        for z, name in ((z0, "z0"), (z1, "z1"), (z3, "z3")):
            expect(z, name, torch.float32, (self._sizes[0],))
        self._launch(self.angles, z0, z1, z3, k, k + 1 if probe_next else -1)
        return self.z

    def _launch(self, src, z0, z1, z3, update_k, probe_k):
        with torch.cuda.device(self._device):
            status = cuda_lib.load().qt_nft_step(
                src.data_ptr(), self.angles.data_ptr(), self.plus.data_ptr(),
                self.minus.data_ptr(), self.z.data_ptr(), ptr(z0), ptr(z1), ptr(z3),
                self._coords.data_ptr(), self._n_free.data_ptr(), self._active.data_ptr(),
                *self._sizes, update_k, probe_k,
                torch.cuda.current_stream(self._device).cuda_stream,
            )
        cuda_lib.check(status, "qt_nft_step")
        launch_counts["nft_step"] += 1
