"""Batched Nakanishi-Fujii-Todo (NFT) optimizer (PyTorch).

Counterpart of ``queasars_tpu/optim/nft.py`` on the JAX package's production
fused route (``use_pallas=True``): the whole population takes NFT steps in
lock-step; a last-layer search simulates the frozen prefix once (states
kernel) and runs the whole sweep from it (sweep kernel); a multi-slot
parameter search re-enters every probe from its slot's cached prefix state
(energies kernel).  The probes take the kron-fold route (fold kernels) by
default and the slot route under ``QUEASARS_MXU=0``, as in the reference
(``optim/objective.py``).  On the card, steps only enqueue launches;
results reach the host once per call.  A three-point step there is its
probes' objective calls and one launch of the step kernel
(``csrc/nft_step.cu``), which fits, moves the angles and writes the next
step's probes in the PyTorch loop's bits.

Against a sampler evaluator every probe samples shots: individual p's keys
are ``split(PRNGKey(seed), P)[p]`` and its probe of step k draws with
``fold_in(fold_in(key_p, k), probe)`` (probe 0 the reset, 1 the +pi/2 and
2 the -pi/2 probe), the reference's stream.  A last-layer search then runs
the steps over the one-layer objective from the cached prefix states: the
sweep kernel takes only the exact plain expectation.

NFT math (arXiv:1903.12166, matching qiskit's ``nakanishi_fujii_todo``):
the objective is an exact sinusoid in each U3 angle, so from z0=f(x),
z1=f(x+pi/2), z3=f(x-pi/2) the minimum along that coordinate is found in
closed form (``optim/nft_math.py``).  The minimum value is recycled as the
next step's z0, which is re-measured every ``reset_interval`` steps.  Step
k updates flat parameter ``k mod n_free_i`` of each individual (qiskit
NFT's cyclic rule), through per-individual coordinate tables.

The 3-point update is exact for U3 angles and for CU3 angles against
diagonal Hamiltonians.  Against non-diagonal ones a CU3 theta picks up
4pi-periodic half-harmonics, so ``NFTConfig(five_point=True)`` fits
``c + a1 cos(theta - b1) + a2 cos(theta/2 - b2)`` from five samples over
the 4pi period (one shared 5x5 solve) and takes the minimum of the fit on
a 512-point grid: exact for every gate and operator, at 4 evaluations per
step.  Neither five-point steps nor general operators reach the sweep
kernels: their last-layer searches take the prefix-state loop, and an
exact general objective runs the full circuits (the reference gives its
general exact operands ``use_pallas=False``, which also makes
``minimize_slots`` return None).

An evaluator without objective operands (an external backend,
``sim/external.py``, or a black-box bitstring function) takes the
reference's host-stepped numpy loop (:meth:`BatchedNFT._minimize_host`),
one ``evaluate_packed`` call per probe; ``minimize_slots`` returns None for
it, so the per-slot loop calls :meth:`BatchedNFT.minimize` slot by slot.

An evaluator that owns its distribution, the amplitude-sharded one
(``sim/sharded_evaluator.py``), runs the searches itself: ``minimize`` and
``minimize_slots`` hand it the call (``nft_minimize`` / ``nft_minimize_slots``)
and take the host-stepped loop only where it returns None.

Under a population mesh (the evaluator's ``mesh``, ``parallel/mesh.py``)
both searches run block by block on the mesh's devices, as the reference's
dispatch sites do (``minimize``'s full-circuit steps, for the prefix cache
is off under a mesh, and ``minimize_slots``' slot loop); the keys are split
for the whole population first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from math import ceil
from typing import Optional

import numpy as np
import torch

from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.optim.nft_math import nft_three_point_update
from queasars_tpu_torch.optim.objective import objective_operands, population_energies
from queasars_tpu_torch.optim.prefix import (
    build_prefix_transform,
    cache_enabled,
    kernel_route,
    prefix_enabled,
    prefix_mask,
    simulate_prefix_states,
)
from queasars_tpu_torch.optim.sweep_kernel_launch import nft_layer_sweep_launch
from queasars_tpu_torch.parallel.mesh import operand_device, run_batched
from queasars_tpu_torch.sim import slot_kernels
from queasars_tpu_torch.sim.evaluators import expand_initial, packed_tensors
from queasars_tpu_torch.utils import prng
from queasars_tpu_torch.utils.batch_invariant import combine
from queasars_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class NFTConfig:
    """NFT hyperparameters (qiskit NFT-compatible knobs).

    :param maxiter: parameter-update steps (each costs 2 evaluations, or 4
        with ``five_point``, plus 1 extra on reset steps)
    :param reset_interval: re-measure the recycled z0 every this many steps
    :param five_point: the exact two-frequency fit (see the module
        docstring) instead of the 3-point sinusoid
    :param cache_prefix: a last-layer search simulates the frozen prefix
        layers once and re-enters every probe from the cached state
        (mathematically identical to full-circuit probes; float rounding
        may differ at the ulp level), and a multi-slot search runs fused
        (:meth:`BatchedNFT.minimize_slots`).  None (default) enables it on
        the kernel route, i.e. for every objective but a general
        operator's exact one (``optim/prefix.py``); True/False forces it.
    :param in_kernel_sweep: with the prefix cache on, run the plain exact
        expectation's last-layer search as one sweep-kernel call instead
        of the prefix-state probe loop.  None (default) = on wherever it
        applies; False forces the loop; True also takes it off the kernel
        route.
    """

    maxiter: int = 40
    reset_interval: int = 32
    five_point: bool = False
    cache_prefix: Optional[bool] = None
    in_kernel_sweep: Optional[bool] = None

    def n_circuit_evaluations(self) -> int:
        """Evaluations used per optimized individual (ledger input for the
        budget enforcement, reference: mutation.py:282-290)."""
        per_step = 4 if self.five_point else 2
        return per_step * self.maxiter + ceil(self.maxiter / self.reset_interval)


#: the five-point fit's sample shifts over the 4pi period (shift 0 is z0)
FIVE_POINT_DELTAS = (4 * math.pi / 5, 8 * math.pi / 5, 12 * math.pi / 5, 16 * math.pi / 5)
FIVE_POINT_GRID = 512


def _five_point_inverse() -> np.ndarray:
    """Inverse of the shared 5x5 basis matrix of the two-frequency fit, in
    float64 and cast to float32 (the reference's ``_five_point_inverse``):
    basis {1, cos d, sin d, cos d/2, sin d/2} at d in {0, 4pi/5, ...,
    16pi/5}."""
    deltas = np.array([0.0, *FIVE_POINT_DELTAS])
    basis = np.stack(
        [np.ones_like(deltas), np.cos(deltas), np.sin(deltas), np.cos(deltas / 2),
         np.sin(deltas / 2)],
        axis=1,
    )
    return np.linalg.inv(basis).astype(np.float32)


def five_point_grid() -> torch.Tensor:
    """The fit's 512 float32 shifts over [0, 4pi): ``float32(4pi) * k / 512``,
    the values of ``jnp.linspace(0, 4pi, 512, endpoint=False)``."""
    step = torch.arange(FIVE_POINT_GRID, dtype=torch.float32) / FIVE_POINT_GRID
    return torch.tensor(4 * math.pi, dtype=torch.float32) * step


@lru_cache(maxsize=None)
def _five_point_constants(device: torch.device):
    """(the fit's inverse [5, 5], the grid [G], the basis at the grid
    [4, G]: cos, sin, cos/2, sin/2) on ``device``, built once per device."""
    grid = five_point_grid()
    basis = torch.stack([torch.cos(grid), torch.sin(grid), torch.cos(grid / 2), torch.sin(grid / 2)])
    inverse = torch.as_tensor(_five_point_inverse())
    return inverse.to(device), grid.to(device), basis.to(device)


def _five_point_update(objective, angles, rows, layer, q, a, theta, z0, pop_keys, k):
    """One five-point step's probes, fit and grid minimum: (the coordinate's
    new values [P], the fit's minimum values [P])."""
    samples = [z0]
    for probe, delta in enumerate(FIVE_POINT_DELTAS, start=1):
        shifted = angles.clone()
        shifted[rows, layer, q, a] = theta + delta
        samples.append(objective(shifted, _probe_keys(pop_keys, k, probe)))
    inverse, grid, basis = _five_point_constants(angles.device)
    coeffs = combine(inverse, samples)  # [5, P]
    fitted = (
        coeffs[0][:, None]
        + coeffs[1][:, None] * basis[0][None, :]
        + coeffs[2][:, None] * basis[1][None, :]
        + coeffs[3][:, None] * basis[2][None, :]
        + coeffs[4][:, None] * basis[3][None, :]
    )  # [P, grid]
    best = torch.argmin(fitted, dim=1)
    return theta + grid[best], fitted.gather(1, best[:, None])[:, 0]


def _probe_keys(pop_keys, k: int, probe: int):
    """The keys [P, 2] of probe ``probe`` at step ``k`` (None without
    per-individual keys)."""
    if pop_keys is None:
        return None
    return prng.fold_in(prng.fold_in(pop_keys, k), probe)


def _nft_steps(
    objective, angles, coords, n_free, active, maxiter, reset_interval, pop_keys=None,
    five_point=False,
):
    """``maxiter`` lock-step NFT updates of device ``angles`` [P, L, n, 3]
    over ``coords`` [P, K, 3] (layer, qubit, angle); ``objective(angles,
    keys)`` gets each probe's keys from ``pop_keys`` [P, 2] (None: exact
    objectives); ``five_point`` takes the two-frequency step.  Returns
    (angles, z0).  Three-point steps on the card take one ``qt_nft_step``
    launch a step (:func:`_nft_steps_on_card`), elsewhere the PyTorch loop
    (:func:`_nft_steps_torch`); both give the same bits."""
    if angles.device.type == "cuda" and not five_point and maxiter > 0:
        return _nft_steps_on_card(
            objective, angles, coords, n_free, active, maxiter, reset_interval, pop_keys
        )
    return _nft_steps_torch(
        objective, angles, coords, n_free, active, maxiter, reset_interval, pop_keys, five_point
    )


def _nft_steps_on_card(
    objective, angles, coords, n_free, active, maxiter, reset_interval, pop_keys=None
):
    """:func:`_nft_steps`' three-point steps on the card: per step the
    probes' objective calls and one launch that fits, moves the angles and
    z0 and writes the next step's probes (``slot_kernels.NFTSteps``), one
    more launch before the first step."""
    steps = slot_kernels.NFTSteps(angles, coords, n_free, active)
    z0 = None
    for k in range(maxiter):
        with span("nft.step"):
            if k % reset_interval == 0:
                z0 = objective(steps.angles, _probe_keys(pop_keys, k, 0))
            z1 = objective(steps.plus, _probe_keys(pop_keys, k, 1))
            z3 = objective(steps.minus, _probe_keys(pop_keys, k, 2))
            z0 = steps.step(k, z0, z1, z3, probe_next=k + 1 < maxiter)
    return steps.angles, z0


def _nft_steps_torch(
    objective, angles, coords, n_free, active, maxiter, reset_interval, pop_keys=None,
    five_point=False,
):
    """:func:`_nft_steps` as PyTorch operations, on any device: the CPU's
    path, the five-point step's, and the card kernel's plain version."""
    pop = angles.shape[0]
    rows = torch.arange(pop, device=angles.device)
    apply = active & (n_free > 0)
    z0 = torch.zeros(pop, dtype=torch.float32, device=angles.device)
    for k in range(maxiter):
        with span("nft.step"):
            if k % reset_interval == 0:
                z0 = objective(angles, _probe_keys(pop_keys, k, 0))
            idx = torch.remainder(torch.full_like(n_free, k), n_free.clamp(min=1)).long()
            layer, q, a = coords[rows, idx].unbind(-1)
            theta = angles[rows, layer, q, a]
            if five_point:
                new_theta, minimum_value = _five_point_update(
                    objective, angles, rows, layer, q, a, theta, z0, pop_keys, k
                )
            else:
                plus = angles.clone()
                plus[rows, layer, q, a] = theta + math.pi / 2
                minus = angles.clone()
                minus[rows, layer, q, a] = theta - math.pi / 2
                shift, minimum_value = nft_three_point_update(
                    z0, objective(plus, _probe_keys(pop_keys, k, 1)),
                    objective(minus, _probe_keys(pop_keys, k, 2)),
                )
                new_theta = theta + (shift + math.pi)
            updated = angles.clone()
            updated[rows, layer, q, a] = new_theta
            angles = torch.where(apply[:, None, None, None], updated, angles)
            z0 = torch.where(apply, minimum_value, z0)
    return angles, z0


def _to_host(name: str, angles: torch.Tensor, energies: torch.Tensor):
    """(angles, energies) as numpy; the host waits for the card inside span
    ``name``."""
    with span(name):
        return angles.cpu().numpy(), energies.cpu().numpy()


class BatchedNFT:
    """Population-lock-step NFT against an expectation evaluator."""

    def __init__(self, config: NFTConfig = NFTConfig()):
        self.config = config

    def publishes_exact_energies(self, evaluator) -> bool:
        """True when the returned energies are the exact evaluator energies
        at the final angles (the 3-point model on the plain exact
        expectation of a diagonal operator is exact there; a five-point
        grid minimum or a general operator's fit is not), so selection may
        reuse them (PopulationEnergyCache)."""
        if self.config.five_point:
            return False
        if getattr(evaluator, "nft_minimize", None) is not None:
            # an amplitude-sharded evaluator's sweep is the same 3-point
            # math, exact on its plain diagonal energies
            return (
                evaluator.alpha >= 1.0 and evaluator.shots is None
                and evaluator.operator.is_diagonal
            )
        try:
            operands = objective_operands(evaluator)
        except TypeError:
            return False
        return not (operands["use_cvar"] or operands["use_shots"] or operands["use_general"])

    def _objective(self, operands, n_qubits, gate_types, controls, layer_mask, initial):
        return lambda angles, keys: population_energies(
            gate_types, controls, angles, layer_mask, keys=keys, n_qubits=n_qubits,
            initial_state=initial, **operands,
        )

    def minimize(
        self,
        evaluator,
        packed: PackedPopulation,
        coords: np.ndarray,
        n_free: np.ndarray,
        active: np.ndarray,
        angles: Optional[np.ndarray] = None,
        seed: int = 0,
        last_layer: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Run NFT over the selected free parameters.

        :param coords: [P, K, 3] free-parameter coordinates per individual
        :param n_free: [P] number of valid coordinates per individual
        :param active: [P] individuals taking part in this optimization
        :param angles: optional override of the packed angle tensor
        :param seed: RNG seed of the shot-sampling objective (each
            individual's key is ``split(PRNGKey(seed), P)``; unused on the
            exact path)
        :param last_layer: [P] layer indices asserting that every
            individual's free coordinates lie in that layer AND no later
            real layer exists — enables the prefix cache and the sweep
            kernel
        :return: (optimized angles [P, L, n, 3], final energies [P],
            evaluations used per active individual)
        """
        a = packed.angles if angles is None else angles
        if coords.shape[1] == 0 or not np.any(np.logical_and(active, n_free > 0)):
            return np.asarray(a), np.asarray(evaluator.evaluate_packed(packed, angles=a)), 0
        # an evaluator that owns its distribution (amplitude sharding) runs
        # the sweep itself; None: not for this configuration
        device_nft = getattr(evaluator, "nft_minimize", None)
        if device_nft is not None:
            result = device_nft(packed, coords, n_free, active, a, self.config, seed,
                                last_layer=last_layer)
            if result is not None:
                return (*result, self.config.n_circuit_evaluations())
        try:
            operands = objective_operands(evaluator)
        except TypeError:
            # evaluators with host-side objectives (external backends,
            # black-box bitstring functions) have no operands for the
            # device steps: run the same NFT math host-stepped against
            # evaluate_packed
            return self._minimize_host(evaluator, packed, coords, n_free, active, a)
        mesh = getattr(evaluator, "mesh", None)
        device = evaluator.device
        n = packed.n_qubits
        pop = packed.n_individuals
        where = operand_device(mesh, device)
        gt, ctrl, ang, lm = packed_tensors(packed, a, where)
        coords_t = torch.as_tensor(coords, dtype=torch.long, device=where)
        n_free_t = torch.as_tensor(n_free, dtype=torch.int32, device=where)
        active_t = torch.as_tensor(active, dtype=torch.bool, device=where)
        pop_keys = prng.split(prng.PRNGKey(seed), pop) if operands["use_shots"] else None
        cfg = self.config

        if not prefix_enabled(cfg.cache_prefix, operands, mesh, last_layer):
            def steps(pa, ra):
                gt, ctrl, ang, lm, crd, nf, act, keys = pa
                shared, ops = ra
                objective = self._objective(
                    ops, n, gt, ctrl, lm, expand_initial(shared, gt.shape[0])
                )
                return _nft_steps(
                    objective, ang, crd, nf, act, cfg.maxiter, cfg.reset_interval, keys,
                    cfg.five_point,
                )

            out, energies = run_batched(
                mesh, steps, (gt, ctrl, ang, lm, coords_t, n_free_t, active_t, pop_keys),
                (evaluator._initial, operands),
            )
            return (*_to_host("wait.nft_minimize", out, energies), cfg.n_circuit_evaluations())
        initial = evaluator.initial_states(pop)
        if self._in_kernel_sweep_applies(operands):
            rows = torch.arange(pop, device=device)
            ll = torch.as_tensor(last_layer, dtype=torch.long, device=device)
            out = ang.clone()
            out[rows, ll], energies = nft_layer_sweep_launch(
                gt, ctrl, ang, lm, ll,
                coords_t[:, :, 1:3].to(torch.int32).contiguous(), n_free_t, active_t,
                operands["table"], n_qubits=n, maxiter=cfg.maxiter,
                reset_interval=cfg.reset_interval, initial_state=initial,
            )
        else:
            transform = build_prefix_transform(gt, ctrl, ang, lm, coords_t, last_layer, n, initial)
            objective = self._objective(
                operands, n, transform.gate_types, transform.controls, transform.layer_mask,
                transform.initial_state,
            )
            layer_angles, energies = _nft_steps(
                objective, transform.angles, transform.coords, n_free_t, active_t, cfg.maxiter,
                cfg.reset_interval, pop_keys, cfg.five_point,
            )
            out = transform.merge(layer_angles)
        return (*_to_host("wait.nft_minimize", out, energies), cfg.n_circuit_evaluations())

    def _minimize_host(self, evaluator, packed, coords, n_free, active, angles):
        """Host-stepped NFT for evaluators without objective operands: the
        reference's numpy float64 loop (``_minimize_host``), one
        ``evaluate_packed`` call per probe, the same operations in the same
        order."""
        cfg = self.config
        pop = packed.n_individuals
        pop_idx = np.arange(pop)
        current = np.array(angles, copy=True)
        z0 = np.zeros(pop, dtype=np.float64)
        apply = np.logical_and(np.asarray(active, bool), np.asarray(n_free) > 0)
        for k in range(cfg.maxiter):
            if k % cfg.reset_interval == 0:
                z0 = np.asarray(evaluator.evaluate_packed(packed, angles=current), dtype=np.float64)
            idx = np.where(n_free > 0, k % np.maximum(n_free, 1), 0)
            coord = coords[pop_idx, idx]
            l, q, a_i = coord[:, 0], coord[:, 1], coord[:, 2]
            plus = current.copy()
            plus[pop_idx, l, q, a_i] += np.pi / 2
            minus = current.copy()
            minus[pop_idx, l, q, a_i] -= np.pi / 2
            z1 = np.asarray(evaluator.evaluate_packed(packed, angles=plus), dtype=np.float64)
            z3 = np.asarray(evaluator.evaluate_packed(packed, angles=minus), dtype=np.float64)
            shift, minimum_value = nft_three_point_update(z0, z1, z3, xp=np)
            updated = current.copy()
            updated[pop_idx, l, q, a_i] += shift + np.pi
            current = np.where(apply[:, None, None, None], updated, current)
            z0 = np.where(apply, minimum_value, z0)
        return current, z0.astype(np.float32), cfg.n_circuit_evaluations()

    def _in_kernel_sweep_applies(self, operands) -> bool:
        """Resolve the ``in_kernel_sweep`` knob as the reference does
        (``_in_kernel_sweep_applies``): the sweep kernel takes the plain
        exact expectation of a diagonal operator with three-point steps;
        None takes it on the kernel route, True off it too.  Unlike the
        reference's, the port's sweep kernels take a shared start state and
        have no size cap."""
        flag = self.config.in_kernel_sweep
        if flag is False or (flag is None and not kernel_route(operands)):
            return False
        return not (
            operands["use_shots"] or operands["use_cvar"] or operands["use_general"]
            or self.config.five_point
        )

    def minimize_slots(
        self,
        evaluator,
        packed: PackedPopulation,
        coords: np.ndarray,
        n_free: np.ndarray,
        active: np.ndarray,
        slot_layers: np.ndarray,
        angles: Optional[np.ndarray] = None,
        seeds: Optional[np.ndarray] = None,
    ) -> Optional[tuple[np.ndarray, np.ndarray, int]]:
        """A whole multi-slot parameter search (EVQEParameterSearch: one
        layer per individual per slot, slots in sequence), each slot's
        probes re-entering from that slot's cached prefix state.

        Slot arrays are [P, S, ...]: ``coords`` [P, S, K, 3],
        ``n_free``/``active``/``slot_layers`` [P, S]; an individual sitting
        a slot out carries ``packed.max_layers``.  ``seeds`` [S] seed the
        shot-sampling objective, slot s with ``split(PRNGKey(seeds[s]),
        P)`` (unused on the exact path; None = zeros).  Returns None for an
        unsupported evaluator and where the ``cache_prefix`` knob resolves
        off (by default a general operator's exact objective), as the
        reference does: the caller then runs the per-slot loop.

        :return: (optimized angles, last-slot energies, evaluations used
            per active individual per slot)
        """
        device_slots = getattr(evaluator, "nft_minimize_slots", None)
        if device_slots is not None:
            seed0 = int(seeds[0]) if seeds is not None and len(seeds) else 0
            result = device_slots(
                packed, coords, n_free, active, slot_layers,
                np.asarray(packed.angles if angles is None else angles), self.config, seed0,
            )
            if result is None:
                return None
            return (*result, self.config.n_circuit_evaluations())
        try:
            operands = objective_operands(evaluator)
        except TypeError:
            return None
        if not cache_enabled(self.config.cache_prefix, operands):
            return None
        mesh = getattr(evaluator, "mesh", None)
        where = operand_device(mesh, evaluator.device)
        n = packed.n_qubits
        pop = packed.n_individuals
        n_slots = n_free.shape[1]
        seeds = np.zeros(n_slots, np.int64) if seeds is None else np.asarray(seeds)
        keys = None
        if operands["use_shots"]:
            keys = torch.stack([prng.split(prng.PRNGKey(int(s)), pop) for s in seeds], dim=1)
        cfg = self.config

        def search(pa, ra):
            gt, ctrl, ang, lm, crd, nf, act, layers, keys = pa
            shared, ops = ra
            initial = expand_initial(shared, gt.shape[0])
            z0 = torch.zeros(gt.shape[0], dtype=torch.float32, device=ang.device)
            for s in range(n_slots):
                prefix = simulate_prefix_states(
                    gt, ctrl, ang, prefix_mask(lm, layers[:, s]), n, initial
                )
                suffix = lm & ~prefix_mask(torch.ones_like(lm), layers[:, s])
                objective = self._objective(ops, n, gt, ctrl, suffix, prefix)
                ang, z0 = _nft_steps(
                    objective, ang, crd[:, s], nf[:, s], act[:, s], cfg.maxiter,
                    cfg.reset_interval, None if keys is None else keys[:, s], cfg.five_point,
                )
            return ang, z0

        pop_args = (
            *packed_tensors(packed, angles, where),
            torch.as_tensor(coords, dtype=torch.long, device=where),
            torch.as_tensor(n_free, dtype=torch.int32, device=where),
            torch.as_tensor(active, dtype=torch.bool, device=where),
            torch.as_tensor(slot_layers, dtype=torch.long, device=where),
            keys,
        )
        out, energies = run_batched(mesh, search, pop_args, (evaluator._initial, operands))
        return (*_to_host("wait.nft_minimize_slots", out, energies),
                cfg.n_circuit_evaluations())
