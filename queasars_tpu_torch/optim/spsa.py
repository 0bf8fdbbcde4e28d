"""Batched SPSA optimizer (PyTorch).

Counterpart of ``queasars_tpu/optim/spsa.py``: population-lock-step
simultaneous-perturbation stochastic approximation with qiskit-SPSA's
power-law schedules and calibration,

  a_k = a / (k + 1 + A)^0.602,   c_k = c / (k + 1)^0.101,

each step two batched population evaluations on the route the objective
picks (``optim/objective.py``).  The reference's ``lax.scan`` bodies are
plain loops over tensors on the evaluator's device; on the card a step only
enqueues launches.

The key stream is the reference's, bit for bit: individual p's key is
``split(PRNGKey(seed), P)[p]``; step k's direction is
``jax.random.rademacher`` of ``fold_in(fold_in(key_p, k), 0)``
(:func:`rademacher`: ``2 * (uniform < 0.5) - 1``), and its +/- probes
sample shots with probes 1 and 2; calibration pair k uses ``k + 1000``; the
final evaluation ``fold_in(key_p, 0x7FFFFFFF)``.

:meth:`BatchedSPSA.minimize` runs a last-layer search from the cached
prefix states when ``cache_prefix`` resolves on (``optim/prefix.py``); with
per-individual :class:`SPSATerminationChecker` s it steps on the host, one
step per call, and an individual whose checker stops keeps its angles.
:meth:`BatchedSPSA.minimize_slots` runs a whole multi-slot parameter search
from each slot's prefix states.  An evaluator without objective operands
(an external backend, ``sim/external.py``, or a black-box bitstring
function) takes the reference's host-stepped numpy loop
(:meth:`BatchedSPSA._minimize_host`), its directions drawn from a numpy
generator seeded with ``seed``; ``minimize_slots`` returns None for it.

Under a population mesh (the evaluator's ``mesh``, ``parallel/mesh.py``)
the calibration, the steps (one at a time with termination checkers) and
the final evaluation of :meth:`BatchedSPSA.minimize`, and the whole slot
loop of :meth:`BatchedSPSA.minimize_slots`, run block by block on the
mesh's devices (the reference's ``run_sharded`` and per-slot dispatch);
the prefix cache is off under a mesh, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.optim.objective import objective_operands, population_energies
from queasars_tpu_torch.optim.prefix import (
    build_prefix_transform,
    cache_enabled,
    prefix_enabled,
    prefix_mask,
    simulate_prefix_states,
)
from queasars_tpu_torch.optim.spsa_termination import SPSATerminationChecker
from queasars_tpu_torch.parallel.mesh import operand_device, run_batched
from queasars_tpu_torch.sim.evaluators import expand_initial, packed_tensors
from queasars_tpu_torch.utils import prng

#: the calibration pairs' offset in the step index of their keys
CALIBRATION_KEY_OFFSET = 1000
#: folded into each individual's key for the final evaluation
FINAL_KEY_DATA = 0x7FFFFFFF


@dataclass(frozen=True)
class SPSAConfig:
    """SPSA hyperparameters (qiskit-compatible defaults).

    :param maxiter: gradient steps (2 evaluations each)
    :param learning_rate: ``a``; None calibrates it per individual
    :param perturbation: ``c``
    :param calibration_steps: evaluation pairs used to calibrate ``a``
    :param alpha_power / gamma_power: schedule exponents
    :param stability_constant: ``A`` in the a_k schedule
    :param target_magnitude: the first step's calibrated size
    :param cache_prefix: layer-prefix cache of last-layer searches and the
        fused multi-slot search (as :class:`~queasars_tpu_torch.optim.nft.
        NFTConfig`'s; not with termination checkers)
    """

    maxiter: int = 100
    learning_rate: Optional[float] = None
    perturbation: float = 0.1
    calibration_steps: int = 25
    alpha_power: float = 0.602
    gamma_power: float = 0.101
    stability_constant: float = 0.0
    target_magnitude: float = 2 * np.pi / 10
    cache_prefix: Optional[bool] = None

    def n_circuit_evaluations(self) -> int:
        calibration = 2 * self.calibration_steps if self.learning_rate is None else 0
        return 2 * self.maxiter + calibration


def rademacher(keys: torch.Tensor, length: int) -> torch.Tensor:
    """float32 +/-1 directions [..., length] per key [..., 2]:
    ``jax.random.rademacher`` of jax 0.9, ``2 * bernoulli(key, 0.5) - 1``
    with ``bernoulli`` the draw ``uniform(key, (length,)) < 0.5``."""
    return (prng.uniform(keys, (length,)) < 0.5).to(torch.float32) * 2.0 - 1.0


def _probe_keys(pop_keys: torch.Tensor, k: int, probe: int) -> torch.Tensor:
    return prng.fold_in(prng.fold_in(pop_keys, k), probe)


def _f32(value) -> np.float32:
    return np.float32(value)


def _energies(operands, n_qubits, structure, initial, angles, keys) -> torch.Tensor:
    gate_types, controls, layer_mask = structure
    return population_energies(
        gate_types, controls, angles, layer_mask, keys=keys, n_qubits=n_qubits,
        initial_state=initial, **operands,
    )


class _Search:
    """One SPSA search's objective, coordinates and keys on the device.

    :param structure: (gate_types, controls, layer_mask) of the circuits
        the probes evaluate
    :param coords: [P, K, 3] long free-parameter coordinates
    :param coord_mask: [P, K] float32, 1 on each individual's valid ones
    :param pop_keys: [P, 2] the individuals' keys (on the CPU)
    """

    def __init__(self, operands, n_qubits, structure, initial, shape, coords, coord_mask,
                 pop_keys):
        self.operands = operands
        self.n_qubits = n_qubits
        self.structure = structure
        self.initial = initial
        self.coord_mask = coord_mask
        self.pop_keys = pop_keys
        pop, layers, n, _ = shape
        rows = torch.arange(pop, device=coords.device)[:, None]
        # flat positions in the angle tensor, scattered with index_add as the
        # reference's .at[].add: padding coordinates repeat (0, 0, 0) with a
        # zero direction, so repeated positions must accumulate
        self.flat = (((rows * layers + coords[..., 0]) * n + coords[..., 1]) * 3
                     + coords[..., 2]).reshape(-1)

    def energies(self, angles, keys) -> torch.Tensor:
        return _energies(self.operands, self.n_qubits, self.structure, self.initial, angles, keys)

    def probe(self, angles, k: int, probe: int) -> torch.Tensor:
        """Energies at ``angles`` with probe ``probe``'s keys of step ``k``
        (drawn only for sampled objectives)."""
        keys = _probe_keys(self.pop_keys, k, probe) if self.operands["use_shots"] else None
        return self.energies(angles, keys)

    def final(self, angles) -> torch.Tensor:
        return self.energies(angles, prng.fold_in(self.pop_keys, FINAL_KEY_DATA))

    def direction(self, k: int) -> torch.Tensor:
        delta = rademacher(_probe_keys(self.pop_keys, k, 0), self.coord_mask.shape[1])
        return delta.to(self.coord_mask.device) * self.coord_mask

    def shifted(self, angles, values) -> torch.Tensor:
        """``angles`` plus ``values`` [P, K] at the coordinates."""
        out = angles.reshape(-1).index_add(0, self.flat, values.reshape(-1))
        return out.reshape(angles.shape)

    def calibrate(self, angles, cfg: SPSAConfig) -> torch.Tensor:
        """Mean |f(x + c d) - f(x - c d)| over the calibration pairs [P]
        (the reference's ``_spsa_calibrate``)."""
        c = float(_f32(cfg.perturbation))
        total = torch.zeros(angles.shape[0], dtype=torch.float32, device=angles.device)
        for k in range(cfg.calibration_steps):
            step = k + CALIBRATION_KEY_OFFSET
            delta = self.direction(step)
            plus = self.probe(self.shifted(angles, c * delta), step, 1)
            minus = self.probe(self.shifted(angles, -c * delta), step, 2)
            total = total + (plus - minus).abs()
        return total / cfg.calibration_steps

    def steps(self, angles, active, learning_rates, cfg: SPSAConfig, maxiter: int,
              start: int = 0) -> torch.Tensor:
        """``maxiter`` gradient steps from step index ``start`` (the
        reference's ``_spsa_scan`` body); inactive individuals keep their
        angles."""
        for k in range(start, start + maxiter):
            it = _f32(k)
            c_k = _f32(cfg.perturbation) / (it + _f32(1.0)) ** _f32(cfg.gamma_power)
            a_k = learning_rates / float(
                (it + _f32(1.0) + _f32(cfg.stability_constant)) ** _f32(cfg.alpha_power)
            )
            delta = self.direction(k)
            f_plus = self.probe(self.shifted(angles, float(c_k) * delta), k, 1)
            f_minus = self.probe(self.shifted(angles, float(-c_k) * delta), k, 2)
            gradient = ((f_plus - f_minus) / float(_f32(2.0) * c_k))[:, None] * delta
            updated = self.shifted(angles, -a_k[:, None] * gradient)
            angles = torch.where(active[:, None, None, None], updated, angles)
        return angles


class BatchedSPSA:
    """Population-lock-step SPSA against an expectation evaluator."""

    def __init__(self, config: SPSAConfig = SPSAConfig()):
        self.config = config

    def _calibrated_rates(self, magnitude: torch.Tensor) -> torch.Tensor:
        """Per-individual ``a`` [P] from the calibration's mean magnitudes."""
        return float(_f32(self.config.target_magnitude)) / magnitude.clamp(min=1e-6)

    def _fixed_rates(self, pop: int, device) -> torch.Tensor:
        rate = float(_f32(self.config.learning_rate))
        return torch.full((pop,), rate, dtype=torch.float32, device=device)

    def _learning_rates(self, search: _Search, angles) -> tuple[torch.Tensor, int]:
        """Per-individual ``a`` [P] and the evaluations spent finding it."""
        cfg = self.config
        if cfg.learning_rate is None:
            return self._calibrated_rates(search.calibrate(angles, cfg)), 2 * cfg.calibration_steps
        return self._fixed_rates(angles.shape[0], angles.device), 0

    def minimize(
        self,
        evaluator,
        packed: PackedPopulation,
        coords: np.ndarray,
        n_free: np.ndarray,
        active: np.ndarray,
        angles: Optional[np.ndarray] = None,
        seed: int = 0,
        termination_checkers: Optional[Sequence[SPSATerminationChecker]] = None,
        last_layer: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Run SPSA over the selected free parameters.

        Same contract as :meth:`BatchedNFT.minimize`.  With
        ``termination_checkers`` (one per individual), the steps run one at
        a time and individuals freeze when their checker terminates; the
        evaluation count then reports the steps taken.
        """
        cfg = self.config
        a = packed.angles if angles is None else angles
        if coords.shape[1] == 0 or not np.any(np.logical_and(active, n_free > 0)):
            return np.asarray(a), np.asarray(evaluator.evaluate_packed(packed, angles=a)), 0
        try:
            operands = objective_operands(evaluator)
        except TypeError:
            # evaluators with host-side objectives (external backends,
            # black-box bitstring functions) have no operands for the
            # device steps: run the same schedules host-stepped against
            # evaluate_packed (the reference's own qiskit-SPSA shape)
            return self._minimize_host(
                evaluator, packed, coords, n_free, active, np.asarray(a), seed,
                termination_checkers,
            )
        mesh = getattr(evaluator, "mesh", None)
        device = evaluator.device
        where = operand_device(mesh, device)
        pop = packed.n_individuals
        n = packed.n_qubits
        gt, ctrl, ang, lm = packed_tensors(packed, a, where)
        coords_t = torch.as_tensor(coords, dtype=torch.long, device=where)
        coord_mask = torch.as_tensor(
            np.arange(coords.shape[1])[None, :] < np.asarray(n_free)[:, None],
            dtype=torch.float32, device=where,
        )
        active_t = torch.as_tensor(active, dtype=torch.bool, device=where)
        pop_keys = prng.split(prng.PRNGKey(seed), pop)
        if termination_checkers is None and prefix_enabled(
            cfg.cache_prefix, operands, mesh, last_layer
        ):
            transform = build_prefix_transform(
                gt, ctrl, ang, lm, coords_t, last_layer, n, evaluator.initial_states(pop)
            )
            search = _Search(
                operands, n, (transform.gate_types, transform.controls, transform.layer_mask),
                transform.initial_state, transform.angles.shape, transform.coords, coord_mask,
                pop_keys,
            )
            learning_rates, nfev = self._learning_rates(search, transform.angles)
            out = search.steps(transform.angles, active_t, learning_rates, cfg, cfg.maxiter)
            energies = search.final(out)
            out = transform.merge(out)
            return out.cpu().numpy(), energies.cpu().numpy(), nfev + 2 * cfg.maxiter

        # full circuits, directly or block by block over the mesh
        replicated = (evaluator._initial, operands)

        def search_of(gt, ctrl, lm, ang, crd, cm, keys, ra) -> _Search:
            shared, ops = ra
            initial = expand_initial(shared, gt.shape[0])
            return _Search(ops, n, (gt, ctrl, lm), initial, ang.shape, crd, cm, keys)

        def calibrate(pa, ra):
            gt, ctrl, lm, ang, crd, cm, keys = pa
            return search_of(gt, ctrl, lm, ang, crd, cm, keys, ra).calibrate(ang, cfg)

        def stepper(maxiter: int, start: int):
            def run(pa, ra):
                gt, ctrl, lm, ang, crd, cm, act, rates, keys = pa
                search = search_of(gt, ctrl, lm, ang, crd, cm, keys, ra)
                out = search.steps(ang, act, rates, cfg, maxiter, start)
                return out, search.final(out)

            return run

        if cfg.learning_rate is None:
            magnitude = run_batched(
                mesh, calibrate, (gt, ctrl, lm, ang, coords_t, coord_mask, pop_keys), replicated
            )
            learning_rates = self._calibrated_rates(magnitude)
            nfev = 2 * cfg.calibration_steps
        else:
            learning_rates = self._fixed_rates(pop, where)
            nfev = 0

        if termination_checkers is None:
            out, energies = run_batched(
                mesh, stepper(cfg.maxiter, 0),
                (gt, ctrl, lm, ang, coords_t, coord_mask, active_t, learning_rates, pop_keys),
                replicated,
            )
            return out.cpu().numpy(), energies.cpu().numpy(), nfev + 2 * cfg.maxiter

        # host-stepped with per-individual termination
        live = np.asarray(active, bool).copy()
        for k in range(cfg.maxiter):
            if not live.any():
                break
            live_t = torch.as_tensor(live, device=where)
            ang, energies = run_batched(
                mesh, stepper(1, k),
                (gt, ctrl, lm, ang, coords_t, coord_mask, live_t, learning_rates, pop_keys),
                replicated,
            )
            energies = energies.cpu().numpy()
            current = ang.cpu().numpy()
            nfev += 2
            for i, checker in enumerate(termination_checkers):
                if live[i] and checker.termination_check(
                    n_function_evaluations=nfev,
                    parameter_values=current[i],
                    function_value=float(energies[i]),
                    step_size=float(cfg.perturbation),
                    accepted=True,
                ):
                    live[i] = False
        current = ang.cpu().numpy()
        return current, np.asarray(evaluator.evaluate_packed(packed, angles=current)), nfev

    def _minimize_host(
        self, evaluator, packed, coords, n_free, active, angles, seed,
        termination_checkers=None,
    ):
        """Host-stepped SPSA for evaluators without objective operands: the
        reference's numpy loop (``_minimize_host``), with the same power-law
        schedules and calibration, perturbation directions from a numpy
        generator seeded with ``seed`` (external backends have no
        stream-identity contract with the device path), and one batched
        ``evaluate_packed`` call per probe -- so both packages compute the
        same numbers on the same callback."""
        cfg = self.config
        pop = packed.n_individuals
        pop_idx = np.arange(pop)[:, None]
        coords = np.asarray(coords)
        n_coords = coords.shape[1]
        coord_mask = (
            np.arange(n_coords)[None, :] < np.asarray(n_free)[:, None]
        ).astype(np.float64)
        l, q, a_i = coords[..., 0], coords[..., 1], coords[..., 2]
        rng = np.random.default_rng(seed)
        current = np.array(angles, dtype=np.float32, copy=True)
        apply = np.logical_and(np.asarray(active, bool), np.asarray(n_free) > 0)

        def objective(a):
            return np.asarray(
                evaluator.evaluate_packed(packed, angles=a.astype(np.float32)),
                dtype=np.float64,
            )

        def shifted(a, delta, scale):
            out = np.array(a, copy=True)
            out[pop_idx, l, q, a_i] += (scale * delta).astype(np.float32)
            return out

        def direction():
            return (rng.integers(0, 2, size=(pop, n_coords)) * 2 - 1) * coord_mask

        nfev = 0
        if cfg.learning_rate is None:
            total = np.zeros(pop, np.float64)
            for _ in range(cfg.calibration_steps):
                delta = direction()
                total += np.abs(
                    objective(shifted(current, delta, cfg.perturbation))
                    - objective(shifted(current, delta, -cfg.perturbation))
                )
                nfev += 2
            magnitude = total / cfg.calibration_steps
            learning_rates = cfg.target_magnitude / np.maximum(magnitude, 1e-6)
        else:
            learning_rates = np.full(pop, cfg.learning_rate, np.float64)

        live = apply.copy()
        for k in range(cfg.maxiter):
            if not live.any():
                break
            c_k = cfg.perturbation / (k + 1.0) ** cfg.gamma_power
            a_k = learning_rates / (k + 1.0 + cfg.stability_constant) ** cfg.alpha_power
            delta = direction()
            f_plus = objective(shifted(current, delta, c_k))
            f_minus = objective(shifted(current, delta, -c_k))
            nfev += 2
            gradient = ((f_plus - f_minus) / (2.0 * c_k))[:, None] * delta
            updated = np.array(current, copy=True)
            updated[pop_idx, l, q, a_i] -= (a_k[:, None] * gradient).astype(np.float32)
            current = np.where(live[:, None, None, None], updated, current)
            energies = np.minimum(f_plus, f_minus)
            if termination_checkers is not None:
                for i, checker in enumerate(termination_checkers):
                    if live[i] and checker.termination_check(
                        n_function_evaluations=nfev,
                        parameter_values=current[i],
                        function_value=float(energies[i]),
                        step_size=float(c_k),
                        accepted=True,
                    ):
                        live[i] = False
        final = np.asarray(evaluator.evaluate_packed(packed, angles=current))
        return current, final, nfev + 1

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
        """A whole multi-slot parameter search — same contract as
        :meth:`BatchedNFT.minimize_slots`: each slot calibrates (unless a
        learning rate is set) and runs its steps from that slot's prefix
        states, probes applying only the suffix layers; slot s's keys are
        ``split(PRNGKey(seeds[s]), P)``.  Returns None for an unsupported
        evaluator and where ``cache_prefix`` resolves off.
        """
        if getattr(evaluator, "nft_minimize", None) is not None:
            return None  # an amplitude-sharded evaluator: the per-slot loop
        try:
            operands = objective_operands(evaluator)
        except TypeError:
            return None
        cfg = self.config
        if not cache_enabled(cfg.cache_prefix, operands):
            return None
        mesh = getattr(evaluator, "mesh", None)
        where = operand_device(mesh, evaluator.device)
        n = packed.n_qubits
        pop, n_slots = n_free.shape
        seeds = np.zeros(n_slots, np.int64) if seeds is None else np.asarray(seeds)
        keys = torch.stack([prng.split(prng.PRNGKey(int(s)), pop) for s in seeds], dim=1)

        def search(pa, ra):
            gt, ctrl, ang, lm, crd, cm, act, layers, keys = pa
            shared, ops = ra
            initial = expand_initial(shared, gt.shape[0])
            for s in range(n_slots):
                prefix = simulate_prefix_states(
                    gt, ctrl, ang, prefix_mask(lm, layers[:, s]), n, initial
                )
                suffix = lm & ~prefix_mask(torch.ones_like(lm), layers[:, s])
                slot = _Search(ops, n, (gt, ctrl, suffix), prefix, ang.shape, crd[:, s],
                               cm[:, s], keys[:, s])
                learning_rates, _ = self._learning_rates(slot, ang)
                ang = slot.steps(ang, act[:, s], learning_rates, cfg, cfg.maxiter)
            final = _energies(ops, n, (gt, ctrl, lm), initial, ang,
                              prng.fold_in(keys[:, n_slots - 1], FINAL_KEY_DATA))
            return ang, final

        pop_args = (
            *packed_tensors(packed, angles, where),
            torch.as_tensor(coords, dtype=torch.long, device=where),
            torch.as_tensor(
                np.arange(coords.shape[2])[None, None, :] < np.asarray(n_free)[:, :, None],
                dtype=torch.float32, device=where,
            ),
            torch.as_tensor(active, dtype=torch.bool, device=where),
            torch.as_tensor(slot_layers, dtype=torch.long, device=where),
            keys,
        )
        out, final = run_batched(mesh, search, pop_args, (evaluator._initial, operands))
        return out.cpu().numpy(), final.cpu().numpy(), cfg.n_circuit_evaluations()
