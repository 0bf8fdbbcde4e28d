"""Batched Nakanishi-Fujii-Todo (NFT) optimizer (PyTorch).

Counterpart of ``queasars_tpu/optim/nft.py`` on the JAX package's production
fused route (``use_pallas=True``): the whole population takes NFT steps in
lock-step; a last-layer search simulates the frozen prefix once (states
kernel) and runs the whole sweep from it (sweep kernel); a multi-slot
parameter search re-enters every probe from its slot's cached prefix state
(energies kernel).  The probes take the kron-fold route (fold kernels) by
default and the slot route under ``QUEASARS_MXU=0``, as in the reference
(``optim/objective.py``).  On the card, steps only enqueue launches;
results reach the host once per call.

NFT math (arXiv:1903.12166, matching qiskit's ``nakanishi_fujii_todo``):
the objective is an exact sinusoid in each U3 angle, so from z0=f(x),
z1=f(x+pi/2), z3=f(x-pi/2) the minimum along that coordinate is found in
closed form (``optim/nft_math.py``).  The minimum value is recycled as the
next step's z0, which is re-measured every ``reset_interval`` steps.  Step
k updates flat parameter ``k mod n_free_i`` of each individual (qiskit
NFT's cyclic rule), through per-individual coordinate tables.

The 3-point update is exact for U3 angles and for CU3 angles against
diagonal Hamiltonians — the only operators this port evaluates so far.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from math import ceil
from typing import Optional

import numpy as np
import torch

from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.optim.nft_math import nft_three_point_update
from queasars_tpu_torch.optim.objective import (
    mxu_fold_enabled,
    objective_operands,
    population_energies,
)
from queasars_tpu_torch.optim.prefix import (
    choose_prefix_engine,
    prefix_mask,
    simulate_prefix_states,
)
from queasars_tpu_torch.optim.sweep_kernel_launch import (
    nft_layer_sweep_folded_launch,
    nft_layer_sweep_launch,
)
from queasars_tpu_torch.sim.evaluators import packed_tensors


@dataclass(frozen=True)
class NFTConfig:
    """NFT hyperparameters (qiskit NFT-compatible knobs).

    :param maxiter: parameter-update steps (each costs 2 evaluations, plus
        1 extra on reset steps)
    :param reset_interval: re-measure the recycled z0 every this many steps

    Every last-layer search simulates the frozen prefix layers once and
    re-enters every probe from the cached state (mathematically identical
    to full-circuit probes; float rounding may differ at the ulp level);
    with the plain expectation it runs as one sweep-kernel call.
    """

    maxiter: int = 40
    reset_interval: int = 32

    def n_circuit_evaluations(self) -> int:
        """Evaluations used per optimized individual (ledger input for the
        budget enforcement, reference: mutation.py:282-290)."""
        return 2 * self.maxiter + ceil(self.maxiter / self.reset_interval)


def _nft_steps(objective, angles, coords, n_free, active, maxiter, reset_interval):
    """``maxiter`` lock-step NFT updates of device ``angles`` [P, L, n, 3]
    over ``coords`` [P, K, 3] (layer, qubit, angle); returns (angles, z0)."""
    pop = angles.shape[0]
    rows = torch.arange(pop, device=angles.device)
    apply = active & (n_free > 0)
    z0 = torch.zeros(pop, dtype=torch.float32, device=angles.device)
    for k in range(maxiter):
        if k % reset_interval == 0:
            z0 = objective(angles)
        idx = torch.remainder(torch.full_like(n_free, k), n_free.clamp(min=1)).long()
        layer, q, a = coords[rows, idx].unbind(-1)
        theta = angles[rows, layer, q, a]
        plus = angles.clone()
        plus[rows, layer, q, a] = theta + math.pi / 2
        minus = angles.clone()
        minus[rows, layer, q, a] = theta - math.pi / 2
        shift, minimum_value = nft_three_point_update(z0, objective(plus), objective(minus))
        updated = angles.clone()
        updated[rows, layer, q, a] = theta + (shift + math.pi)
        angles = torch.where(apply[:, None, None, None], updated, angles)
        z0 = torch.where(apply, minimum_value, z0)
    return angles, z0


class BatchedNFT:
    """Population-lock-step NFT against a diagonal-operator evaluator."""

    def __init__(self, config: NFTConfig = NFTConfig()):
        self.config = config

    def publishes_exact_energies(self, evaluator) -> bool:
        """True when the returned energies are the exact evaluator energies
        at the final angles (plain expectation: the 3-point model is exact
        there), so selection may reuse them (PopulationEnergyCache)."""
        try:
            return not objective_operands(evaluator)["use_cvar"]
        except TypeError:
            return False

    def _objective(self, operands, n_qubits, gate_types, controls, layer_mask, initial):
        return lambda angles: population_energies(
            gate_types, controls, angles, layer_mask, n_qubits=n_qubits,
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
        :param seed: unused on the exact path (kept for the optimizer
            contract of the mutation operators)
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
        operands = objective_operands(evaluator)
        device = evaluator.device
        n = packed.n_qubits
        pop = packed.n_individuals
        gt, ctrl, ang, lm = packed_tensors(packed, a, device)
        initial = evaluator.initial_states(pop)
        coords_t = torch.as_tensor(coords, dtype=torch.long, device=device)
        n_free_t = torch.as_tensor(n_free, dtype=torch.int32, device=device)
        active_t = torch.as_tensor(active, dtype=torch.bool, device=device)
        cfg = self.config

        if last_layer is None:
            objective = self._objective(operands, n, gt, ctrl, lm, initial)
            out, energies = _nft_steps(
                objective, ang, coords_t, n_free_t, active_t, cfg.maxiter, cfg.reset_interval
            )
        else:
            rows = torch.arange(pop, device=device)
            ll = torch.as_tensor(last_layer, dtype=torch.long, device=device)
            out = ang.clone()
            if not operands["use_cvar"]:
                launch = (
                    nft_layer_sweep_folded_launch
                    if mxu_fold_enabled(None, n, path="sweep", device=device)
                    else nft_layer_sweep_launch
                )
                out[rows, ll], energies = launch(
                    gt, ctrl, ang, lm, ll,
                    coords_t[:, :, 1:3].to(torch.int32).contiguous(), n_free_t, active_t,
                    operands["table"], n_qubits=n, maxiter=cfg.maxiter,
                    reset_interval=cfg.reset_interval, initial_state=initial,
                )
            else:
                prefix = simulate_prefix_states(
                    gt, ctrl, ang, prefix_mask(lm, ll), n, initial,
                    mode=choose_prefix_engine(n, device),
                )
                layer_coords = coords_t.clone()
                layer_coords[:, :, 0] = 0
                objective = self._objective(
                    operands, n, gt[rows, ll][:, None].contiguous(),
                    ctrl[rows, ll][:, None].contiguous(),
                    torch.ones((pop, 1), dtype=torch.bool, device=device), prefix,
                )
                layer_angles, energies = _nft_steps(
                    objective, ang[rows, ll][:, None].contiguous(), layer_coords, n_free_t,
                    active_t, cfg.maxiter, cfg.reset_interval,
                )
                out[rows, ll] = layer_angles[:, 0]
        return out.cpu().numpy(), energies.cpu().numpy(), cfg.n_circuit_evaluations()

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
        a slot out carries ``packed.max_layers``.  ``seeds`` is unused on
        the exact path.  Returns None for an unsupported evaluator (the
        per-slot loop it would need is not ported).

        :return: (optimized angles, last-slot energies, evaluations used
            per active individual per slot)
        """
        try:
            operands = objective_operands(evaluator)
        except TypeError:
            return None
        device = evaluator.device
        n = packed.n_qubits
        pop = packed.n_individuals
        gt, ctrl, ang, lm = packed_tensors(packed, angles, device)
        initial = evaluator.initial_states(pop)
        coords_t = torch.as_tensor(coords, dtype=torch.long, device=device)
        n_free_t = torch.as_tensor(n_free, dtype=torch.int32, device=device)
        active_t = torch.as_tensor(active, dtype=torch.bool, device=device)
        layers_t = torch.as_tensor(slot_layers, dtype=torch.long, device=device)
        z0 = torch.zeros(pop, dtype=torch.float32, device=device)
        engine = choose_prefix_engine(n, device)
        for s in range(n_free.shape[1]):
            prefix = simulate_prefix_states(
                gt, ctrl, ang, prefix_mask(lm, layers_t[:, s]), n, initial, mode=engine
            )
            suffix = lm & ~prefix_mask(torch.ones_like(lm), layers_t[:, s])
            objective = self._objective(operands, n, gt, ctrl, suffix, prefix)
            ang, z0 = _nft_steps(
                objective, ang, coords_t[:, s], n_free_t[:, s], active_t[:, s],
                self.config.maxiter, self.config.reset_interval,
            )
        return ang.cpu().numpy(), z0.cpu().numpy(), self.config.n_circuit_evaluations()
