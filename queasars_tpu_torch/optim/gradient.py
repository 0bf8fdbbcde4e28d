"""Batched gradient descent (Adam/SGD) through reverse-mode autodiff (PyTorch).

Counterpart of ``queasars_tpu/optim/gradient.py``: exact gradients of
<psi(theta)|H|psi(theta)> from one backward pass (``torch.autograd``) through
the port's plain engines, the whole population descending in lock-step over
the same [P, K, 3] coordinate tables the NFT and SPSA batchers use.

The differentiable objective (:class:`_Objective`) is the function the
reference's ``population_energies(..., use_pallas=False)`` computes: the slot
engine (``sim/statevector.py``; only the slots some individual fills are
applied, an empty slot being an exact identity) or, with ``use_fold``, the
kron-fold applier (``sim/fold_pipeline.py::simulate_circuits_folded``),
followed by the plain or CVaR expectation of a diagonal operator, the dense
matvec or the term scan of a general one.  The CUDA kernels define no
backward, so the objective never calls them; everything around it that the
reference runs on its kernels launches the port's: the frozen-prefix states
(``optim/prefix.py``, under ``torch.no_grad``), the early exit's evaluation,
and (in the solvers) selection and the final distribution.

The reference's ``lax.scan`` bodies are plain loops over tensors on the
evaluator's device.  theta is a [P, K] leaf tensor, scattered into the angle
tensor with an accumulating ``index_add`` (every padded coordinate points at
(0, 0, 0) with a zero mask, and the reference's ``.at[].add`` sums repeats).
Adam's arithmetic is float32 throughout, the bias corrections ``b**t`` from
float32 tensors as ``jnp.power`` computes them.  The reference's per-step
keys feed only its additive precision noise, which no exact objective has;
a shot-sampled objective raises, as there.

Ledger: one step costs a forward and a backward pass, charged as 2
reference-equivalent evaluations (``GradientDescentConfig.
n_circuit_evaluations``).

Under a population mesh (the evaluator's ``mesh``, ``parallel/mesh.py``)
both searches run block by block on the mesh's devices, as the reference's
two dispatch sites do; the prefix cache is off under a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.optim.objective import objective_operands
from queasars_tpu_torch.optim.prefix import (
    build_prefix_transform,
    cache_enabled,
    prefix_enabled,
    prefix_mask,
    simulate_prefix_states,
)
from queasars_tpu_torch.parallel.mesh import operand_device, run_batched
from queasars_tpu_torch.sim.evaluators import expand_initial, packed_tensors
from queasars_tpu_torch.sim.expectation import (
    DenseHermitian,
    cvar_expectation_from_probs,
    dense_expectation,
    expectation_from_probs,
    general_pauli_expectation_real,
)
from queasars_tpu_torch.sim.fold_pipeline import simulate_circuits_folded
from queasars_tpu_torch.sim.statevector import GATE_CROT, GATE_ROT, _apply_slot, init_states


@dataclass(frozen=True)
class GradientDescentConfig:
    """Adam/SGD hyperparameters.

    :param maxiter: gradient steps (each one forward + one backward pass)
    :param learning_rate: step size
    :param b1 / b2 / eps: Adam moment decays and denominator floor
        (ignored for ``method="sgd"``)
    :param method: ``"adam"`` or ``"sgd"``
    :param cache_prefix: layer-prefix cache for last-layer searches and the
        fused multi-slot search (as :class:`~queasars_tpu_torch.optim.nft.
        NFTConfig`'s)
    :param use_fold: differentiate through the kron-fold applier instead of
        the slot engine (None = off, the reference's default); the first
        step still differentiates through the slot engine, because the
        fold's eigendecomposition has a kink at a fresh layer's zero angles
    """

    maxiter: int = 100
    learning_rate: float = 0.05
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    method: str = "adam"
    cache_prefix: Optional[bool] = None
    use_fold: Optional[bool] = None

    def __post_init__(self):
        if self.method not in ("adam", "sgd"):
            raise ValueError(f"method must be 'adam' or 'sgd', got {self.method!r}")
        if self.maxiter < 1:
            raise ValueError("maxiter must be >= 1")
        if self.learning_rate <= 0.0:
            raise ValueError("learning_rate must be positive")

    def n_circuit_evaluations(self) -> int:
        return 2 * self.maxiter


class Adam:
    """The reference's Adam (or SGD) update in float32 arithmetic.

    :param like: a tensor of the parameters' shape, dtype and device
    :param host_complements: take ``1 - b1`` and ``1 - b2`` in float64 on
        the host before rounding them to float32, as a scan whose decays are
        Python floats does (the QAOA solver's); otherwise they are float32
        differences, as in a scan whose decays are float32 arrays
    """

    def __init__(self, like, lr, b1, b2, eps, method="adam", host_complements=False):
        def f32(value) -> torch.Tensor:
            return torch.tensor(np.float32(value), device=like.device)

        self.f32 = f32
        self.method = method
        self.lr, self.b1, self.b2, self.eps, self.one = (f32(v) for v in (lr, b1, b2, eps, 1.0))
        if host_complements:
            self.c1, self.c2 = f32(1.0 - b1), f32(1.0 - b2)
        else:
            self.c1, self.c2 = self.one - self.b1, self.one - self.b2
        self.m = torch.zeros_like(like)
        self.v = torch.zeros_like(like)

    def update(self, g: torch.Tensor, k: int) -> torch.Tensor:
        """The step to subtract at step index ``k`` (from 0) for gradient ``g``."""
        if self.method == "sgd":
            return self.lr * g
        self.m = self.b1 * self.m + self.c1 * g
        self.v = self.b2 * self.v + self.c2 * g * g
        t = self.f32(k + 1)
        m_hat = self.m / (self.one - torch.pow(self.b1, t))
        v_hat = self.v / (self.one - torch.pow(self.b2, t))
        return self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def live_slots(gate_types: torch.Tensor, layer_mask: torch.Tensor) -> list[tuple[int, int]]:
    """The (layer, qubit) slots where some individual has a U3 or CU3 in a
    real layer, in application order (one read of the genome to the host)."""
    gt = gate_types.cpu().numpy()
    filled = ((gt == GATE_ROT) | (gt == GATE_CROT)) & layer_mask.cpu().numpy()[:, :, None]
    return [(int(l), int(q)) for l, q in zip(*np.nonzero(filled.any(axis=0)))]


def simulate_slots(gate_types, controls, angles, layer_mask, n_qubits, initial, slots):
    """[P, 2, 2^n] states through the slot engine's arithmetic, applying only
    ``slots`` (:func:`live_slots`): equal to ``simulate_circuits`` bit for
    bit, since every other slot is an identity for every individual."""
    pop = gate_types.shape[0]
    if initial is None:
        state = init_states(pop, n_qubits, device=angles.device)
    else:
        state = initial.to(torch.float32).expand(pop, 2, 1 << n_qubits).clone()
    for layer, q in slots:
        state = _apply_slot(
            state, q, gate_types[:, layer, q], controls[:, layer, q], angles[:, layer, q],
            layer_mask[:, layer], n_qubits,
        )
    return state


def energies_from_states(states: torch.Tensor, operands: dict) -> torch.Tensor:
    """Energies [P] of states [P, 2, 2^n] under :func:`objective_operands`'
    exact operands (plain or CVaR expectation of a diagonal table, the dense
    matvec or the term scan of a general operator)."""
    if operands["use_general"]:
        table = operands["table"]
        if isinstance(table, DenseHermitian):
            return dense_expectation(states, table)
        return general_pauli_expectation_real(states, *table)
    probs = states[:, 0, :] ** 2 + states[:, 1, :] ** 2
    if operands["use_cvar"]:
        return cvar_expectation_from_probs(
            probs, operands["sorted_energies"], operands["energy_order"], operands["alpha"]
        )
    return expectation_from_probs(probs, operands["table"])


class _Objective:
    """One search's differentiable energies over its coordinates.

    :param structure: (gate_types, controls, layer_mask) device tensors of
        the circuits the search evaluates
    :param initial: None (|0...0>) or per-individual [P, 2, 2^n] states
    :param coords: [P, K, 3] long coordinates into the [P, L, n, 3] angles
    :param coord_mask: [P, K] float32, 1 on each individual's valid ones
    """

    def __init__(self, operands, n_qubits, structure, initial, coords, coord_mask, shape):
        self.operands = operands
        self.n_qubits = n_qubits
        self.structure = structure
        self.initial = initial
        self.coord_mask = coord_mask
        self.slots = live_slots(structure[0], structure[2])
        pop, layers, n, _ = shape
        rows = torch.arange(pop, device=coords.device)[:, None]
        self.flat = (((rows * layers + coords[..., 0]) * n + coords[..., 1]) * 3
                     + coords[..., 2]).reshape(-1)

    def shifted(self, angles, values) -> torch.Tensor:
        """``angles`` plus ``values`` [P, K] at the coordinates (repeats add)."""
        out = angles.reshape(-1).index_add(0, self.flat, values.reshape(-1))
        return out.reshape(angles.shape)

    def energies(self, angles, fold: bool) -> torch.Tensor:
        gate_types, controls, layer_mask = self.structure
        if fold:
            states = simulate_circuits_folded(
                gate_types, controls, angles, layer_mask, self.n_qubits, self.initial
            )
        else:
            states = simulate_slots(
                gate_types, controls, angles, layer_mask, self.n_qubits, self.initial, self.slots
            )
        return energies_from_states(states, self.operands)

    def gradient(self, angles, theta, fold: bool) -> torch.Tensor:
        """d(sum of energies)/d theta [P, K] at ``angles`` shifted by
        ``theta * coord_mask``; each energy depends only on its own row."""
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.energies(self.shifted(angles, theta * self.coord_mask), fold).sum()
            if not loss.requires_grad:
                # no slot is filled in this batch (a mesh block of padding):
                # every energy is constant in theta
                return torch.zeros_like(theta)
            (grad,) = torch.autograd.grad(loss, theta)
        return grad

    def descend(self, angles, act, cfg: GradientDescentConfig, fold: bool) -> torch.Tensor:
        """theta [P, K] after ``cfg.maxiter`` Adam/SGD steps from zero;
        ``act`` [P, K] masks the inactive individuals' and padded
        coordinates (the reference's ``_gradient_scan`` step)."""
        adam = Adam(act, cfg.learning_rate, cfg.b1, cfg.b2, cfg.eps, cfg.method)
        theta = torch.zeros_like(act)
        for k in range(cfg.maxiter):
            g = self.gradient(angles, theta, fold and k > 0) * act
            theta = theta - adam.update(g, k) * act
        return theta


def _operands(evaluator, strict: bool) -> Optional[dict]:
    """The evaluator's exact operands; with ``strict`` an unsupported or
    shot-sampled objective raises the reference's ValueError, else None."""
    try:
        operands = objective_operands(evaluator)
    except TypeError as exc:
        if not strict:
            return None
        raise ValueError(
            "BatchedGradientDescent needs a differentiable device objective "
            "(StatevectorExpectationEvaluator); black-box bitstring objectives "
            "have no gradient — use BatchedNFT or BatchedSPSA"
        ) from exc
    if operands["use_shots"]:
        if not strict:
            return None
        raise ValueError(
            "shot-sampled objectives are not differentiable; use BatchedSPSA "
            "(stochastic approximation) or an exact estimator evaluator"
        )
    return operands


class BatchedGradientDescent:
    """Population-lock-step Adam/SGD against a differentiable evaluator."""

    def __init__(self, config: GradientDescentConfig = GradientDescentConfig()):
        self.config = config

    def publishes_exact_energies(self, evaluator) -> bool:
        """The returned energies come from the plain engine, whose floats
        differ from the kernels' at the 1e-7 level, so selection
        re-evaluates (as in the reference)."""
        return False

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
        """Run Adam/SGD over the selected free parameters.

        Same contract as :meth:`~queasars_tpu_torch.optim.nft.BatchedNFT.
        minimize`; ``seed`` is accepted for that contract and read by no
        exact objective.  With ``last_layer`` and ``cache_prefix`` resolved
        on, the descent runs on the one layer over the cached prefix states.
        """
        cfg = self.config
        a = packed.angles if angles is None else angles
        if coords.shape[1] == 0 or not np.any(np.logical_and(active, n_free > 0)):
            return np.asarray(a), np.asarray(evaluator.evaluate_packed(packed, angles=a)), 0
        operands = _operands(evaluator, strict=True)
        mesh = getattr(evaluator, "mesh", None)
        where = operand_device(mesh, evaluator.device)
        n = packed.n_qubits
        gt, ctrl, ang, lm = packed_tensors(packed, a, where)
        coords_t = torch.as_tensor(coords, dtype=torch.long, device=where)
        coord_mask = torch.as_tensor(
            np.arange(coords.shape[1])[None, :] < np.asarray(n_free)[:, None],
            dtype=torch.float32, device=where,
        )
        active_t = torch.as_tensor(active, dtype=torch.bool, device=where)
        fold = bool(cfg.use_fold)

        def descend(structure, initial, ang, crd, cm, act, ops):
            objective = _Objective(ops, n, structure, initial, crd, cm, ang.shape)
            theta = objective.descend(ang, act.to(torch.float32)[:, None] * cm, cfg, fold)
            with torch.no_grad():
                out = objective.shifted(ang, theta * cm)
                out = torch.where(act[:, None, None, None], out, ang)
                return out, objective.energies(out, fold)

        if prefix_enabled(cfg.cache_prefix, operands, mesh, last_layer):
            with torch.no_grad():
                transform = build_prefix_transform(
                    gt, ctrl, ang, lm, coords_t, last_layer, n,
                    evaluator.initial_states(packed.n_individuals),
                )
            out, energies = descend(
                (transform.gate_types, transform.controls, transform.layer_mask),
                transform.initial_state, transform.angles, transform.coords, coord_mask,
                active_t, operands,
            )
            out = transform.merge(out)
        else:
            def full(pa, ra):
                gt, ctrl, ang, lm, crd, cm, act = pa
                shared, ops = ra
                return descend((gt, ctrl, lm), expand_initial(shared, gt.shape[0]), ang, crd,
                               cm, act, ops)

            out, energies = run_batched(
                mesh, full, (gt, ctrl, ang, lm, coords_t, coord_mask, active_t),
                (evaluator._initial, operands),
            )
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
        """A whole multi-slot parameter search — same contract as
        :meth:`~queasars_tpu_torch.optim.nft.BatchedNFT.minimize_slots`:
        each slot descends from that slot's prefix states (the route's
        states kernel, no gradient), with gradients through the suffix
        layers only.  Returns None for an unsupported or shot-sampled
        objective and where ``cache_prefix`` resolves off (the per-slot
        loop then runs :meth:`minimize`); ``seeds`` are accepted for the
        contract."""
        if getattr(evaluator, "nft_minimize", None) is not None:
            return None  # an amplitude-sharded evaluator: the per-slot loop
        operands = _operands(evaluator, strict=False)
        cfg = self.config
        if operands is None or not cache_enabled(cfg.cache_prefix, operands):
            return None
        mesh = getattr(evaluator, "mesh", None)
        where = operand_device(mesh, evaluator.device)
        n = packed.n_qubits
        n_slots = n_free.shape[1]
        fold = bool(cfg.use_fold)

        def search(pa, ra):
            gt, ctrl, ang, lm, crd, cm, act, layers = pa
            shared, ops = ra
            initial = expand_initial(shared, gt.shape[0])
            act = act.to(torch.float32)[:, :, None] * cm
            for s in range(n_slots):
                with torch.no_grad():
                    prefix = simulate_prefix_states(
                        gt, ctrl, ang, prefix_mask(lm, layers[:, s]), n, initial
                    )
                suffix = lm & ~prefix_mask(torch.ones_like(lm), layers[:, s])
                objective = _Objective(ops, n, (gt, ctrl, suffix), prefix, crd[:, s], cm[:, s],
                                       ang.shape)
                theta = objective.descend(ang, act[:, s], cfg, fold)
                with torch.no_grad():
                    ang = objective.shifted(ang, theta * act[:, s])
            whole = _Objective(ops, n, (gt, ctrl, lm), initial, crd[:, 0], cm[:, 0], ang.shape)
            with torch.no_grad():
                return ang, whole.energies(ang, fold)

        pop_args = (
            *packed_tensors(packed, angles, where),
            torch.as_tensor(coords, dtype=torch.long, device=where),
            torch.as_tensor(
                np.arange(coords.shape[2])[None, None, :] < np.asarray(n_free)[:, :, None],
                dtype=torch.float32, device=where,
            ),
            torch.as_tensor(active, dtype=torch.bool, device=where),
            torch.as_tensor(slot_layers, dtype=torch.long, device=where),
        )
        out, final = run_batched(mesh, search, pop_args, (evaluator._initial, operands))
        return out.cpu().numpy(), final.cpu().numpy(), cfg.n_circuit_evaluations()
