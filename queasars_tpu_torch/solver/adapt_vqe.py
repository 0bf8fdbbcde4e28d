"""ADAPT-VQE: gradient-screened adaptive ansatz growth (PyTorch).

Counterpart of ``queasars_tpu/solver/adapt_vqe.py`` (arXiv:1812.11173) on
one device: a single ansatz grows one gate at a time, each step picking the
operator-pool candidate with the largest energy gradient magnitude at zero
angle, then re-optimizing every placed parameter with Adam.  Gradients come
from ``torch.autograd`` through the port's plain slot engine
(``sim/statevector.py``'s per-slot arithmetic); the reference runs its jnp
engine here too, so no kernel is on this path.

The candidate pool stays inside the genome's U3/CU3 alphabet, so every
grown ansatz is a valid genome:

- ``RY(q)``   = U3(theta, 0, 0)
- ``RZ(q)``   = U3(0, 0, theta)
- ``CRY(c,t)``= CU3(theta, 0, 0)
- ``CP(c,t)`` = CU3(0, 0, theta)

Shapes: the ansatz is the packed genome tensors padded to ``max_depth``
layers of one gate each.  The screen is one batched forward and backward per
target qubit, the candidates on the batch axis (theta [C]; each candidate's
energy depends only on its own theta, so the gradient of their sum is the
per-candidate stack), in chunks of at most :data:`SCREEN_CHUNK_BYTES` of
states.  Only the gate each candidate or grown layer holds is applied: an
empty slot is an exact identity in the slot engine, so the states equal the
reference's full-layer ones while autograd keeps one state per gate instead
of one per slot.  Adam runs in float32 as in the gradient optimizer
(``optim/gradient.py``).  With a population mesh (``mesh`` /
``n_devices``, ``parallel/mesh.py``) the screen splits the candidate axis
over the mesh's blocks (:func:`screen_pool_sharded`, the reference's
``_screen_pool_sharded``): each block screens its candidates against the
replicated state, equal to the single-device screen bit for bit.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from queasars_tpu_torch.genome.circuit_layer import EVQECircuitLayer
from queasars_tpu_torch.genome.gates import (
    ControlGate,
    ControlledRotationGate,
    IdentityGate,
    RotationGate,
)
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.optim.gradient import Adam
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table
from queasars_tpu_torch.sim.evaluators import _prepare_initial_state
from queasars_tpu_torch.sim.expectation import general_pauli_expectation_real, pauli_terms
from queasars_tpu_torch.sim.statevector import (
    GATE_CROT,
    GATE_CTRL,
    GATE_ROT,
    _apply_slot,
    init_states,
)
from queasars_tpu_torch.utils import batch_invariant
from queasars_tpu_torch.utils.batch_invariant import row_sum
from queasars_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: the most bytes of candidate states one screen batch holds
SCREEN_CHUNK_BYTES = 2 << 30


@dataclass(frozen=True)
class AdaptVQEConfiguration:
    """Hyperparameters of the ADAPT-VQE growth loop.

    :param max_depth: ansatz growth budget (one gate per grown layer)
    :param gradient_tolerance: stop growing when the largest pool gradient
        magnitude falls below this
    :param energy_tolerance: optional additional stop when a growth
        iteration improves the energy by less than this
    :param pool: ``"full"`` (RY/RZ per qubit + CRY/CP on every ordered
        qubit pair), ``"linear"`` (nearest-neighbour pairs, both
        directions) or ``"single"`` (single-qubit rotations only)
    :param optimizer_maxiter: Adam steps of the full re-optimization after
        each growth step
    :param learning_rate / b1 / b2 / eps: Adam hyperparameters
    :param start: reference state without ``initial_state``: ``"plus"``
        (uniform superposition; every basis state of a diagonal operator is
        an eigenstate, where every pool gradient vanishes) or ``"zero"``
    :param initial_state: optional start state (a statevector or an
        :class:`EVQEIndividual` preparing it); overrides ``start``
    :param mesh: split the pool-gradient screen over this population mesh's
        blocks (the candidate axis, O(n^2) candidates for the ``"full"``
        pool, is ADAPT-VQE's parallel dimension)
    :param n_devices: shorthand for ``mesh``: ``population_mesh(n_devices)``,
        or ``n_devices`` CPU blocks when ``device`` is the CPU
    :param device: where the solve runs (None = the CUDA device)
    """

    max_depth: int = 20
    gradient_tolerance: float = 1e-3
    energy_tolerance: Optional[float] = None
    pool: str = "full"
    optimizer_maxiter: int = 100
    learning_rate: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    start: str = "plus"
    initial_state: Optional[Union[np.ndarray, EVQEIndividual]] = None
    mesh: Optional[object] = None
    n_devices: Optional[int] = None
    device: Optional[object] = None

    def __post_init__(self):
        if self.max_depth < 1:
            raise ValueError("max_depth must be at least 1")
        if self.gradient_tolerance < 0:
            raise ValueError("gradient_tolerance must be non-negative")
        if self.energy_tolerance is not None and self.energy_tolerance < 0:
            raise ValueError("energy_tolerance must be non-negative")
        if self.pool not in ("full", "linear", "single"):
            raise ValueError(f"pool must be 'full', 'linear' or 'single', got {self.pool!r}")
        if self.optimizer_maxiter < 1:
            raise ValueError("optimizer_maxiter must be at least 1")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be positive")
        if self.start not in ("plus", "zero"):
            raise ValueError(f"start must be 'plus' or 'zero', got {self.start!r}")


@dataclass(frozen=True)
class AdaptVQEIterationRecord:
    """One growth iteration: what was screened, picked and reached."""

    candidate: str
    gradient: float
    energy: float


@dataclass(frozen=True)
class AdaptVQEResult:
    """Outcome of an ADAPT-VQE solve; ``n_circuit_evaluations`` counts one
    evaluation per screened candidate and two per Adam step."""

    eigenvalue: float
    optimal_individual: EVQEIndividual
    iterations: tuple[AdaptVQEIterationRecord, ...]
    n_circuit_evaluations: int
    converged: bool

    @property
    def optimal_point(self) -> np.ndarray:
        return np.asarray(self.optimal_individual.parameter_values, dtype=np.float64)


def _build_pool(n_qubits: int, pool: str):
    """Candidate layers: ([C, n] types, [C, n] controls, [C, n, 3] angle
    placement, [C] labels), in the reference's order."""
    types, controls, amask, labels = [], [], [], []

    def add(label, placements, angle_slot, target):
        t = np.zeros(n_qubits, np.int32)
        c = np.full(n_qubits, -1, np.int32)
        a = np.zeros((n_qubits, 3), np.float32)
        for q, (gt, ct) in placements.items():
            t[q] = gt
            c[q] = ct
        a[target, angle_slot] = 1.0
        types.append(t)
        controls.append(c)
        amask.append(a)
        labels.append(label)

    for q in range(n_qubits):
        add(f"RY({q})", {q: (GATE_ROT, -1)}, 0, q)
        add(f"RZ({q})", {q: (GATE_ROT, -1)}, 2, q)
    if pool != "single":
        if pool == "linear":
            pairs = [(q, q + 1) for q in range(n_qubits - 1)]
            pairs += [(q + 1, q) for q in range(n_qubits - 1)]
        else:
            pairs = [(c, t) for c in range(n_qubits) for t in range(n_qubits) if c != t]
        for c_q, t_q in pairs:
            crot = {t_q: (GATE_CROT, c_q), c_q: (GATE_CTRL, t_q)}
            add(f"CRY({c_q},{t_q})", crot, 0, t_q)
            add(f"CP({c_q},{t_q})", crot, 2, t_q)
    return np.stack(types), np.stack(controls), np.stack(amask), tuple(labels)


class _Gates:
    """Single gates on a batch of states: target qubit, gate type, control
    and angle slot per gate ([C] host arrays), from candidate or grown
    layers ([C, n] types / controls, [C, n, 3] angle placement)."""

    def __init__(self, types, controls, amask):
        self.target = np.argmax(np.abs(amask).sum(axis=2), axis=1)
        rows = np.arange(len(self.target))
        self.gate_type = types[rows, self.target]
        self.control = controls[rows, self.target]
        self.slot = np.argmax(amask[rows, self.target], axis=1)

    def apply(self, states, index, angles, n_qubits):
        """Apply gates ``index`` (all with one target) with [len, 3] angles
        to states [len, 2, 2^n]."""
        device = states.device
        q = int(self.target[index[0]])
        count = len(index)
        gate_type = torch.as_tensor(self.gate_type[index], device=device)
        control = torch.as_tensor(self.control[index], device=device)
        on = torch.ones(count, dtype=torch.bool, device=device)
        return _apply_slot(states, q, gate_type, control, angles, on, n_qubits)


def _energies(states, diagonal: bool, operands) -> torch.Tensor:
    """<H> [B] of states [B, 2, 2^n]: the table's expectation, or the term
    scan of a general operator."""
    if diagonal:
        return row_sum((states[:, 0] * states[:, 0] + states[:, 1] * states[:, 1]) * operands)
    return general_pauli_expectation_real(states, *operands)


def screen_pool(state, pool_t, pool_c, pool_a, operands, n_qubits, diagonal) -> np.ndarray:
    """d<H>/d theta at theta = 0 of appending each candidate to ``state``
    [2, 2^n]: [C] float32, the reference's ``_screen_pool``.  It runs in
    ``batch_invariant.scope``, so a candidate's gradient does not depend on
    the batch it shares, and :func:`screen_pool_sharded` equals it."""
    with batch_invariant.scope():
        return _screen(state, pool_t, pool_c, pool_a, operands, n_qubits, diagonal)


def _screen(state, pool_t, pool_c, pool_a, operands, n_qubits, diagonal) -> np.ndarray:
    gates = _Gates(pool_t, pool_c, pool_a)
    grads = np.zeros(len(gates.target), np.float32)
    per_state = state.numel() * state.element_size()
    chunk = max(1, SCREEN_CHUNK_BYTES // per_state)
    for q in range(n_qubits):
        members = np.nonzero(gates.target == q)[0]
        for start in range(0, len(members), chunk):
            index = members[start:start + chunk]
            theta = torch.zeros(len(index), dtype=torch.float32, device=state.device,
                                requires_grad=True)
            with torch.enable_grad():
                angles = torch.zeros((len(index), 3), dtype=torch.float32, device=state.device)
                angles = angles.index_put(
                    (torch.arange(len(index), device=state.device),
                     torch.as_tensor(gates.slot[index], device=state.device)), theta)
                batch = state.expand(len(index), *state.shape)
                out = gates.apply(batch, index, angles, n_qubits)
                (grad,) = torch.autograd.grad(_energies(out, diagonal, operands).sum(), theta)
            grads[index] = grad.cpu().numpy()
    return grads


def screen_pool_sharded(
    mesh, state, pool_t, pool_c, pool_a, operands, n_qubits, diagonal
) -> np.ndarray:
    """:func:`screen_pool` over a population mesh: the candidate axis is
    padded to a multiple of the mesh size with all-identity candidates
    (whose gradient is exactly 0; they are cut off after), cut into one
    contiguous block per device, and each block screens its candidates
    against the replicated ``state`` (the reference's
    ``_screen_pool_sharded``).  Each candidate's arithmetic is that of the
    single-device screen."""
    from queasars_tpu_torch.parallel.mesh import run_blocks

    n_candidates = len(pool_t)
    pad = -n_candidates % mesh.size
    if pad:
        pool_t = np.concatenate([pool_t, np.zeros((pad, n_qubits), np.int32)])
        pool_c = np.concatenate([pool_c, np.full((pad, n_qubits), -1, np.int32)])
        pool_a = np.concatenate([pool_a, np.zeros((pad, n_qubits, 3), np.float32)])

    def block(pa, ra):
        types, controls, amask = (t.cpu().numpy() for t in pa)
        block_state, block_operands = ra
        return torch.as_tensor(screen_pool(
            block_state, types, controls, amask, block_operands, n_qubits, diagonal
        ))

    grads = run_blocks(mesh, block, (pool_t, pool_c, pool_a), (state, operands))
    return grads.numpy()[:n_candidates]


class _Ansatz:
    """The grown ansatz: one gate per layer over a start state."""

    def __init__(self, initial, n_qubits, max_depth, device):
        self.initial = initial
        self.n_qubits = n_qubits
        self.device = device
        self.gate_types = np.zeros((max_depth, n_qubits), np.int32)
        self.controls = np.full((max_depth, n_qubits), -1, np.int32)
        self.layer_mask = np.zeros(max_depth, bool)
        self.free_mask = np.zeros((max_depth, n_qubits, 3), np.float32)
        self.angles = torch.zeros((max_depth, n_qubits, 3), dtype=torch.float32, device=device)
        self.depth = 0

    def grow(self, types_row, controls_row, amask_row) -> None:
        d = self.depth
        self.gate_types[d] = types_row
        self.controls[d] = controls_row
        self.layer_mask[d] = True
        self.free_mask[d] = amask_row
        self.depth += 1

    def state(self, angles) -> torch.Tensor:
        """[2, 2^n] after the grown layers at ``angles`` [L, n, 3]."""
        if self.initial is None:
            state = init_states(1, self.n_qubits, device=self.device)
        else:
            state = self.initial[None].clone()
        if self.depth:
            gates = _Gates(self.gate_types[:self.depth], self.controls[:self.depth],
                           self.free_mask[:self.depth])
            for layer in range(self.depth):
                q = int(gates.target[layer])
                state = gates.apply(state, [layer], angles[layer, q][None], self.n_qubits)
        return state[0]


def _reoptimize(ansatz: _Ansatz, operands, diagonal, cfg: AdaptVQEConfiguration):
    """Adam over every placed parameter (the reference's ``_reoptimize``);
    returns (angles, energy)."""
    free = torch.as_tensor(ansatz.free_mask, device=ansatz.device)
    angles = ansatz.angles
    adam = Adam(angles, cfg.learning_rate, cfg.b1, cfg.b2, cfg.eps)
    for k in range(cfg.optimizer_maxiter):
        leaf = angles.detach().requires_grad_(True)
        with torch.enable_grad():
            energy = _energies(ansatz.state(leaf)[None], diagonal, operands)[0]
            (g,) = torch.autograd.grad(energy, leaf)
        angles = angles - adam.update(g * free, k)
    with torch.no_grad():
        energy = _energies(ansatz.state(angles)[None], diagonal, operands)[0]
    return angles, float(energy)


class AdaptVQEMinimumEigensolver:
    """Single-ansatz adaptive growth driven by pool gradients."""

    def __init__(self, configuration: AdaptVQEConfiguration):
        self.configuration = configuration

    def compute_minimum_eigenvalue(self, operator: PauliSum) -> AdaptVQEResult:
        cfg = self.configuration
        device = resolve_device(cfg.device)
        n = operator.n_qubits
        diagonal = operator.is_diagonal
        if diagonal:
            operands = diagonal_energy_table(operator, dtype=torch.float32, device=device)
        else:
            if n > 32:
                raise ValueError("general operators are limited to n <= 32 qubits")
            operands = pauli_terms(operator, device)
        initial = _prepare_initial_state(cfg.initial_state, n, device)
        if initial is None and cfg.start == "plus":
            amp = np.float32(2.0 ** (-n / 2.0))
            initial = torch.as_tensor(
                np.stack([np.full(1 << n, amp, np.float32), np.zeros(1 << n, np.float32)]),
                device=device,
            )
        pool_t, pool_c, pool_a, labels = _build_pool(n, cfg.pool)
        ansatz = _Ansatz(initial, n, cfg.max_depth, device)
        mesh = cfg.mesh
        if mesh is None and cfg.n_devices is not None:
            from queasars_tpu_torch.parallel.mesh import mesh_of

            mesh = mesh_of(cfg.n_devices, cfg.device)

        history: list[AdaptVQEIterationRecord] = []
        converged = False
        with torch.no_grad():
            energy = float(_energies(ansatz.state(ansatz.angles)[None], diagonal, operands)[0])
        n_evals = 1

        for depth in range(cfg.max_depth):
            with torch.no_grad():
                state = ansatz.state(ansatz.angles)
            if mesh is None:
                grads = screen_pool(state, pool_t, pool_c, pool_a, operands, n, diagonal)
            else:
                grads = screen_pool_sharded(
                    mesh, state, pool_t, pool_c, pool_a, operands, n, diagonal
                )
            n_evals += len(labels)
            pick = int(np.argmax(np.abs(grads)))
            g_pick = float(grads[pick])
            if abs(g_pick) < cfg.gradient_tolerance:
                converged = True
                logger.info(
                    "ADAPT converged at depth %d: max |pool gradient| %.3e < %.3e",
                    depth, abs(g_pick), cfg.gradient_tolerance,
                )
                break
            ansatz.grow(pool_t[pick], pool_c[pick], pool_a[pick])
            ansatz.angles, new_energy = _reoptimize(ansatz, operands, diagonal, cfg)
            n_evals += 2 * cfg.optimizer_maxiter
            history.append(AdaptVQEIterationRecord(labels[pick], g_pick, new_energy))
            logger.info(
                "ADAPT depth %d: grew %s (gradient %.3e), energy %.6f",
                depth + 1, labels[pick], g_pick, new_energy,
            )
            improvement = energy - new_energy
            energy = new_energy
            if cfg.energy_tolerance is not None and improvement < cfg.energy_tolerance:
                converged = True
                break

        individual = self._to_individual(
            n, ansatz.gate_types, ansatz.controls, ansatz.angles.cpu().numpy(), ansatz.layer_mask
        )
        return AdaptVQEResult(
            eigenvalue=energy,
            optimal_individual=individual,
            iterations=tuple(history),
            n_circuit_evaluations=n_evals,
            converged=converged,
        )

    @staticmethod
    def _to_individual(n, gate_types, controls, angles, layer_mask) -> EVQEIndividual:
        """The grown tensors as a standard genome (one gate per layer,
        identities elsewhere; one identity layer when nothing grew)."""
        if not layer_mask.any():
            identity = EVQECircuitLayer(
                n_qubits=n, gates=tuple(IdentityGate(qubit_index=q) for q in range(n))
            )
            return EVQEIndividual(n_qubits=n, layers=(identity,), parameter_values=())
        layers: list[EVQECircuitLayer] = []
        params: list[float] = []
        for l in range(len(layer_mask)):
            if not layer_mask[l]:
                continue
            gates = []
            for q in range(n):
                gt = int(gate_types[l, q])
                if gt == GATE_ROT:
                    gates.append(RotationGate(qubit_index=q))
                elif gt == GATE_CROT:
                    gates.append(
                        ControlledRotationGate(qubit_index=q, control_qubit_index=int(controls[l, q]))
                    )
                elif gt == GATE_CTRL:
                    gates.append(
                        ControlGate(qubit_index=q, controlled_qubit_index=int(controls[l, q]))
                    )
                else:
                    gates.append(IdentityGate(qubit_index=q))
            layers.append(EVQECircuitLayer(n_qubits=n, gates=tuple(gates)))
            for q in range(n):
                if int(gate_types[l, q]) in (GATE_ROT, GATE_CROT):
                    params.extend(float(a) for a in angles[l, q])
        return EVQEIndividual(n_qubits=n, layers=tuple(layers), parameter_values=tuple(params))
