"""QAOA solver for the diagonal problem Hamiltonians of the port (PyTorch).

Counterpart of ``queasars_tpu/solver/qaoa.py`` on one device: the Quantum
Approximate Optimization Algorithm (arXiv:1411.4028) with the
transverse-field mixer, over any diagonal operator the problem encoders emit.
``n_starts`` random schedules descend in lock-step by Adam, with gradients
from ``torch.autograd`` through the elementwise simulation
(``sim/qaoa.py``); there is no kernel on this path, in the reference either.

The start schedules are the reference's bit for bit: ``split`` of
``PRNGKey(seed)`` into an initialisation and a measurement key, ``split`` of
the first into the gamma and beta keys, then float32 uniforms
(``utils/prng.py``) scaled as ``jax.random.uniform`` scales them.  The
energy table is summed term by term in float32 as the reference's device
table is (``paulis/diagonal.py::diagonal_energy_table_device``).  A final
measurement with ``shots`` samples the best start's distribution with the
measurement key (``sim/sampling.py``).

With a ``mesh`` (any mesh, all its devices on the amplitude axis) or
``n_devices`` > 1, the state is split over an amplitude mesh
(``sim/qaoa.py``'s sharded part): the table is built shard by shard, Adam
runs autograd through the shard exchanges, and the final measurement keeps
every shard's top-k (exact) or the blocked sampler's draws (``shots``),
decoded on the host from the term data; the 2^n state never leaves the
shards, so ``optimal_state`` is None there, as in the reference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from queasars_tpu_torch.optim.gradient import Adam
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table_device, diagonal_terms
from queasars_tpu_torch.sim.qaoa import (
    qaoa_energies_batch,
    qaoa_state,
    sharded_qaoa_energies,
    sharded_qaoa_finalize,
)
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.utils import batch_invariant, prng
from queasars_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class QAOAConfiguration:
    """Hyperparameters of a QAOA solve.

    :param reps: circuit depth p (number of (cost, mixer) layer pairs)
    :param n_starts: independent random schedules optimized together; the
        best final energy wins
    :param maxiter: Adam iterations per start
    :param learning_rate / beta1 / beta2 / eps: Adam hyperparameters
    :param shots: if set, the final state is measured this many times and
        the lowest-energy sampled bitstring is reported; ``None`` keeps the
        exact distribution and reports the most probable bitstring
    :param seed: seeds the start schedules and the final measurement
    :param mesh / n_devices: amplitude sharding: a mesh whose devices all
        go on the amplitude axis, or ``n_devices`` > 1 of them
        (``amplitude_mesh``; CPU blocks when ``device`` is the CPU)
    :param eigenstate_top_k: the exact path reports this many
        highest-probability basis states
    :param device: where the solve runs (None = the CUDA device)
    """

    reps: int = 2
    n_starts: int = 8
    maxiter: int = 150
    learning_rate: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    shots: Optional[int] = None
    seed: int = 0
    mesh: Optional[object] = None
    n_devices: Optional[int] = None
    eigenstate_top_k: int = 64
    device: Optional[object] = None

    def __post_init__(self) -> None:
        if self.eigenstate_top_k < 1:
            raise ValueError("eigenstate_top_k must be positive!")
        if self.reps < 1:
            raise ValueError("QAOA needs at least one (cost, mixer) layer pair!")
        if self.n_starts < 1:
            raise ValueError("n_starts must be at least 1!")
        if self.maxiter < 0:
            raise ValueError("maxiter may not be negative!")
        if self.shots is not None and self.shots < 1:
            raise ValueError("shots, when given, must be positive!")


class QAOAResult:
    """Result of a QAOA solve (the reference's fields)."""

    def __init__(self) -> None:
        self.eigenvalue: Optional[float] = None
        self.best_bitstring: Optional[int] = None
        self.best_bitstring_energy: Optional[float] = None
        self.optimal_gammas: Optional[tuple[float, ...]] = None
        self.optimal_betas: Optional[tuple[float, ...]] = None
        self.eigenstate: Optional[dict[int, float]] = None
        """With ``shots`` the empirical shot histogram (sums to 1); on the
        exact path the ``eigenstate_top_k`` highest-probability basis
        states, which need not sum to 1."""
        self.start_energies: Optional[tuple[float, ...]] = None
        """Every start's FINAL energy (the reference's name)."""
        self.circuit_evaluations: Optional[int] = None
        self.optimal_state: Optional[np.ndarray] = None
        """The optimized state as stacked [2, 2^n] re/im planes, usable as
        the ``initial_state`` of the VQE solvers."""

    def __repr__(self) -> str:
        return (
            f"QAOAResult(eigenvalue={self.eigenvalue}, "
            f"best_bitstring={self.best_bitstring}, "
            f"best_bitstring_energy={self.best_bitstring_energy})"
        )


def start_schedules(seed: int, n_starts: int, reps: int, scale: torch.Tensor):
    """(gammas0, betas0 [n_starts, reps] float32, measurement key): the
    reference's draws.  ``scale`` is max(max|table|, 1e-6) as a float32
    tensor; gammas are uniforms in [0, 1) over it, betas uniforms in
    [0, pi/2), both as ``jax.random.uniform`` computes
    ``max(minval, u * (maxval - minval) + minval)``."""
    key_init, key_measure = prng.split(prng.PRNGKey(seed))
    key_g, key_b = prng.split(key_init)
    gammas0 = prng.uniform(key_g, (n_starts, reps)).to(scale.device) / scale
    betas0 = prng.uniform(key_b, (n_starts, reps), maxval=float(np.pi) / 2.0).to(scale.device)
    return gammas0, betas0, key_measure


def multi_start_adam(energies_batch, gammas0, betas0, config: QAOAConfiguration):
    """Adam over the [n_starts, 2p] packed (gammas | betas) schedules, with
    the reference's arithmetic (its decays are Python floats); returns
    (gammas, betas, final energies [n_starts]).  The starts are
    independent, so the gradient of their summed energies is the per-start
    gradient stack."""
    p = gammas0.shape[1]
    params = torch.cat([gammas0, betas0], dim=1)
    adam = Adam(params, config.learning_rate, config.beta1, config.beta2, config.eps,
                host_complements=True)
    for k in range(config.maxiter):
        leaf = params.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(energies_batch(leaf).sum(), leaf)
        params = params - adam.update(g, k)
    with torch.no_grad():
        energies = energies_batch(params)
    return params[:, :p], params[:, p:], energies


def _host_state_energies(coeffs, z_masks, states) -> np.ndarray:
    """Exact diagonal energies of a few basis states from the term data
    (float64 on the host; no 2^n table)."""
    states = np.asarray(states, dtype=np.uint64).reshape(-1, 1)
    masks = np.asarray(z_masks, dtype=np.uint64).reshape(1, -1)
    parity = (np.bitwise_count(states & masks) & 1).astype(np.float64)
    return (1.0 - 2.0 * parity) @ np.asarray(coeffs, dtype=np.float64)


class QAOAMinimumEigensolver:
    """Fixed-ansatz QAOA baseline over the problem encoders: any diagonal
    :class:`PauliSum`; a non-diagonal operator raises."""

    def __init__(self, configuration: QAOAConfiguration) -> None:
        self.configuration = configuration

    def _resolve_mesh(self):
        """The amplitude mesh (None: one device)."""
        from queasars_tpu_torch.parallel.amplitude import as_amplitude_mesh
        from queasars_tpu_torch.parallel.mesh import mesh_of

        config = self.configuration
        if config.mesh is not None:
            return as_amplitude_mesh(config.mesh)
        if config.n_devices is not None and config.n_devices > 1:
            return as_amplitude_mesh(mesh_of(config.n_devices, config.device))
        return None

    def compute_minimum_eigenvalue(self, operator: PauliSum) -> QAOAResult:
        config = self.configuration
        if not operator.is_diagonal:
            raise ValueError(
                "QAOA's cost layer requires a diagonal operator; use the VQE "
                "solvers for Hamiltonians with X/Y terms."
            )
        mesh = self._resolve_mesh()
        if mesh is not None:
            return self._solve_sharded(operator, mesh)
        n_qubits = operator.n_qubits
        device = resolve_device(config.device)
        p = config.reps
        table = diagonal_energy_table_device(operator, device=device)

        def energies_batch(params):
            return qaoa_energies_batch(table, params[:, :p], params[:, p:], n_qubits)

        scale = torch.clamp(table.abs().max(), min=1e-6)
        gammas0, betas0, key_measure = start_schedules(config.seed, config.n_starts, p, scale)
        gammas, betas, energies = multi_start_adam(energies_batch, gammas0, betas0, config)
        energies_host = energies.cpu().numpy()
        best = int(np.argmin(energies_host))

        result = QAOAResult()
        with torch.no_grad():
            final_state = qaoa_state(table, gammas[best:best + 1], betas[best:best + 1],
                                     n_qubits)[0]
        probs = final_state[0] * final_state[0] + final_state[1] * final_state[1]
        table_host = table.cpu().numpy().astype(np.float64)
        if config.shots is not None:
            samples = sample_indices(key_measure, probs, config.shots).cpu().numpy()
            hit = int(np.argmin(table_host[samples]))
            best_state = int(samples[hit])
            unique, counts = np.unique(samples, return_counts=True)
            distribution = {int(s): float(c) / config.shots for s, c in zip(unique, counts)}
        else:
            probs_host = probs.cpu().numpy().astype(np.float64)
            best_state = int(np.argmax(probs_host))
            top = np.argsort(probs_host)[::-1]
            top = top[probs_host[top] > 1e-9][: config.eigenstate_top_k]
            distribution = {int(s): float(probs_host[s]) for s in top}
        result.best_bitstring_energy = float(table_host[best_state])
        result.optimal_state = final_state.cpu().numpy()
        result.eigenvalue = float(energies_host[best])
        result.best_bitstring = best_state
        result.optimal_gammas = tuple(float(g) for g in gammas[best].cpu().numpy())
        result.optimal_betas = tuple(float(b) for b in betas[best].cpu().numpy())
        result.eigenstate = distribution
        result.start_energies = tuple(float(e) for e in energies_host)
        # 2 evaluations per Adam step (forward + backward) plus the final
        # forward, per start (the reference's ledger)
        result.circuit_evaluations = config.n_starts * (2 * config.maxiter + 1)
        logger.info(
            "QAOA p=%d: best of %d starts reached <H> = %.6f",
            config.reps, config.n_starts, result.eigenvalue,
        )
        return result

    def _solve_sharded(self, operator: PauliSum, mesh) -> QAOAResult:
        """The solve over an amplitude mesh (one process)."""
        from queasars_tpu_torch.sim.sharded_statevector import build_device_table

        config = self.configuration
        n_qubits = operator.n_qubits
        p = config.reps
        row = mesh.row(0, n_qubits)
        coeffs, z_masks = diagonal_terms(operator)
        tables = build_device_table(mesh, coeffs, z_masks, n_qubits).of(row)

        def energies_batch(params):
            return sharded_qaoa_energies(row, tables, params[:, :p], params[:, p:])

        scale = torch.stack([t.abs().max().to(row.home) for t in tables.values()]).max()
        scale = torch.clamp(scale, min=1e-6)
        gammas0, betas0, key_measure = start_schedules(config.seed, config.n_starts, p, scale)
        with batch_invariant.scope():
            gammas, betas, energies = multi_start_adam(energies_batch, gammas0, betas0, config)
            with torch.no_grad():
                top_i, top_p, samples = sharded_qaoa_finalize(
                    row, tables, gammas[int(torch.argmin(energies))],
                    betas[int(torch.argmin(energies))], key_measure,
                    config.shots if config.shots is not None else 0,
                    top_k=config.eigenstate_top_k,
                )
        energies_host = energies.detach().cpu().numpy()
        best = int(np.argmin(energies_host))
        top_i = top_i.cpu().numpy()
        top_p = top_p.cpu().numpy().astype(np.float64)
        if config.shots is not None:
            samples = samples.cpu().numpy()
            sampled = _host_state_energies(coeffs, z_masks, samples)
            best_state = int(samples[int(np.argmin(sampled))])
            unique, counts = np.unique(samples, return_counts=True)
            distribution = {int(s): float(c) / config.shots for s, c in zip(unique, counts)}
        else:
            best_state = int(top_i[int(np.argmax(top_p))])
            order = np.argsort(top_p)[::-1]
            order = order[top_p[order] > 1e-9]
            distribution = {int(top_i[i]): float(top_p[i]) for i in order}
        result = QAOAResult()
        result.best_bitstring_energy = float(
            _host_state_energies(coeffs, z_masks, np.asarray([best_state]))[0])
        result.optimal_state = None
        result.eigenvalue = float(energies_host[best])
        result.best_bitstring = best_state
        result.optimal_gammas = tuple(float(g) for g in gammas[best].detach().cpu().numpy())
        result.optimal_betas = tuple(float(b) for b in betas[best].detach().cpu().numpy())
        result.eigenstate = distribution
        result.start_energies = tuple(float(e) for e in energies_host)
        result.circuit_evaluations = config.n_starts * (2 * config.maxiter + 1)
        logger.info(
            "QAOA p=%d over %d amplitude shards: best of %d starts reached <H> = %.6f",
            config.reps, mesh.n_amp, config.n_starts, result.eigenvalue,
        )
        return result
