"""Exact QAOA simulation for diagonal cost Hamiltonians (PyTorch).

Counterpart of the single-device part of ``queasars_tpu/sim/qaoa.py``
(:36-127): QAOA (arXiv:1411.4028) alternates a cost phase separator
``exp(-i gamma H)`` with a transverse-field mixer ``exp(-i beta X)`` per
qubit.  For a diagonal ``H`` (every problem encoder here emits one) the cost
layer is an exact elementwise phase by the energy table, so the simulation
is elementwise arithmetic on stacked float32 re/im planes.

Schedules are batched: ``gammas`` and ``betas`` are [B, p] and the states
[B, 2, 2^n] (the reference vmaps one [p] schedule; here the batch is a
leading dimension).  Everything is differentiable with ``torch.autograd``,
which the QAOA solver's multi-start Adam uses.  The amplitude-sharded part
of the reference (:129-270) waits for the port's mesh.

Conventions: little-endian basis indices (bit ``q`` of the index = qubit
``q``), energies from the table the evaluators use.
"""

from __future__ import annotations

import torch


def plus_state_real(n_qubits: int, batch: int = 1, device="cpu") -> torch.Tensor:
    """|+>^n as stacked re/im planes [B, 2, 2^n] float32 (amplitude
    ``1 / sqrt(float32(2^n))`` as the reference rounds it)."""
    dim = 1 << n_qubits
    amp = 1.0 / torch.sqrt(torch.tensor(float(dim), dtype=torch.float32))
    state = torch.zeros((batch, 2, dim), dtype=torch.float32, device=device)
    state[:, 0] = amp.to(device)
    return state


def apply_cost_phase(state: torch.Tensor, table: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Elementwise ``exp(-i gamma E_z)`` on [B, 2, 2^n] planes, ``gamma`` [B]:
    ``(re + i im)(cos - i sin) = (re cos + im sin) + i (im cos - re sin)``."""
    angle = gamma[:, None] * table
    c, s = torch.cos(angle), torch.sin(angle)
    re, im = state[:, 0], state[:, 1]
    return torch.stack([re * c + im * s, im * c - re * s], dim=1)


def apply_mixer(state: torch.Tensor, beta: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """``exp(-i beta X_q)`` on every qubit, ``beta`` [B]: per qubit
    ``a' = cos(beta) a - i sin(beta) b`` and symmetrically for ``b``."""
    batch = state.shape[0]
    c = torch.cos(beta)[:, None, None]
    s = torch.sin(beta)[:, None, None]
    for q in range(n_qubits):
        shaped = state.reshape(batch, 2, -1, 2, 1 << q)
        re_a, im_a = shaped[:, 0, :, 0, :], shaped[:, 1, :, 0, :]
        re_b, im_b = shaped[:, 0, :, 1, :], shaped[:, 1, :, 1, :]
        re = torch.stack([c * re_a + s * im_b, s * im_a + c * re_b], dim=2)
        im = torch.stack([c * im_a - s * re_b, c * im_b - s * re_a], dim=2)
        state = torch.stack([re, im], dim=1).reshape(batch, 2, -1)
    return state


def qaoa_state(
    table: torch.Tensor, gammas: torch.Tensor, betas: torch.Tensor, n_qubits: int
) -> torch.Tensor:
    """Depth-p QAOA states [B, 2, 2^n] of schedules ``gammas`` / ``betas``
    [B, p] over the diagonal energy table [2^n]."""
    state = plus_state_real(n_qubits, gammas.shape[0], table.device)
    for layer in range(gammas.shape[1]):
        state = apply_cost_phase(state, table, gammas[:, layer])
        state = apply_mixer(state, betas[:, layer], n_qubits)
    return state


def qaoa_probabilities(table, gammas, betas, n_qubits: int) -> torch.Tensor:
    """Measurement probabilities [B, 2^n]."""
    state = qaoa_state(table, gammas, betas, n_qubits)
    return state[:, 0] * state[:, 0] + state[:, 1] * state[:, 1]


def qaoa_energies_batch(table, gammas, betas, n_qubits: int) -> torch.Tensor:
    """Exact expectations <psi(gamma, beta)|H|psi(gamma, beta)> [B]."""
    return (qaoa_probabilities(table, gammas, betas, n_qubits) * table).sum(dim=-1)


def qaoa_energy(table, gammas, betas, n_qubits: int) -> torch.Tensor:
    """The expectation of one schedule (``gammas`` / ``betas`` [p])."""
    return qaoa_energies_batch(table, gammas[None], betas[None], n_qubits)[0]
