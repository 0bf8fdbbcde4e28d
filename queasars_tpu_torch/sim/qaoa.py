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
which the QAOA solver's multi-start Adam uses.

The amplitude-sharded part (:129-270) runs one state over the cells of an
amplitude mesh (``parallel/amplitude.py``): the cost phase is shard-local,
the RX mixer combines each amplitude with its partner, inside the shard or
through the differentiable exchange, and energies reduce in the fixed tree.
Autograd's own broadcast reductions would sum gamma's and beta's gradients
over each shard in an order that follows the shard's length, so the
schedule reaches the shards through :class:`_AmpBroadcast`, whose backward
sums every use's gradient in the same fixed tree: energies and gradients
are then bit-identical across amplitude widths.

Conventions: little-endian basis indices (bit ``q`` of the index = qubit
``q``), energies from the table the evaluators use.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.parallel.amplitude import AmpRow, exchange
from queasars_tpu_torch.sim.sharded_statevector import blocked_shot_positions


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


# --- amplitude-sharded QAOA -------------------------------------------------


class _AmpBroadcast(torch.autograd.Function):
    """``values`` [S] broadcast to ``uses`` tensors [S, len] per cell; the
    backward sums each use's gradient over the whole amplitude axis in the
    fixed tree (``AmpRow.tree_sum``), then the uses in order."""

    @staticmethod
    def forward(ctx, row, uses, values):
        ctx.row, ctx.uses = row, uses
        out = []
        for _ in range(uses):
            for a in row.cells:
                out.append(values.to(row.devices[a])[:, None].expand(-1, row.shard_len))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        row, cells = ctx.row, ctx.row.cells
        total = None
        for u in range(ctx.uses):
            part = row.tree_sum({a: grads[u * len(cells) + i] for i, a in enumerate(cells)})
            total = part if total is None else total + part
        return None, None, total


def _broadcast(row: AmpRow, values: torch.Tensor, uses: int) -> list:
    """Per use, cell -> ``values`` [S] expanded to [S, len]."""
    flat = _AmpBroadcast.apply(row, uses, values)
    width = len(row.cells)
    return [dict(zip(row.cells, flat[u * width:(u + 1) * width])) for u in range(uses)]


def _mixer_combine(state, partner, c, s):
    """``exp(-i beta X)`` pair update on [S, 2, len] planes from the partner
    amplitudes (side-independent: RX is symmetric)."""
    re, im = state[:, 0], state[:, 1]
    p_re, p_im = partner[:, 0], partner[:, 1]
    return torch.stack([c * re + s * p_im, c * im - s * p_re], dim=1)


def sharded_qaoa_state(row: AmpRow, tables: dict, gammas, betas) -> dict:
    """Per cell [S, 2, 2^local] planes of the schedules ``gammas`` /
    ``betas`` [S, p] (``_sharded_qaoa_state``)."""
    n, lb, length = row.n_qubits, row.local_bits, row.shard_len
    n_starts = gammas.shape[0]
    amp = 1.0 / torch.sqrt(torch.tensor(float(1 << n), dtype=torch.float32))
    state = {}
    for a in row.cells:
        plane = torch.zeros((n_starts, 2, length), dtype=torch.float32, device=row.devices[a])
        plane[:, 0] = amp.to(row.devices[a])
        state[a] = plane
    for layer in range(gammas.shape[1]):
        (gamma,) = _broadcast(row, gammas[:, layer], 1)
        cos_b, sin_b = torch.cos(betas[:, layer]), torch.sin(betas[:, layer])
        cbs, sbs = _broadcast(row, cos_b, n), _broadcast(row, sin_b, n)
        for a in row.cells:
            angle = gamma[a] * tables[a][None, :]
            c, s = torch.cos(angle), torch.sin(angle)
            re, im = state[a][:, 0], state[a][:, 1]
            state[a] = torch.stack([re * c + im * s, im * c - re * s], dim=1)
        for q in range(n):
            if q < lb:
                partners = {a: state[a].reshape(n_starts, 2, length >> (q + 1), 2, 1 << q)
                            .flip(3).reshape(n_starts, 2, length) for a in row.cells}
            else:
                partners = exchange(row, state, 1 << (q - lb))
            state = {a: _mixer_combine(state[a], partners[a], cbs[q][a], sbs[q][a])
                     for a in row.cells}
    return state


def sharded_qaoa_energies(row: AmpRow, tables: dict, gammas, betas) -> torch.Tensor:
    """Exact energies [S] over the row's shards, differentiable."""
    state = sharded_qaoa_state(row, tables, gammas, betas)
    return row.tree_sum({a: (s[:, 0] ** 2 + s[:, 1] ** 2) * tables[a][None, :]
                         for a, s in state.items()})


def sharded_qaoa_finalize(row: AmpRow, tables: dict, gammas, betas, key, shots: int,
                          top_k: int = 16):
    """The final measurement of ONE schedule ([p] each): every cell's top-k
    probabilities with their global indices, gathered in cell order, and
    with ``shots`` > 0 the blocked sampler's draws as global indices."""
    state = sharded_qaoa_state(row, tables, gammas[None], betas[None])
    probs = {a: (s[:, 0] ** 2 + s[:, 1] ** 2)[0] for a, s in state.items()}
    k = min(top_k, row.shard_len)
    top_p, top_i = {}, {}
    for a, p in probs.items():
        values, order = torch.sort(p, descending=True, stable=True)
        top_p[a] = values[:k]
        top_i[a] = order[:k] | (a << row.local_bits)
    all_p = torch.cat(row.gather(top_p))
    all_i = torch.cat(row.gather(top_i))
    samples = torch.zeros(0, dtype=torch.int64)
    if shots > 0:
        positions, owned = blocked_shot_positions(
            row, {a: p[None] for a, p in probs.items()}, key[None], shots)
        parts = {a: torch.where(owned[a], positions[a] | (a << row.local_bits),
                                torch.zeros_like(positions[a]))[0]
                 for a in positions}
        gathered = row.gather(parts)
        samples = gathered[0]
        for part in gathered[1:]:
            samples = samples + part
    return all_i, all_p, samples
