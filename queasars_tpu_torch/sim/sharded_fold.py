"""Kron-fold application for the amplitude-sharded engine.

Counterpart of ``queasars_tpu/sim/sharded_fold.py``.  The fold transform
(``sim/fold_pipeline.py``) reduces a circuit to L+1 tensor-product "kron
layers" and L controlled-diagonal phase passes, which run on a shard as:

- **folded qubits** (q < ``folded_bits``): inside every shard, one group
  product per group of up to 7 qubits (bits 0-6, then 7 up to
  ``folded_bits``).  The JAX package builds each group's Kronecker matrix
  [2^m, 2^m] from the per-qubit 2x2 factors (``_group_fold_dense``) for the
  TPU's matrix unit; the group kernel (``shard_kernels.group_product``,
  row S2) applies the factors themselves, qubit q0's first, as m pair
  updates in shared-memory tiles: m x 14 operations per amplitude instead
  of 2^m x 8, bound by the shard's bytes.  Each amplitude gets the same
  operations in the same order whatever the shard's length, so its value
  does not depend on the amplitude width (the JAX package's XLA products
  need ``Precision.HIGHEST`` and a padded row for the same reason); it
  differs from the dense product by float32 rounding;
- **high qubits** (q >= ``folded_bits``): one pair combine per qubit
  (``shard_kernels.pair_combine``, row S1), the partner in the shard or
  exchanged, the slot engine's expression;
- **phase passes**: ``shard_kernels.diag_phase`` (row S3), control and
  target bits read from the in-shard index or the cell id.

``folded_bits`` is a constant of the qubit count, never of the mesh:
``max(7, min(14, n - 3))`` folds every qubit that stays local up to 8
shards; a wider amplitude axis needs an explicit smaller value.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.parallel.amplitude import AmpRow
from queasars_tpu_torch.parallel.mesh import device_context
from queasars_tpu_torch.sim import shard_kernels
from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline
from queasars_tpu_torch.sim.sharded_statevector import start_states

LANE_BITS = 7


def default_folded_bits(n_qubits: int) -> int:
    """The factorization-independent fold boundary: every qubit local for
    amplitude widths up to 8, capped at two groups of 7."""
    return max(LANE_BITS, min(2 * LANE_BITS, n_qubits - 3))


def check_folded_bits(local_bits: int, folded_bits: int) -> None:
    """Raise unless every folded qubit is shard-local."""
    if folded_bits > local_bits:
        raise ValueError(
            f"folded_bits={folded_bits} exceeds the shard-local qubit count {local_bits} for "
            f"this mesh; pass a smaller folded_bits (trajectories then differ from the default "
            f"fold boundary)"
        )
    if folded_bits < LANE_BITS:
        raise ValueError("folded_bits must cover at least the 7 lane qubits")


def group_fold_dense(factors: torch.Tensor, q0: int, m: int):
    """([..., 2^m, 2^m] re, im) group matrices from per-qubit factors
    ``factors`` [..., n, 2 (re/im), 2, 2]: entry [i, j] is the product over
    the group's qubits jq of ``A_{q0+jq}[bit_jq(i), bit_jq(j)]``, multiplied
    in qubit order.  No path of the port applies it (the group kernel takes
    the factors); it is the dense yardstick of the tests and of the card
    check's library call."""
    size = 1 << m
    ids = torch.arange(size, device=factors.device)
    acc_re = acc_im = None
    for jq in range(m):
        f = factors[..., q0 + jq, :, :, :]
        bi = (ids[:, None] >> jq) & 1
        bj = (ids[None, :] >> jq) & 1
        f_re = f[..., 0, :, :][..., bi, bj]
        f_im = f[..., 1, :, :][..., bi, bj]
        if acc_re is None:
            acc_re, acc_im = f_re, f_im
        else:
            acc_re, acc_im = acc_re * f_re - acc_im * f_im, acc_re * f_im + acc_im * f_re
    return acc_re, acc_im


def factor_entries(factors: torch.Tensor) -> torch.Tensor:
    """[..., 8] pair-kernel entries (u00, u01, u10, u11 as re, im) of 2x2
    factors [..., 2 (re/im), 2, 2]."""
    re, im = factors[..., 0, :, :], factors[..., 1, :, :]
    parts = [re[..., 0, 0], im[..., 0, 0], re[..., 0, 1], im[..., 0, 1],
             re[..., 1, 0], im[..., 1, 0], re[..., 1, 1], im[..., 1, 1]]
    return torch.stack(parts, dim=-1)


class FoldOperands:
    """A block's fold pipeline on one device, in the kernels' layouts: per
    kron layer each group's factor entries [K, B, m, 8], the high qubits'
    entries [K, n_high, B, 8] and the phase slots [L, B, D]."""

    def __init__(self, gate_types, controls, angles, layer_mask, n_qubits, folded_bits, device):
        pipe = build_fold_pipeline(
            gate_types.to(device), controls.to(device), angles.to(device).float(),
            layer_mask.to(device), n_qubits,
        )
        factors = pipe.factors  # [B, K, n, 2, 2, 2]
        self.groups = [(0, LANE_BITS)]
        if folded_bits > LANE_BITS:
            self.groups.append((LANE_BITS, folded_bits - LANE_BITS))
        self.group_entries = [
            factor_entries(factors[:, :, q0:q0 + m]).transpose(0, 1).contiguous()
            for q0, m in self.groups
        ]
        self.entries = factor_entries(factors[:, :, folded_bits:]).permute(1, 2, 0, 3).contiguous()
        self.ctrl = pipe.diag_ctrl.transpose(0, 1).contiguous()
        self.tgt = pipe.diag_tgt.transpose(0, 1).contiguous()
        self.phase = pipe.diag_phase.transpose(0, 1).contiguous()
        self.n_kron = factors.shape[1]


def _kron_layer(row: AmpRow, states: dict, ops: dict, k: int, folded_bits: int) -> dict:
    lb = row.local_bits
    for a in row.cells:
        with device_context(row.devices[a]):
            for (q0, m), entries in zip(ops[a].groups, ops[a].group_entries):
                states[a] = shard_kernels.group_product(states[a], entries[k], lb, q0, m)
    for j, q in enumerate(range(folded_bits, row.n_qubits)):
        partners = None if q < lb else row.exchange(states, 1 << (q - lb))
        for a in row.cells:
            entries = ops[a].entries[k, j]
            rows = entries.shape[0]
            with device_context(row.devices[a]):
                states[a] = shard_kernels.pair_combine(
                    states[a], None if partners is None else partners[a], entries,
                    torch.full((rows,), -1, dtype=torch.int32, device=entries.device),
                    torch.ones(rows, dtype=torch.bool, device=entries.device), lb,
                    q if q < lb else -1, 0 if q < lb else row.cell_bit(a, q - lb),
                )
    return states


def simulate_local_folded(row: AmpRow, gate_types, controls, angles, layer_mask,
                          folded_bits: int, initial=None, initial_stack=None) -> dict:
    """Every individual's folded circuit on this process's shards of the
    row (genome tensors on any device; masked layers carry identity factors
    and no phase slot).

    :return: cell -> [B, 2, 2^local_bits]
    """
    check_folded_bits(row.local_bits, folded_bits)
    states = start_states(row, gate_types.shape[0], initial, initial_stack)
    by_device: dict = {}
    ops = {}
    for a in row.cells:
        device = row.devices[a]
        if device not in by_device:
            by_device[device] = FoldOperands(gate_types, controls, angles, layer_mask,
                                             row.n_qubits, folded_bits, device)
        ops[a] = by_device[device]
    n_kron = ops[row.cells[0]].n_kron
    for k in range(n_kron):
        states = _kron_layer(row, states, ops, k, folded_bits)
        if k < n_kron - 1:
            for a in row.cells:
                with device_context(row.devices[a]):
                    states[a] = shard_kernels.diag_phase(
                        states[a], ops[a].ctrl[k], ops[a].tgt[k], ops[a].phase[k],
                        row.local_bits, a,
                    )
    return states


def folded_population_energies(mesh, n_qubits: int, gate_types, controls, angles, layer_mask,
                               table, folded_bits=None, initial=None):
    """Exact energies [P] through the folded application over a mesh
    (``make_folded_population_energies_fn``): the population split over
    the rows, each state over the amplitude axis, the energies in the fixed
    tree against the sharded ``table``
    (``sharded_statevector.AmpSharded``); ``initial`` is a shared start
    state [2, 2^n]."""
    from queasars_tpu_torch.parallel.amplitude import as_pop_amp_mesh, run_rows
    from queasars_tpu_torch.sim.sharded_statevector import (
        _genome,
        blockwise_energy,
        place_sharded,
    )

    mesh = as_pop_amp_mesh(mesh)
    folded_bits = default_folded_bits(n_qubits) if folded_bits is None else folded_bits
    start = None if initial is None else place_sharded(mesh, initial, n_qubits)

    def fn(row, block, rep):
        states = simulate_local_folded(row, *block, folded_bits,
                                       None if start is None else start.of(row))
        return blockwise_energy(row, states, table)

    return run_rows(mesh, n_qubits, fn, _genome(gate_types, controls, angles, layer_mask))
