"""Amplitude-sharded statevector engine: one state across many devices.

Counterpart of ``queasars_tpu/sim/sharded_statevector.py``.  Each state's
2^n amplitudes are cut into contiguous shards over the amplitude axis of a
(pop, amp) mesh (``parallel/amplitude.py``), shard ``a`` holding the global
indices ``(a << local_bits) | i``.  Gates lower to:

- **local qubits** (q < local_bits): work inside the shard.  A layer's
  local slots run as one launch of the slot engine's states kernel
  (``slot_kernels.population_states``, row 2) on the shard, with a
  sub-genome of the shard's qubits: a CU3 whose control is global becomes,
  per shard, a U3 or nothing by the cell's bit (``_control_active``);
- **global qubits** (q >= local_bits): the pair partner lives on cell
  ``a XOR 2^(q - local_bits)``: one shard exchange, then one
  ``shard_kernels.pair_combine`` launch (row S1) with the cell's side bit.

A layer applies its local slots before its global ones, the order the
reference's slot loop has, since local qubits are the low ones.  The slot
engine's states equal the plain engine's bits, its pair expression is the
exchange path's (``_partner_combine``), and every reduction runs the fixed
tree of ``AmpRow.tree_sum``, so energies are bit-identical across every
(pop, amp) factorization of a mesh.

Shot sampling draws through a blocked inverse CDF over fixed global-index
blocks (:func:`blocked_shot_positions`), whose running sums are the
``shard_kernels.running_sum`` kernel's (row S4), in XLA's CPU order for a
cumsum; the draws are the JAX package's on the CPU and width-invariant.

Per-row functions take an :class:`~queasars_tpu_torch.parallel.amplitude.AmpRow`
and keep a state as a dict ``cell -> [B, 2, 2^local_bits]`` of this
process's shards; the ``sharded_*`` entry points run them over a mesh and
return global arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from queasars_tpu_torch.parallel.amplitude import (
    AmpRow,
    PopAmpMesh,
    as_pop_amp_mesh,
    run_rows,
)
from queasars_tpu_torch.parallel.mesh import device_context
from queasars_tpu_torch.sim import shard_kernels, slot_kernels
from queasars_tpu_torch.sim.expectation import _parity
from queasars_tpu_torch.sim.statevector import GATE_CROT, GATE_ID, GATE_ROT, u3_entries
from queasars_tpu_torch.utils import prng

#: fixed global-index block count of the distributed shot sampler
SAMPLE_BLOCKS = 4096


def slot_entries(angles: torch.Tensor) -> torch.Tensor:
    """U3 entries [..., 8] (u00, u01, u10, u11 as re, im) of ``[..., 3]``
    angles, as the slot engine computes them."""
    pairs = u3_entries(angles)
    return torch.stack([part for pair in pairs for part in pair], dim=-1).contiguous()


def cell_bits(values: torch.Tensor, cell: int, local_bits: int) -> torch.Tensor:
    """The cell's bit at global qubit ``values`` (>= local_bits), as int."""
    shift = (values.long() - local_bits).clamp(min=0)
    return (torch.full_like(shift, cell) >> shift) & 1


def local_subgenome(gate_types, controls, local_bits: int, cell: int):
    """The shard's genome over its local qubits: the slots q < local_bits;
    a CU3 whose control is global becomes a U3 where the cell's bit is 1,
    an identity where it is 0 (``_control_active``)."""
    types = gate_types[..., :local_bits]
    ctrl = controls[..., :local_bits]
    global_ctrl = (types == GATE_CROT) & (ctrl >= local_bits)
    on = cell_bits(ctrl, cell, local_bits) == 1
    rot = torch.where(on, torch.full_like(types, GATE_ROT), torch.full_like(types, GATE_ID))
    types = torch.where(global_ctrl, rot, types)
    ctrl = torch.where(global_ctrl, torch.full_like(ctrl, -1), ctrl)
    return types.to(torch.int32).contiguous(), ctrl.to(torch.int32).contiguous()


def global_slot_operands(gate_types, controls, layer_mask, local_bits: int, cell: int):
    """(enabled [B, L, G] bool, ctrl_bit [B, L, G] int32) of the slots on
    the global qubits: a slot acts where it is a U3 or CU3 of a layer that
    is on and, for a CU3 with a global control, where the cell's bit is 1;
    a local control is the pair kernel's ``ctrl_bit``."""
    types = gate_types[..., local_bits:]
    ctrl = controls[..., local_bits:]
    crot = types == GATE_CROT
    enabled = ((types == GATE_ROT) | crot) & layer_mask[..., None].bool()
    global_ctrl = crot & (ctrl >= local_bits)
    enabled &= ~global_ctrl | (cell_bits(ctrl, cell, local_bits) == 1)
    ctrl_bit = torch.where(crot & (ctrl >= 0) & (ctrl < local_bits), ctrl,
                           torch.full_like(ctrl, -1))
    return enabled.contiguous(), ctrl_bit.to(torch.int32).contiguous()


def zero_states(row: AmpRow, rows: int) -> dict:
    """|0...0> shards: amplitude 1 at global index 0 (cell 0, index 0)."""
    states = {}
    for a in row.cells:
        state = torch.zeros((rows, 2, row.shard_len), dtype=torch.float32,
                            device=row.devices[a])
        if a == 0:
            state[:, 0, 0] = 1.0
        states[a] = state
    return states


def start_states(row: AmpRow, rows: int, initial=None, initial_stack=None) -> dict:
    """The shards the circuits start from: per-individual ``initial_stack``
    (cell -> [B, 2, len]), a shared ``initial`` (cell -> [2, len]) or
    |0...0>."""
    if initial_stack is not None:
        return {a: initial_stack[a].contiguous() for a in row.cells}
    if initial is not None:
        return {a: initial[a].to(row.devices[a]).expand(rows, *initial[a].shape).contiguous()
                for a in row.cells}
    return zero_states(row, rows)


def simulate_local(row: AmpRow, gate_types, controls, angles, layer_mask, initial=None,
                   initial_stack=None) -> dict:
    """Every individual's circuit on this process's shards of the row.

    ``gate_types``, ``controls`` [B, L, n] and ``layer_mask`` [B, L] lie on
    the CPU (the host decides which slots act, with no device round trip);
    ``angles`` [B, L, n, 3] on any device.  Per layer: one states-kernel
    launch over the local slots per shard (none where no local slot acts),
    then per global qubit with an acting slot one exchange and one pair
    kernel launch per shard.

    :return: cell -> [B, 2, 2^local_bits]
    """
    lb = row.local_bits
    rows, n_layers = gate_types.shape[0], gate_types.shape[1]
    gate_types = gate_types.to(torch.int32)
    controls = controls.to(torch.int32)
    mask = layer_mask.bool()
    states = start_states(row, rows, initial, initial_stack)
    acting = ((gate_types == GATE_ROT) | (gate_types == GATE_CROT)) & mask[..., None]
    local_on = acting[..., :lb].any(dim=2).any(dim=0).tolist()
    global_on = acting[..., lb:].any(dim=0).tolist()
    cells = {}
    for a in row.cells:
        device = row.devices[a]
        sub_types, sub_ctrl = local_subgenome(gate_types, controls, lb, a)
        enabled, ctrl_bit = global_slot_operands(gate_types, controls, mask, lb, a)
        ang = angles.to(device).float()
        cells[a] = dict(
            types=sub_types.to(device), ctrl=sub_ctrl.to(device), mask=mask.to(device),
            angles=ang, local_angles=ang[:, :, :lb].contiguous(),
            entries=slot_entries(ang[:, :, lb:]), enabled=enabled.to(device),
            ctrl_bit=ctrl_bit.to(device),
        )
    for layer in range(n_layers):
        if local_on[layer]:
            for a in row.cells:
                c = cells[a]
                with device_context(row.devices[a]):
                    states[a] = slot_kernels.population_states(
                        c["types"][:, layer:layer + 1].contiguous(),
                        c["ctrl"][:, layer:layer + 1].contiguous(),
                        c["local_angles"][:, layer:layer + 1].contiguous(),
                        c["mask"][:, layer:layer + 1].contiguous(), lb, initial=states[a],
                    )
        for g, on in enumerate(global_on[layer]):
            if not on:
                continue
            partners = row.exchange(states, 1 << g)
            for a in row.cells:
                c = cells[a]
                with device_context(row.devices[a]):
                    states[a] = shard_kernels.pair_combine(
                        states[a], partners[a], c["entries"][:, layer, g].contiguous(),
                        c["ctrl_bit"][:, layer, g].contiguous(),
                        c["enabled"][:, layer, g].contiguous(), lb, -1, row.cell_bit(a, g),
                    )
    return states


def shard_probs(states: dict) -> dict:
    return {a: s[:, 0] ** 2 + s[:, 1] ** 2 for a, s in states.items()}


def blockwise_energy(row: AmpRow, states: dict, table) -> torch.Tensor:
    """``sum_i p_i e_i`` [B] in the fixed tree (``_blockwise_energy``)."""
    probs = shard_probs(states)
    return row.tree_sum({a: p * table.on(a, p.device) for a, p in probs.items()})


# ---------------------------------------------------------------------------
# sharded operands: a table or start state cut over the amplitude axis
# ---------------------------------------------------------------------------


class AmpSharded:
    """An array cut over the amplitude axis (last axis): this process's
    shards by cell, each on the device it was made on; :meth:`on` copies a
    shard to another device once (rows of a 2-D mesh share the shards)."""

    def __init__(self, shards: dict, n_amp: int):
        self.shards = shards
        self.n_amp = n_amp
        self._copies: dict = {}

    def on(self, cell: int, device) -> torch.Tensor:
        shard = self.shards[cell]
        device = torch.device(device)
        if shard.device == device:
            return shard
        key = (cell, str(device))
        if key not in self._copies:
            self._copies[key] = shard.to(device)
        return self._copies[key]

    def of(self, row: AmpRow) -> dict:
        return {a: self.on(a, row.devices[a]) for a in row.cells}

    def full(self) -> torch.Tensor:
        """The whole array on the CPU (this process's shards only: tests)."""
        return torch.cat([self.shards[a].cpu() for a in sorted(self.shards)], dim=-1)


def _column_devices(mesh: PopAmpMesh) -> dict:
    """Per amplitude index, the device of this process's first cell of that
    column."""
    rank = mesh.ranks
    from queasars_tpu_torch.parallel.multihost import process_info

    me = process_info()[0]
    out = {}
    for p in range(mesh.n_pop):
        for a in range(mesh.n_amp):
            if rank[p][a] == me and a not in out:
                out[a] = mesh.devices[p][a]
    return out


def _local_indices(cell: int, local_bits: int, device) -> torch.Tensor:
    return torch.arange(1 << local_bits, dtype=torch.int64, device=device) | (cell << local_bits)


def _term_table(coeffs32: np.ndarray, masks: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """``acc + c_k (1 - 2 parity(z_k & i))`` over the terms in order."""
    table = torch.zeros(idx.shape[0], dtype=torch.float32, device=idx.device)
    coeffs_t = torch.as_tensor(coeffs32, device=idx.device)
    for k, z in enumerate(masks):
        parity = _parity(idx & int(z)).to(torch.float32)
        table = table + coeffs_t[k] * (1.0 - 2.0 * parity)
    return table


def build_device_table(mesh, coeffs, z_masks, n_qubits: int) -> AmpSharded:
    """The diagonal energy table [2^n] float32, each shard built on its own
    device from the O(K) term data: a scan over the terms in order per
    entry (no Walsh-Hadamard transform, which would mix shards), so the
    table is bit-identical for every factorization.

    :param coeffs: [K] real coefficients; :param z_masks: [K] Z bitmasks
    """
    if n_qubits > 32:
        raise NotImplementedError("device tables limited to n<=32 qubits")
    mesh = as_pop_amp_mesh(mesh)
    local_bits = AmpRow(mesh.devices[0], mesh.ranks[0], n_qubits).local_bits
    coeffs32 = np.asarray(coeffs, np.float32)
    masks = np.asarray(z_masks).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    shards = {a: _term_table(coeffs32, masks, _local_indices(a, local_bits, device))
              for a, device in _column_devices(mesh).items()}
    return AmpSharded(shards, mesh.n_amp)


def build_device_tables_batch(mesh, coeffs, z_masks, n_qubits: int) -> AmpSharded:
    """One table per QWC measurement group, [G, 2^n], shard-local from
    padded term data (zero coefficients are inert padding)."""
    if n_qubits > 32:
        raise NotImplementedError("device tables limited to n<=32 qubits")
    mesh = as_pop_amp_mesh(mesh)
    local_bits = AmpRow(mesh.devices[0], mesh.ranks[0], n_qubits).local_bits
    coeffs32 = np.asarray(coeffs, np.float32)
    masks = np.asarray(z_masks).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    shards = {}
    for a, device in _column_devices(mesh).items():
        idx = _local_indices(a, local_bits, device)
        shards[a] = torch.stack([_term_table(coeffs32[g], masks[g], idx)
                                 for g in range(coeffs32.shape[0])])
    return AmpSharded(shards, mesh.n_amp)


def place_sharded(mesh, full, n_qubits: int) -> AmpSharded:
    """A host array [..., 2^n] cut into this process's shards."""
    mesh = as_pop_amp_mesh(mesh)
    local_bits = AmpRow(mesh.devices[0], mesh.ranks[0], n_qubits).local_bits
    length = 1 << local_bits
    full = torch.as_tensor(np.asarray(full))
    return AmpSharded({a: full[..., a * length:(a + 1) * length].contiguous().to(device)
                       for a, device in _column_devices(mesh).items()}, mesh.n_amp)


# ---------------------------------------------------------------------------
# general (non-diagonal) Pauli sums
# ---------------------------------------------------------------------------


def group_general_terms(coeffs_re, coeffs_im, z_masks, x_masks, local_bits: int):
    """Split each term's X mask into (local, global) parts and give each
    term the index of its global-X group (first-appearance order).

    :return: (distinct global X values, term arrays: coeffs_re/im [K] f32,
        z_local/x_local [K] u32, z_global [K] u32 (cell-index mask),
        group_id [K] i32)
    """
    local_mask = np.uint64((1 << local_bits) - 1)
    z = np.asarray(z_masks).astype(np.uint64)
    x = np.asarray(x_masks).astype(np.uint64)
    x_local = (x & local_mask).astype(np.uint32)
    x_global = (x >> np.uint64(local_bits)).astype(np.uint32)
    z_local = (z & local_mask).astype(np.uint32)
    z_global = (z >> np.uint64(local_bits)).astype(np.uint32)
    xg_list: list[int] = []
    group_id = np.zeros(len(x_global), np.int32)
    for k, xg in enumerate(x_global):
        if int(xg) not in xg_list:
            xg_list.append(int(xg))
        group_id[k] = xg_list.index(int(xg))
    terms = dict(
        coeffs_re=np.asarray(coeffs_re, np.float32), coeffs_im=np.asarray(coeffs_im, np.float32),
        z_local=z_local, x_local=x_local, z_global=z_global, group_id=group_id,
    )
    return xg_list, terms


def general_energies(row: AmpRow, states: dict, xg_list, terms) -> torch.Tensor:
    """``<psi|H|psi>`` [B] of a general Pauli sum: one exchange per distinct
    global X mask, then a scan over the terms in their order,
    ``t_k = sum_i conj(psi_i) (-1)^{|z & i|} psi_{i^x}`` by the fixed tree,
    accumulated as ``acc + Re c_k t_k``."""
    partners = [states if xg == 0 else row.exchange(states, xg) for xg in xg_list]
    idx = {a: torch.arange(row.shard_len, dtype=torch.int64, device=row.devices[a])
           for a in row.cells}
    acc = torch.zeros(next(iter(states.values())).shape[0], dtype=torch.float32,
                      device=row.home)
    for k in range(len(terms["coeffs_re"])):
        zl, xl = int(terms["z_local"][k]), int(terms["x_local"][k])
        zg, g = int(terms["z_global"][k]), int(terms["group_id"][k])
        parts = {}
        for a in row.cells:
            sign_local = 1.0 - 2.0 * _parity(idx[a] & zl).to(torch.float32)
            sign_global = 1.0 - 2.0 * float(bin(a & zg).count("1") & 1)
            signs = sign_local * sign_global
            re, im = states[a][:, 0], states[a][:, 1]
            flipped = partners[g][a][:, :, idx[a] ^ xl]
            fr, fi = flipped[:, 0], flipped[:, 1]
            parts[a] = torch.stack([signs * (re * fr + im * fi), signs * (re * fi - im * fr)],
                                   dim=1)
        t = row.tree_sum(parts)
        cr = float(terms["coeffs_re"][k])
        ci = float(terms["coeffs_im"][k])
        acc = acc + cr * t[:, 0] - ci * t[:, 1]
    return acc


# ---------------------------------------------------------------------------
# distributed shot sampling
# ---------------------------------------------------------------------------


def blocked_shot_positions(row: AmpRow, local_probs: dict, keys, shots: int):
    """Width-invariant distributed inverse-CDF shot draws.

    The 2^n probabilities are cut into ``SAMPLE_BLOCKS`` fixed global-index
    blocks; each block's running sum and the running sum of the gathered
    block masses (the offsets) are the running-sum kernel's; a draw
    ``u = uniform(key, maxval=total)`` resolves by a right-hand search of
    the offsets, then in its block on the owning shard.

    :param local_probs: cell -> [B, 2^local_bits]
    :param keys: [B, 2] threefry keys, one per individual
    :return: (cell -> local index [B, shots] int64, cell -> owned [B,
        shots] bool): exactly one cell owns each shot
    """
    width = row.shard_len
    total_dim = width * row.n_amp
    n_blocks = max(row.n_amp, min(SAMPLE_BLOCKS, total_dim))
    block = total_dim // n_blocks
    blocks_local = width // block
    cdfs, masses = {}, {}
    for a, probs in local_probs.items():
        with device_context(row.devices[a]):
            cdf = shard_kernels.running_sum(probs.contiguous(), block)
        cdfs[a] = cdf.reshape(probs.shape[0], blocks_local, block)
        masses[a] = cdfs[a][..., -1]
    gathered = torch.cat(row.gather(masses), dim=-1).contiguous()  # [B, n_blocks]
    with device_context(row.home):
        running = shard_kernels.running_sum(gathered, n_blocks)
    offsets = torch.cat([torch.zeros_like(running[:, :1]), running], dim=-1)
    total = offsets[:, -1]
    u = prng.uniform(keys, (shots,), maxval=total)
    blk = torch.searchsorted(offsets[:, 1:].contiguous(), u.contiguous(), right=True)
    blk = blk.clamp(0, n_blocks - 1)
    v = u - torch.gather(offsets, 1, blk)
    positions, owned = {}, {}
    for a, cdf in cdfs.items():
        device = row.devices[a]
        blk_a, v_a = blk.to(device), v.to(device)
        owned[a] = (blk_a // blocks_local) == a
        local_blk = (blk_a - a * blocks_local).clamp(0, blocks_local - 1)
        rows_cdf = torch.gather(
            cdf, 1, local_blk[..., None].expand(-1, -1, block))  # [B, shots, block]
        pos = torch.searchsorted(rows_cdf.contiguous(), v_a[..., None].contiguous(), right=True)
        positions[a] = local_blk * block + pos[..., 0].clamp(0, block - 1)
    return positions, owned


def shot_values(row: AmpRow, positions: dict, owned: dict, tables: dict) -> torch.Tensor:
    """Each shot's value [B, shots] from the owning shard's ``tables``
    (cell -> [len] or [B, len]), summed over the cells (the others give
    exact zeros); on the home device."""
    parts = {}
    for a, pos in positions.items():
        table = tables[a]
        value = table[pos] if table.dim() == 1 else torch.gather(table, 1, pos)
        parts[a] = torch.where(owned[a], value, torch.zeros_like(value))
    gathered = row.gather(parts)
    out = gathered[0]
    for part in gathered[1:]:
        out = out + part
    return out


# ---------------------------------------------------------------------------
# entry points over a mesh (global arrays in and out, on the CPU)
# ---------------------------------------------------------------------------


def _genome(gate_types, controls, angles, layer_mask):
    return (torch.as_tensor(np.asarray(gate_types), dtype=torch.int32),
            torch.as_tensor(np.asarray(controls), dtype=torch.int32),
            torch.as_tensor(np.asarray(angles), dtype=torch.float32),
            torch.as_tensor(np.asarray(layer_mask), dtype=torch.bool))


def _gather_states(row: AmpRow, states: dict) -> torch.Tensor:
    return torch.cat(row.gather(states), dim=-1)


def sharded_circuit(mesh, n_qubits: int, gate_types, controls, angles, layer_mask):
    """One genome ([L, n] tensors) -> its state [2, 2^n] (gathered on the
    CPU), simulated amplitude-sharded over the mesh's first row
    (``make_sharded_circuit_fn``)."""
    mesh = as_pop_amp_mesh(mesh)
    row = mesh.row(0, n_qubits)
    gt, ctrl, ang, lm = _genome(gate_types, controls, angles, layer_mask)
    states = simulate_local(row, gt[None], ctrl[None], ang[None], lm[None])
    return _gather_states(row, states)[0].cpu()


def sharded_population_probs(mesh, n_qubits: int, gate_types, controls, angles, layer_mask,
                             initial=None):
    """Probabilities [P, 2^n] of a population, amplitudes sharded and the
    population split over the rows (``make_sharded_population_probs_fn``);
    ``initial`` is a shared start state [2, 2^n]."""
    mesh = as_pop_amp_mesh(mesh)
    start = None if initial is None else place_sharded(mesh, initial, n_qubits)

    def fn(row, block, rep):
        states = simulate_local(row, *block, initial=None if start is None else start.of(row))
        return torch.cat(row.gather(shard_probs(states)), dim=-1)

    return run_rows(mesh, n_qubits, fn, _genome(gate_types, controls, angles, layer_mask))


def sharded_population_energies(mesh, n_qubits: int, gate_types, controls, angles, layer_mask,
                                table: AmpSharded, initial=None):
    """Exact energies [P] against a sharded diagonal table
    (``make_sharded_population_energies_fn``) on the per-gate route."""
    mesh = as_pop_amp_mesh(mesh)
    start = None if initial is None else place_sharded(mesh, initial, n_qubits)

    def fn(row, block, rep):
        states = simulate_local(row, *block, initial=None if start is None else start.of(row))
        return blockwise_energy(row, states, table)

    return run_rows(mesh, n_qubits, fn, _genome(gate_types, controls, angles, layer_mask))


def sharded_expectation(mesh, state, table: AmpSharded) -> float:
    """<E> of one state [2, 2^n] against a sharded table, by the fixed
    tree over the mesh's first row."""
    mesh = as_pop_amp_mesh(mesh)
    n_qubits = int(np.log2(np.shape(state)[-1]))
    row = mesh.row(0, n_qubits)
    shards = row.split(torch.as_tensor(np.asarray(state), dtype=torch.float32)[None])
    return float(blockwise_energy(row, shards, table)[0])
