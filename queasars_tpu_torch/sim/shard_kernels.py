"""The amplitude-shard kernels: CUDA on the card, plain PyTorch on the CPU.

The JAX package runs its amplitude-sharded engine
(``queasars_tpu/sim/sharded_statevector.py``, ``sharded_fold.py``) as XLA
code under ``shard_map``; it has no Pallas kernel.  These four wrappers are
the port's kernels for the engine's per-shard passes
(``csrc/shard_kernels.cu``; its header gives each one's design and bound):

================================  ==========================================
wrapper                           pass (queasars_tpu/sim/...)
================================  ==========================================
:func:`pair_combine`              one slot or fold factor on one target,
                                  partner in the shard or exchanged
                                  (``sharded_statevector.py:87-139``,
                                  ``sharded_fold.py:144-163``)
:func:`group_product`             a group's per-qubit fold factors on m
                                  qubits, factor by factor (the Kronecker
                                  matrix of ``sharded_fold.py:105-142``)
:func:`diag_phase`                a kron layer's controlled phases
                                  (``sharded_fold.py:167-202``)
:func:`running_sum`               the blocked sampler's block CDFs and
                                  offsets (``sharded_statevector.py:238-240``)
================================  ==========================================

A shard batch is [B, 2, 2^local_bits] (re, im planes per row).  Each
wrapper takes its plain version (``*_plain``, beside it) only because the
tensors it was given lie on the CPU; on CUDA tensors it launches the kernel
or raises.  The kernels round every product and sum on its own, in the
plain versions' order, so kernel and plain version agree bit for bit, and
an amplitude's value never depends on the shard's length -- the engine's
promise of equal bits across (pop, amp) factorizations.  All four are
bound by bytes on the card: the group product applies its m factors as m
pair updates in shared-memory tiles (the shard read once and written once,
no dense 2^m x 2^m matrix), the running sum scans a warp's 1024 values in
registers and moves chunk totals between lanes by shuffles.
``launch_counts`` counts launches, one per wrapper call that launched.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.sim.sampling import running_sum as running_sum_plain
from queasars_tpu_torch.utils import cuda_lib
from queasars_tpu_torch.utils.cuda_lib import expect, on_cuda, ptr, stream

launch_counts: dict[str, int] = {
    "shard_pair_combine": 0,
    "shard_group_product": 0,
    "shard_diag_phase": 0,
    "shard_running_sum": 0,
}

#: the running-sum kernel's longest segment (its levels: chunks of 16, 16
#: chunk totals, at most 16 of those totals' totals)
RUNNING_SUM_MAX = 4096
#: the group kernel's widest group (tile bits 0-4 and the group in 2^13)
GROUP_MAX = 7


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _expect_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels read and write 16 bytes a thread."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _shard_shape(state: torch.Tensor, local_bits: int) -> int:
    rows = state.shape[0]
    expect(state, "state", torch.float32, (rows, 2, 1 << local_bits))
    return rows


# ---------------------------------------------------------------------------
# pair_combine
# ---------------------------------------------------------------------------


def pair_combine_plain(state, partner, entries, ctrl_bit, enabled, local_bits, target, side):
    """Plain version of :func:`pair_combine`: ``_partner_combine``'s
    expression, ``a_re re - a_im im + b_re p_re - b_im p_im`` and ``a_re im +
    a_im re + b_re p_im + b_im p_re`` evaluated left to right."""
    rows, _, length = state.shape
    idx = torch.arange(length, device=state.device)
    re, im = state[:, 0], state[:, 1]
    if target >= 0:
        flipped = state.view(rows, 2, length >> (target + 1), 2, 1 << target).flip(3)
        flipped = flipped.reshape(rows, 2, length)
        p_re, p_im = flipped[:, 0], flipped[:, 1]
        bit = ((idx >> target) & 1).bool()[None, :]
    else:
        p_re, p_im = partner[:, 0], partner[:, 1]
        bit = torch.full((1, length), bool(side), device=state.device)

    def entry(upper: int, lower: int) -> torch.Tensor:
        return torch.where(bit, entries[:, lower, None], entries[:, upper, None])

    a_re, a_im, b_re, b_im = entry(0, 6), entry(1, 7), entry(2, 4), entry(3, 5)
    new_re = a_re * re - a_im * im + b_re * p_re - b_im * p_im
    new_im = a_re * im + a_im * re + b_re * p_im + b_im * p_re
    control = ctrl_bit.long()
    ctrl_on = ((idx[None, :] >> control.clamp(min=0)[:, None]) & 1) == 1
    active = enabled.bool()[:, None] & ((control < 0)[:, None] | ctrl_on)
    return torch.stack([torch.where(active, new_re, re), torch.where(active, new_im, im)], dim=1)


def pair_combine(state, partner, entries, ctrl_bit, enabled, local_bits: int, target: int,
                 side: int = 0):
    """One 2x2 on one target qubit of every shard row: [B, 2, 2^local_bits].

    :param partner: the exchanged partner shard [B, 2, 2^local_bits] of a
        global target (``target`` = -1, the row's side bit ``side``), or
        None for a local target (the partner amplitude is ``i ^ 2^target``)
    :param entries: [B, 8] float32: u00, u01, u10, u11 as (re, im) pairs
    :param ctrl_bit: [B] int32, a local control bit (-1: none)
    :param enabled: [B] bool; a row that is off is copied unchanged
    """
    if not on_cuda(state, entries, ctrl_bit, enabled, partner):
        return pair_combine_plain(state, partner, entries, ctrl_bit, enabled, local_bits,
                                  target, side)
    rows = _shard_shape(state, local_bits)
    if (partner is None) != (target >= 0) or not -1 <= target < local_bits:
        raise ValueError("a local target takes no partner, a global one (-1) needs one")
    if partner is not None:
        expect(partner, "partner", torch.float32, tuple(state.shape))
    expect(entries, "entries", torch.float32, (rows, 8))
    expect(ctrl_bit, "ctrl_bit", torch.int32, (rows,))
    expect(enabled, "enabled", torch.bool, (rows,))
    out = torch.empty_like(state)
    status = cuda_lib.load().qt_shard_pair_combine(
        out.data_ptr(), state.data_ptr(), ptr(partner), entries.data_ptr(),
        ctrl_bit.data_ptr(), enabled.data_ptr(), rows, local_bits, target, int(side), stream(),
    )
    cuda_lib.check(status, "qt_shard_pair_combine")
    launch_counts["shard_pair_combine"] += 1
    return out


# ---------------------------------------------------------------------------
# group_product
# ---------------------------------------------------------------------------


def group_product_plain(state, entries, local_bits, q0, m):
    """Plain version of :func:`group_product`: qubit q0's factor, then q0 +
    1's and so on, each as :func:`pair_combine_plain` on a local target with
    no control."""
    rows = state.shape[0]
    ctrl = torch.full((rows,), -1, dtype=torch.int32, device=state.device)
    enabled = torch.ones(rows, dtype=torch.bool, device=state.device)
    for j in range(m):
        state = pair_combine_plain(state, None, entries[:, j], ctrl, enabled, local_bits,
                                   q0 + j, 0)
    return state


def group_product(state, entries, local_bits: int, q0: int, m: int):
    """The per-qubit 2x2 factors of qubits [q0, q0 + m) on every shard row,
    qubit q0's first: their Kronecker product applied factor by factor.

    :param entries: [B, m, 8] float32, qubit q0 + j's factor at j as u00,
        u01, u10, u11 (re, im) pairs (``sharded_fold.factor_entries``)
    """
    if not on_cuda(state, entries):
        return group_product_plain(state, entries, local_bits, q0, m)
    rows = _shard_shape(state, local_bits)
    if not (1 <= m <= GROUP_MAX and 0 <= q0 and q0 + m <= local_bits and 5 <= local_bits <= 30):
        raise ValueError(f"the group kernel takes 1 <= m <= {GROUP_MAX} qubits inside a shard "
                         f"of 2^5 to 2^30 amplitudes")
    expect(entries, "entries", torch.float32, (rows, m, 8))
    _expect_aligned(state, "state")
    out = torch.empty_like(state)
    status = cuda_lib.load().qt_shard_group_product(
        out.data_ptr(), state.data_ptr(), entries.data_ptr(), rows, local_bits, q0, m, stream(),
    )
    cuda_lib.check(status, "qt_shard_group_product")
    launch_counts["shard_group_product"] += 1
    return out


# ---------------------------------------------------------------------------
# diag_phase
# ---------------------------------------------------------------------------


def _amp_bit(q, idx, local_bits: int, cell: int):
    """[B, len] bit ``q`` [B] of each global amplitude index: the in-shard
    index's for a local q, the cell id's for a global one."""
    qc = q.long().clamp(min=0)
    local = (idx[None, :] >> qc.clamp(max=local_bits - 1)[:, None]) & 1
    cell_bit = (torch.full_like(qc, cell) >> (qc - local_bits).clamp(min=0)) & 1
    return torch.where((qc < local_bits)[:, None], local, cell_bit[:, None])


def diag_phase_plain(state, ctrl, tgt, phase, local_bits, cell):
    """Plain version of :func:`diag_phase`."""
    idx = torch.arange(state.shape[2], device=state.device)
    re, im = state[:, 0], state[:, 1]
    for j in range(ctrl.shape[1]):
        active = (ctrl[:, j] >= 0)[:, None] & (_amp_bit(ctrl[:, j], idx, local_bits, cell) == 1)
        tbit = _amp_bit(tgt[:, j], idx, local_bits, cell) == 1
        p_re = torch.where(tbit, phase[:, j, 1, 0, None], phase[:, j, 0, 0, None])
        p_im = torch.where(tbit, phase[:, j, 1, 1, None], phase[:, j, 0, 1, None])
        new_re = p_re * re - p_im * im
        new_im = p_re * im + p_im * re
        re, im = torch.where(active, new_re, re), torch.where(active, new_im, im)
    return torch.stack([re, im], dim=1)


def diag_phase(state, ctrl, tgt, phase, local_bits: int, cell: int):
    """One kron layer's controlled-diagonal phase slots on every shard row,
    in slot order; on the card in place (the result is ``state``).

    :param ctrl, tgt: [B, D] int32 qubits (control -1: unused slot)
    :param phase: [B, D, 2, 2] float32, by the target's bit then (re, im)
    :param cell: the shard's index on the amplitude axis (its global bits)
    """
    if not on_cuda(state, ctrl, tgt, phase):
        return diag_phase_plain(state, ctrl, tgt, phase, local_bits, cell)
    rows = _shard_shape(state, local_bits)
    slots = ctrl.shape[1]
    expect(ctrl, "ctrl", torch.int32, (rows, slots))
    expect(tgt, "tgt", torch.int32, (rows, slots))
    expect(phase, "phase", torch.float32, (rows, slots, 2, 2))
    status = cuda_lib.load().qt_shard_diag_phase(
        state.data_ptr(), ctrl.data_ptr(), tgt.data_ptr(), phase.data_ptr(), rows, local_bits,
        slots, int(cell), stream(),
    )
    cuda_lib.check(status, "qt_shard_diag_phase")
    launch_counts["shard_diag_phase"] += 1
    return state


# ---------------------------------------------------------------------------
# running_sum
# ---------------------------------------------------------------------------


def running_sum(values, seg_len: int):
    """Inclusive running sums of consecutive segments of ``seg_len`` values
    along the last axis of ``values`` [..., S * seg_len], in XLA's CPU
    order for a cumsum (``sim/sampling.py::running_sum``)."""
    shape = values.shape
    if not on_cuda(values):
        return running_sum_plain(values.reshape(-1, seg_len)).reshape(shape)
    if not 1 <= seg_len <= RUNNING_SUM_MAX or seg_len & (seg_len - 1):
        raise ValueError(f"segments must hold a power of two up to {RUNNING_SUM_MAX} values")
    if values.dtype != torch.float32 or not values.is_contiguous():
        raise ValueError("values must be contiguous float32")
    if values.numel() % seg_len:
        raise ValueError(f"{values.numel()} values do not make whole segments of {seg_len}")
    _expect_aligned(values, "values")
    out = torch.empty_like(values)
    status = cuda_lib.load().qt_shard_running_sum(
        out.data_ptr(), values.data_ptr(), values.numel(), seg_len, stream(),
    )
    cuda_lib.check(status, "qt_shard_running_sum")
    launch_counts["shard_running_sum"] += 1
    return out
