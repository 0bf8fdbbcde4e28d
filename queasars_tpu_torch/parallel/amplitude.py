"""(pop, amp) meshes and the amplitude axis's exchanges.

Counterpart of the mesh helpers of ``queasars_tpu/sim/sharded_evaluator.py``
(:119-175) and of the collectives the JAX package's ``shard_map`` bodies
name on the amplitude axis.  A :class:`PopAmpMesh` is a ``[pop][amp]`` grid
of ``torch.device`` s (a device may repeat, so four cells may share one card
or the CPU) and the process that owns each cell.  Each individual's 2^n
state is cut into ``n_amp`` contiguous shards of ``2^local_bits``
amplitudes, shard ``a`` on the row's cell ``a``; the population is cut into
``n_pop`` blocks, block ``p`` on row ``p``.

An :class:`AmpRow` is one row as this process runs it, holding its own
cells' shards in a dict ``cell -> tensor``:

- :meth:`AmpRow.exchange` is ``ppermute`` with partner ``a XOR mask``: a
  shard on the same device is handed over with no copy, one on another
  device of this process takes one ``.to()``, one owned by another process
  goes through host tensors on gloo (send and receive posted together);
  :func:`exchange` wraps it in an autograd function whose backward is the
  same exchange (the pairing is an involution), so QAOA's autograd runs
  through it;
- :meth:`AmpRow.gather` is ``all_gather`` of small per-cell tensors;
- :meth:`AmpRow.tree_sum` is the fixed-order reduction every energy takes:
  each shard's values summed in a binary tree of strided adds
  (:func:`tree_reduce_last`), then the shards' partials in the same tree in
  cell order.  Over contiguous power-of-two blocks that is the tree over the
  whole 2^n axis, so the sum does not depend on the amplitude width: it is
  never ``torch.sum``, whose order follows the shape.

:func:`run_rows` runs a function over the population rows of this process,
each inside ``utils/batch_invariant.scope`` as the population mesh's blocks
run, and all-gathers the rows' outputs across processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import lcm
from typing import Callable, Optional, Sequence

import torch

from queasars_tpu_torch.parallel.mesh import (
    POPULATION_PAD,
    PopulationMesh,
    _gloo_group,
    _population,
    pad_population_axis,
    population_mesh,
)
from queasars_tpu_torch.parallel.multihost import is_multihost, process_info
from queasars_tpu_torch.utils import batch_invariant


@dataclass(frozen=True)
class PopAmpMesh:
    """A ``[pop][amp]`` grid of devices and the process owning each cell."""

    devices: tuple[tuple[torch.device, ...], ...]
    ranks: tuple[tuple[int, ...], ...]

    @property
    def n_pop(self) -> int:
        return len(self.devices)

    @property
    def n_amp(self) -> int:
        return len(self.devices[0])

    @property
    def size(self) -> int:
        return self.n_pop * self.n_amp

    def flat(self) -> tuple[list[torch.device], list[int]]:
        return ([d for row in self.devices for d in row], [r for row in self.ranks for r in row])

    def local_rows(self) -> list[int]:
        """The rows in which this process owns a cell."""
        rank = process_info()[0]
        return [p for p, owners in enumerate(self.ranks) if rank in owners]

    def row(self, p: int, n_qubits: int) -> "AmpRow":
        return AmpRow(self.devices[p], self.ranks[p], n_qubits)


def _grid(devices: Sequence, ranks: Sequence, n_amp: int) -> PopAmpMesh:
    if n_amp < 1 or len(devices) % n_amp:
        raise ValueError(f"amp_devices={n_amp} must divide the device count {len(devices)}")
    rows = range(0, len(devices), n_amp)
    return PopAmpMesh(tuple(tuple(devices[i:i + n_amp]) for i in rows),
                      tuple(tuple(ranks[i:i + n_amp]) for i in rows))


def amplitude_mesh(n_devices: Optional[int] = None, devices=None) -> PopAmpMesh:
    """A 1-D mesh over the amplitude axis (one population row):
    :func:`~queasars_tpu_torch.parallel.mesh.population_mesh`'s devices."""
    mesh = population_mesh(n_devices, devices)
    return _grid(mesh.devices, mesh.ranks, mesh.size)


def pop_amp_mesh(n_pop: int, n_amp: int, devices=None) -> PopAmpMesh:
    """A ``(pop, amp)`` mesh: ``n_pop`` population rows, each holding one
    amplitude-sharded copy of the statevector over ``n_amp`` cells;
    neighbouring devices of the list land on one row."""
    mesh = population_mesh(n_pop * n_amp if devices is None else None, devices)
    if mesh.size != n_pop * n_amp:
        raise ValueError(f"need {n_pop * n_amp} devices, got {mesh.size}")
    return _grid(mesh.devices, mesh.ranks, n_amp)


def as_amplitude_mesh(mesh) -> PopAmpMesh:
    """Any mesh as one row of all its devices."""
    if isinstance(mesh, PopAmpMesh):
        devices, ranks = mesh.flat()
    else:
        devices, ranks = list(mesh.devices), list(mesh.ranks)
    return _grid(devices, ranks, len(devices))


def as_pop_amp_mesh(mesh, amp_devices: Optional[int] = None) -> PopAmpMesh:
    """Coerce a mesh to the ``(pop, amp)`` form: a :class:`PopAmpMesh`
    passes through (``amp_devices`` must agree with it); a population mesh
    is refactored, all its devices on the amplitude axis
    (``amp_devices=None``) or ``(total // amp_devices, amp_devices)``."""
    if isinstance(mesh, PopAmpMesh):
        if amp_devices is not None and mesh.n_amp != amp_devices:
            raise ValueError(
                f"mesh already factors the amp axis as {mesh.n_amp}, conflicting with "
                f"amp_devices={amp_devices}"
            )
        return mesh
    if not isinstance(mesh, PopulationMesh):
        raise TypeError(f"not a mesh: {type(mesh)!r}")
    amp = mesh.size if amp_devices is None else int(amp_devices)
    return _grid(mesh.devices, mesh.ranks, amp)


def tree_reduce_last(x: torch.Tensor) -> torch.Tensor:
    """Sum the power-of-two last axis in a fixed binary tree of strided
    adds: the value depends only on the elements, never on the shape."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


#: bytes of the shards :meth:`AmpRow.exchange` handed to a partner cell:
#: on its device with no copy ("handed"), copied to another device of the
#: process ("copied") and sent to another process ("sent")
exchange_bytes = {"handed": 0, "copied": 0, "sent": 0}


def reset_exchange_bytes() -> None:
    for key in exchange_bytes:
        exchange_bytes[key] = 0


class AmpRow:
    """One population row of a mesh as this process runs it: the row's
    devices and owners, the shard geometry of an ``n_qubits`` state, and
    the cells this process holds."""

    def __init__(self, devices: Sequence[torch.device], ranks: Sequence[int], n_qubits: int):
        self.devices = tuple(devices)
        self.ranks = tuple(ranks)
        self.n_amp = len(self.devices)
        self.device_bits = self.n_amp.bit_length() - 1
        if 1 << self.device_bits != self.n_amp:
            raise ValueError("the amplitude axis must hold a power of two of devices")
        self.n_qubits = n_qubits
        self.local_bits = n_qubits - self.device_bits
        if self.local_bits < 1:
            raise ValueError("state too small for this many amplitude shards")
        self.rank = process_info()[0]
        self.cells = [a for a in range(self.n_amp) if self.ranks[a] == self.rank]
        self.home = self.devices[self.cells[0]]

    @property
    def shard_len(self) -> int:
        return 1 << self.local_bits

    def cell_bit(self, cell: int, bit: int) -> int:
        """Bit ``bit`` of the cell id (a global amplitude bit)."""
        return (cell >> bit) & 1

    def _p2p(self, sends: list, receives: list) -> None:
        """Post every (tensor, peer rank, tag) send and receive on gloo
        together and wait for all."""
        ops = [torch.distributed.P2POp(torch.distributed.isend, t, peer, _gloo_group(), tag)
               for t, peer, tag in sends]
        ops += [torch.distributed.P2POp(torch.distributed.irecv, t, peer, _gloo_group(), tag)
                for t, peer, tag in receives]
        if ops:
            for request in torch.distributed.batch_isend_irecv(ops):
                request.wait()

    def exchange(self, shards: dict, mask: int) -> dict:
        """``partner[a] = shards[a ^ mask]`` on cell ``a``'s device, for
        this process's cells (no copy on the same device)."""
        partners, sends, receives = {}, [], []
        for a in self.cells:
            b = a ^ mask
            size = shards[a].numel() * shards[a].element_size()
            if self.ranks[b] == self.rank:
                same = shards[b].device == torch.device(self.devices[a])
                exchange_bytes["handed" if same else "copied"] += size
                partners[a] = shards[b] if same else shards[b].to(self.devices[a])
                continue
            exchange_bytes["sent"] += size
            sends.append((shards[a].detach().cpu().contiguous(), self.ranks[b], a))
            buffer = torch.empty(shards[a].shape, dtype=shards[a].dtype)
            receives.append((buffer, self.ranks[b], b))
            partners[a] = buffer
        self._p2p(sends, receives)
        return {a: p.to(self.devices[a]) for a, p in partners.items()}

    def gather(self, values: dict) -> list:
        """Every cell's value (this process's and the others' in the row),
        in cell order, on the row's home device."""
        remote = sorted({r for r in self.ranks if r != self.rank})
        sends = [(values[a].detach().cpu().contiguous(), peer, a)
                 for a in self.cells for peer in remote]
        like = values[self.cells[0]]
        buffers = {b: torch.empty(like.shape, dtype=like.dtype)
                   for b in range(self.n_amp) if self.ranks[b] != self.rank}
        self._p2p(sends, [(buffers[b], self.ranks[b], b) for b in buffers])
        return [(values[a] if a in values else buffers[a]).to(self.home)
                for a in range(self.n_amp)]

    def tree_sum(self, values: dict) -> torch.Tensor:
        """The global sum over the last (amplitude) axis of the cells'
        ``values`` [..., 2^local_bits]: the fixed tree over each shard, then
        over the shards in cell order; on the home device."""
        partials = {a: tree_reduce_last(v) for a, v in values.items()}
        return tree_reduce_last(torch.stack(self.gather(partials), dim=-1))

    def split(self, full: torch.Tensor) -> dict:
        """This process's shards of ``full`` [..., 2^n] (last axis), each on
        its cell's device."""
        n = self.shard_len
        return {a: full[..., a * n:(a + 1) * n].contiguous().to(self.devices[a])
                for a in self.cells}


class _Exchange(torch.autograd.Function):
    """``AmpRow.exchange`` under autograd: the pairing is an involution, so
    the gradient of a partner goes back by the same exchange."""

    @staticmethod
    def forward(ctx, row, mask, cells, *tensors):
        ctx.row, ctx.mask, ctx.cells = row, mask, cells
        partners = row.exchange(dict(zip(cells, tensors)), mask)
        return tuple(partners[a].view_as(partners[a]) for a in cells)

    @staticmethod
    def backward(ctx, *grads):
        back = ctx.row.exchange(dict(zip(ctx.cells, grads)), ctx.mask)
        return (None, None, None, *(back[a] for a in ctx.cells))


def exchange(row: AmpRow, shards: dict, mask: int) -> dict:
    """:meth:`AmpRow.exchange`, differentiable."""
    cells = list(row.cells)
    out = _Exchange.apply(row, mask, cells, *(shards[a] for a in cells))
    return dict(zip(cells, out))


def pad_multiple(mesh: PopAmpMesh) -> int:
    """The evaluator's population pad: ``lcm(n_pop, POPULATION_PAD)``
    (``queasars_tpu/sim/sharded_evaluator.py:260``)."""
    return lcm(mesh.n_pop, POPULATION_PAD)


def run_rows(mesh: PopAmpMesh, n_qubits: int, fn: Callable, pop_args: tuple, rep_args=()):
    """Run ``fn(row, block, rep_args)`` for every population row of this
    process and join the rows' outputs.

    The population operands (axis 0, None entries pass through) are padded
    to :func:`pad_multiple` and cut into ``n_pop`` blocks; ``fn`` gets the
    row (:class:`AmpRow`) and its block (on the CPU) and returns a tensor
    or a tuple of tensors with the block's individuals on axis 0, equal on
    every cell of the row.  Each row runs inside
    ``utils/batch_invariant.scope``.  Under several processes the rows'
    outputs are all-gathered, so every process holds the whole population.

    :return: the outputs on the CPU, padding cut off
    """
    pop = _population(pop_args)
    multiple = pad_multiple(mesh)
    padded = tuple(None if a is None else pad_population_axis(torch.as_tensor(a), multiple)
                   for a in pop_args)
    width = _population(padded) // mesh.n_pop
    results = {}
    for p in mesh.local_rows():
        block = tuple(None if t is None else t[p * width:(p + 1) * width] for t in padded)
        with batch_invariant.scope():
            out = fn(mesh.row(p, n_qubits), block, rep_args)
        out = out if isinstance(out, tuple) else (out,)
        results[p] = tuple(o.detach().cpu() for o in out)
    if is_multihost():
        gathered: list = [None] * process_info()[1]
        torch.distributed.all_gather_object(gathered, results, group=_gloo_group())
        for per_rank in gathered:
            for p, out in per_rank.items():
                results.setdefault(p, out)
    joined = tuple(torch.cat([results[p][i] for p in range(mesh.n_pop)])[:pop]
                   for i in range(len(results[0])))
    return joined if len(joined) > 1 else joined[0]
