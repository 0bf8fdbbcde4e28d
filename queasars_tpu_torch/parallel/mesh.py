"""Population-axis sharding over a list of devices.

Counterpart of ``queasars_tpu/parallel/mesh.py``, which replaces the
reference's dask task farming (mutation.py:206-218, selection.py:75-84:
submit/wait per individual) with data parallelism over the population
axis.  A :class:`PopulationMesh` is an ordered list of ``torch.device`` s,
one per block of the population; a device may repeat, so four blocks may
share one card (or the CPU, as the tests run it), the counterpart of the
JAX package's ``--xla_force_host_platform_device_count``.
:func:`run_population_sharded` pads the population to the mesh's pad
multiple, cuts it into contiguous blocks, copies each block's per-individual
operands to its device (the replicated ones once per distinct device),
runs the function there (under ``torch.cuda.device`` for a card, so the
kernels launch on that card's current stream) and concatenates the outputs
in block order, on the CPU.

Determinism: every per-individual computation (shot sampling too, whose
per-individual keys are split before the population is padded) is local to
its block, and the population is padded to ``max(lcm(D, POPULATION_PAD),
MIN_BLOCK * D)``, so a seeded solve gives the same trajectory bit for bit on
1, 2, 4 and 8 blocks.  That rests on each individual's arithmetic not
depending on the batch it is computed in: the blocks run inside
``utils/batch_invariant.scope``, whose ``atan2`` (the NFT fit's, on the
CPU) and row reductions (the term scan's, the shot means', autograd's, on
a card) have a fixed order.

Multi-process: after :func:`~queasars_tpu_torch.parallel.multihost.
initialize_multihost`, the mesh holds the processes' device lists in rank
order; every process runs the same call on the same host data, runs only
its own blocks, and the outputs are all-gathered through host tensors on
the ``gloo`` backend so every process holds the whole population axis.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from math import lcm
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from queasars_tpu_torch.parallel.multihost import is_multihost, local_device_ids, process_info
from queasars_tpu_torch.utils import batch_invariant

#: population padding quantum: mesh runs pad the population to a multiple
#: of this (and of the block count), as the JAX package does
POPULATION_PAD = 8

#: fewest individuals per block (the JAX package's rule, kept so both
#: packages pad alike); it also keeps a block from being a single row,
#: whose scans on a card round apart from a batch's (torch.cumsum at n=20)
MIN_BLOCK = 2


@dataclass(frozen=True)
class PopulationMesh:
    """The devices of a population mesh, one per block, in block order, and
    the process that owns each block (all 0 in one process)."""

    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_blocks(self) -> list[int]:
        """The blocks this process runs."""
        rank = process_info()[0]
        return [b for b, owner in enumerate(self.ranks) if owner == rank]


def _visible_cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: pass devices= (e.g. ['cpu'] * 8) to build a mesh "
            "without a card"
        )
    ids = local_device_ids()
    if ids is None:
        ids = range(torch.cuda.device_count())
    return [torch.device("cuda", i) for i in ids]


def _gloo_group():
    """The process group the outputs are gathered on: the default one when
    it is gloo, else a gloo group over the same processes."""
    global _GLOO
    if torch.distributed.get_backend() == "gloo":
        return None
    if _GLOO is None:
        _GLOO = torch.distributed.new_group(backend="gloo")
    return _GLOO


_GLOO = None


def population_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> PopulationMesh:
    """A 1-D mesh over the population axis.

    :param n_devices: number of devices to use (default: all); above the
        number visible it raises ``ValueError``
    :param devices: explicit device list of this process (overrides
        ``n_devices``); a device may repeat
    :return: the mesh; under several processes, every process's list in
        rank order
    """
    if devices is None:
        local = _visible_cards()
    else:
        local = [torch.device(d) for d in devices]
        if not local:
            raise ValueError("a mesh needs at least one device")
    rank, world = process_info()
    if world > 1:
        lists: list = [None] * world
        torch.distributed.all_gather_object(
            lists, [str(d) for d in local], group=_gloo_group()
        )
        pairs = [(torch.device(d), r) for r, names in enumerate(lists) for d in names]
    else:
        pairs = [(d, 0) for d in local]
    if devices is None and n_devices is not None:
        if n_devices < 1:
            raise ValueError("n_devices must be at least 1")
        if n_devices > len(pairs):
            raise ValueError(
                f"n_devices={n_devices} exceeds the {len(pairs)} visible device(s)"
            )
        pairs = pairs[:n_devices]
    return PopulationMesh(tuple(d for d, _ in pairs), tuple(r for _, r in pairs))


def mesh_of(n_devices: int, device=None) -> PopulationMesh:
    """The ``n_devices`` shorthand of the solvers' configurations:
    :func:`population_mesh` over the first ``n_devices`` cards, or, when
    the solve is asked to run on the CPU (``device="cpu"``), ``n_devices``
    blocks on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        if n_devices < 1:
            raise ValueError("n_devices must be at least 1")
        return population_mesh(devices=[torch.device("cpu")] * n_devices)
    return population_mesh(n_devices)


def population_pad_multiple(mesh: PopulationMesh) -> int:
    """The multiple the population axis is padded to for this mesh."""
    return max(lcm(mesh.size, POPULATION_PAD), MIN_BLOCK * mesh.size)


def pad_population_axis(array, multiple: int):
    """Zero-pad axis 0 up to the next multiple (no-op when aligned); numpy
    arrays stay numpy, tensors stay tensors on their device."""
    if isinstance(array, torch.Tensor):
        pop = array.shape[0]
        padded = -(-pop // multiple) * multiple
        if padded == pop:
            return array
        filler = torch.zeros((padded - pop, *array.shape[1:]), dtype=array.dtype,
                             device=array.device)
        return torch.cat([array, filler])
    arr = np.asarray(array)
    pop = arr.shape[0]
    padded = -(-pop // multiple) * multiple
    if padded == pop:
        return arr
    pad_widths = [(0, padded - pop)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_widths)


def to_device(obj, device):
    """``obj`` with every tensor in it on ``device``: tensors, and tuples,
    named tuples (the operators' operands), lists and dicts of them; other
    values as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def device_context(device: torch.device):
    """Make ``device`` current for the kernels' launches (a card), or
    nothing (the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _population(pop_args) -> int:
    sizes = {int(a.shape[0]) for a in pop_args if a is not None}
    if len(sizes) != 1:
        raise ValueError(f"the population operands disagree on axis 0: {sorted(sizes)}")
    return sizes.pop()


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def run_blocks(mesh: PopulationMesh, fn: Callable, pop_args: tuple, rep_args: tuple):
    """Run ``fn(pop_args, rep_args)`` once per block of this process, on the
    block's device, and concatenate every block's outputs in block order on
    the CPU.  Axis 0 of ``pop_args`` must be a multiple of the mesh size.

    :param fn: takes the block's operands (tensors on its device, or None)
        and ``rep_args`` copied to that device; returns a tensor or a tuple
        of tensors, each with the block's individuals on axis 0
    """
    pop = _population(pop_args)
    if pop % mesh.size:
        raise ValueError(f"axis 0 ({pop}) is not a multiple of the mesh size ({mesh.size})")
    width = pop // mesh.size
    tensors = tuple(None if a is None else torch.as_tensor(a) for a in pop_args)
    replicated: dict = {}
    outputs = []
    for b in mesh.local_blocks():
        device = mesh.devices[b]
        if device not in replicated:
            replicated[device] = to_device(rep_args, device)
        with device_context(device), batch_invariant.scope():
            block = tuple(
                None if t is None else t[b * width:(b + 1) * width].to(device) for t in tensors
            )
            outputs.append(_as_tuple(fn(block, replicated[device])))
    outputs = [tuple(o.cpu() for o in out) for out in outputs]
    if is_multihost():
        gathered: list = [None] * process_info()[1]
        torch.distributed.all_gather_object(gathered, outputs, group=_gloo_group())
        outputs = [out for per_rank in gathered for out in per_rank]
    joined = tuple(torch.cat(parts) for parts in zip(*outputs))
    return joined if len(joined) > 1 else joined[0]


def run_population_sharded(mesh: PopulationMesh, fn: Callable, pop_args: tuple, rep_args: tuple):
    """Run ``fn(pop_args, rep_args)`` over the mesh's population axis.

    :param fn: callable taking the two tuples; every array in ``pop_args``
        has the population on axis 0 (None entries pass through), every
        output does too; ``rep_args`` are replicated operands (tables,
        scalars, a shared start state), copied once per distinct device
    :return: fn's outputs (a tensor or a tuple of tensors) on the CPU, with
        the population axis of ``pop_args``: it is padded to
        :func:`population_pad_multiple` before the blocks run and the pad
        is cut off after
    """
    pop = _population(pop_args)
    multiple = population_pad_multiple(mesh)
    padded = tuple(
        None if a is None else pad_population_axis(torch.as_tensor(a), multiple)
        for a in pop_args
    )
    out = run_blocks(mesh, fn, padded, rep_args)
    if isinstance(out, tuple):
        return tuple(o[:pop] for o in out)
    return out[:pop]


def run_batched(mesh: Optional[PopulationMesh], fn: Callable, pop_args: tuple,
                rep_args: tuple = ()):
    """``fn(pop_args, rep_args)`` as given (no mesh: the operands already
    lie where it runs, and so do its outputs), or
    :func:`run_population_sharded` over ``mesh`` (outputs on the CPU)."""
    if mesh is None:
        return fn(pop_args, rep_args)
    return run_population_sharded(mesh, fn, pop_args, rep_args)


def operand_device(mesh: Optional[PopulationMesh], device):
    """Where a caller of :func:`run_batched` builds its population operands:
    ``device`` without a mesh, the CPU (for the mesh to split) with one."""
    return device if mesh is None else torch.device("cpu")


def shard_packed(packed, mesh: PopulationMesh) -> tuple[dict, int]:
    """Place a packed population's tensors on the mesh, split over the
    population axis (padded to the mesh's pad multiple).

    :return: (dict name -> list of this process's blocks, each on its
        block's device, in block order; the original population size)
    """
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    multiple = population_pad_multiple(mesh)
    names = ("gate_types", "controls", "angles", "layer_mask")
    padded = [pad_population_axis(t, multiple) for t in packed_tensors(packed, device="cpu")]
    width = padded[0].shape[0] // mesh.size
    placed = {
        name: [t[b * width:(b + 1) * width].to(mesh.devices[b]) for b in mesh.local_blocks()]
        for name, t in zip(names, padded)
    }
    return placed, packed.n_individuals


def sharded_population_energies(mesh: PopulationMesh, packed, table) -> np.ndarray:
    """Exact diagonal-table energies of a population, split over the mesh:
    the table replicated to every device, the genome tensors split, each
    block on the route the objective picks (``optim/objective.py``: the fold
    or the slot energies kernel on a card, the plain version on the CPU)."""
    from queasars_tpu_torch.optim.objective import population_energies
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    n = packed.n_qubits
    table_t = torch.as_tensor(table).to(torch.float32)

    def fn(pa, ra):
        return population_energies(*pa, ra[0], None, None, 1.0, n_qubits=n, use_cvar=False)

    energies = run_population_sharded(mesh, fn, packed_tensors(packed, device="cpu"), (table_t,))
    return energies.numpy()


def sharded_training_step(
    mesh: PopulationMesh,
    packed,
    table,
    coords: np.ndarray,
    n_free: np.ndarray,
    active: np.ndarray,
    maxiter: int = 4,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """One EVQE training step over the mesh: ``maxiter`` lock-step NFT steps
    on the given coordinates (full circuits, reset interval 32) on the
    route the objective picks, each block on its device; the JAX package's
    multi-chip dry-run and scaling body.  ``seed`` is accepted for that
    contract; the exact objective draws no shots.

    :return: (optimized angles, the final NFT energies), numpy
    """
    from queasars_tpu_torch.optim.nft import _nft_steps
    from queasars_tpu_torch.optim.objective import population_energies
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    n = packed.n_qubits
    table_t = torch.as_tensor(table).to(torch.float32)
    pop_args = (
        *packed_tensors(packed, device="cpu"),
        torch.as_tensor(np.asarray(coords), dtype=torch.long),
        torch.as_tensor(np.asarray(n_free), dtype=torch.int32),
        torch.as_tensor(np.asarray(active), dtype=torch.bool),
    )

    def fn(pa, ra):
        gt, ctrl, ang, lm, crd, nf, act = pa

        def objective(angles, keys):
            return population_energies(gt, ctrl, angles, lm, ra[0], None, None, 1.0,
                                       n_qubits=n, use_cvar=False)

        return _nft_steps(objective, ang, crd, nf, act, maxiter, 32)

    angles, energies = run_population_sharded(mesh, fn, pop_args, (table_t,))
    return angles.numpy(), energies.numpy()
