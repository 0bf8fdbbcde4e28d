"""The route choice: which engine runs a circuit, and the call that runs it.

The port has two engines for one genome circuit: the slot route
(``sim/slot_kernels.py``) and the kron-fold route (``sim/fold_pipeline.py``
builds the pipeline, ``sim/fold_kernels.py`` runs it).  This module holds
the policy that picks between them, as the JAX package's ``use_pallas=True``
route picks them, and is the one place in the package that reads its knobs
``QUEASARS_MXU``, ``QUEASARS_GROUPED_ONE_LAUNCH`` and ``QUEASARS_SHARD_FOLD``:
one predicate per rule (:func:`fold_enabled`, :func:`prefix_fold`,
:func:`sampler_route`, :func:`grouped_one_launch`, :func:`shard_fold`), each
consulting the kernels' capabilities (``fold_kernels.fold_supported``).

The dispatch functions (:func:`states`, :func:`energies`, :func:`probs`,
:func:`shot_indices`) take the genome tensors, resolve the route once, build
the fold pipeline (:func:`fold_pipeline`) on the fold route and call the
wrapper through its module, so a test that replaces
``fold_kernels.fold_supported`` or a wrapper sees every call.  On the CPU
the fold route is never chosen (``fold_supported`` wants CUDA tensors).
"""

from __future__ import annotations

import os

import torch

from queasars_tpu_torch.sim import fold_kernels, slot_kernels
from queasars_tpu_torch.sim.fold_pipeline import FoldPipeline, build_fold_pipeline
from queasars_tpu_torch.utils import prng

#: the reference's slot states kernel's size cap (its VMEM limit)
SLOT_STATES_MAX_QUBITS = 20


def fold_enabled(use_mxu, n_qubits: int, path: str = "exact", device="cuda") -> bool:
    """The optimizers' route, resolved as the reference does: an explicit
    ``use_mxu`` wins, else ``QUEASARS_MXU`` (default "1"); either way the
    fold kernels must take the ``path`` at the size on ``device``."""
    if use_mxu is None:
        use_mxu = os.environ.get("QUEASARS_MXU", "1") == "1"
    return bool(use_mxu) and fold_kernels.fold_supported(n_qubits, device, path)


def prefix_fold(n_qubits: int, device) -> bool:
    """Whether frozen-prefix states take the fold route: at n = 21-22 when
    the fold route is on; the slot states kernel otherwise (where the
    reference takes its jnp engine, the slot kernel has no size cap)."""
    return n_qubits > SLOT_STATES_MAX_QUBITS and fold_enabled(None, n_qubits, "exact", device)


def sampler_route(use_mxu, n_qubits: int, device) -> bool | None:
    """The in-kernel sampler that draws shots at this size: True the folded
    sampler (14 <= n <= 21 on the fold route), False the slot sampler
    (14 <= n <= 20 otherwise), None neither (probabilities and the flat
    sampler draw the same shots)."""
    fold = fold_enabled(use_mxu, n_qubits, "sampler", device)
    cap = fold_kernels.SAMPLER_MAX_QUBITS if fold else slot_kernels.SAMPLER_MAX_QUBITS
    return fold if slot_kernels.SAMPLER_MIN_QUBITS <= n_qubits <= cap else None


def grouped_one_launch(n_qubits: int, device, n_groups: int) -> bool:
    """Whether grouped measurement on the fold route samples every group in
    one grouped-kernel launch: ``QUEASARS_GROUPED_ONE_LAUNCH`` unset or "1"
    (the reference's knob) and the kernel takes ``n_groups`` groups."""
    return (os.environ.get("QUEASARS_GROUPED_ONE_LAUNCH", "1") == "1"
            and fold_kernels.grouped_fold_supported(n_qubits, device, n_groups))


def shard_fold(use_fold: bool | None, n_qubits: int) -> bool:
    """The amplitude-sharded evaluator's route: an explicit ``use_fold``
    wins, else the fold route for n >= 10 unless ``QUEASARS_SHARD_FOLD=0``.
    It never depends on the mesh (the bit-identity contract)."""
    if use_fold is not None:
        return bool(use_fold)
    return os.environ.get("QUEASARS_SHARD_FOLD", "1") == "1" and n_qubits >= 10


def fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits: int) -> FoldPipeline:
    """The fold route's pipeline of a genome: absorbed same-group phases on,
    as every fold kernel the routes launch reads it."""
    return build_fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits, absorb_diag=True)


def states(gate_types, controls, angles, layer_mask, n_qubits: int, initial_state=None, *,
           fold: bool | None = None) -> torch.Tensor:
    """[P, 2, 2^n] states after the layers ``layer_mask`` keeps, from
    |0...0> or per-individual ``initial_state``; ``fold`` names the engine,
    None takes :func:`prefix_fold`'s (the optimizers' cached prefixes)."""
    if fold is None:
        fold = prefix_fold(n_qubits, angles.device)
    if fold:
        pipeline = fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits)
        return fold_kernels.population_states_folded(pipeline, n_qubits, initial_state)
    return slot_kernels.population_states(
        gate_types, controls, angles, layer_mask, n_qubits, initial_state
    )


def energies(gate_types, controls, angles, layer_mask, table, n_qubits: int,
             initial_state=None, *, use_mxu=None) -> torch.Tensor:
    """Exact diagonal energies [P] on the route :func:`fold_enabled` picks."""
    if fold_enabled(use_mxu, n_qubits, device=angles.device):
        pipeline = fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits)
        return fold_kernels.energies_exact_folded(pipeline, table, n_qubits, initial_state)
    return slot_kernels.energies_exact(
        gate_types, controls, angles, layer_mask, table, n_qubits, initial_state
    )


def probs(gate_types, controls, angles, layer_mask, n_qubits: int, initial_state=None, *,
          use_mxu=None) -> torch.Tensor:
    """Measurement probabilities [P, 2^n] on the route :func:`fold_enabled`
    picks."""
    if fold_enabled(use_mxu, n_qubits, device=angles.device):
        pipeline = fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits)
        return fold_kernels.population_probs_folded(pipeline, n_qubits, initial_state)
    return slot_kernels.population_probs(
        gate_types, controls, angles, layer_mask, n_qubits, initial_state
    )


def shot_indices(gate_types, controls, angles, layer_mask, keys, n_qubits: int, shots: int,
                 initial_state=None, *, fold: bool) -> torch.Tensor:
    """Sampled basis indices [P, shots] on the in-kernel sampler
    :func:`sampler_route` named (``fold``), each individual's draws
    ``uniform(keys[p], shots)`` (``keys`` [P, 2])."""
    frac = prng.uniform(keys, (shots,)).to(angles.device)
    if fold:
        pipeline = fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits)
        return fold_kernels.sampled_shot_indices_folded(pipeline, frac, n_qubits, initial_state)
    return slot_kernels.sampled_shot_indices(
        gate_types, controls, angles, layer_mask, frac, n_qubits, initial_state
    )
