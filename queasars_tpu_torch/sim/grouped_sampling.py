"""Shot sampling of general Pauli sums through QWC measurement groups.

Counterpart of ``queasars_tpu/sim/grouped_sampling.py``: every measurement
group (``paulis/grouping.py``) applies its basis rotation -- one genome layer
of ID/ROT slots -- to the population's circuits, samples its own shots with
its own keys (``fold_in(key_p, g)`` for individual p and group g) and
contracts them against the group's diagonal table in the rotated basis.  The
operator's energy is the identity constant plus the sum over groups.

Two entry points, chosen by ``optim/objective.py`` as the reference's
``population_energies`` chooses them, on the route ``sim/routes.py`` picks:

- :func:`grouped_shot_energies_kernels` (the in-kernel samplers' sizes,
  ``routes.sampler_route``): the one-launch grouped kernel
  (``fold_kernels.grouped_shot_indices_folded``, one circuit, every group
  rotated and sampled; ``routes.grouped_one_launch``), or one sampled-kernel
  launch per group on the circuit with the group's rotation appended (the
  folded sampler on an extended pipeline, or the slot sampler on an
  extended genome);
- :func:`grouped_shot_energies` (other sizes): the circuit once on the slot
  states kernel, then per group the rotation layer on the same kernel from
  those states, the probabilities and the flat sampler.

Every branch draws group g's shots from ``uniform(fold_in(keys, g), S_g)``,
the reference's stream, so all of them sample the same shots up to
boundary draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from queasars_tpu_torch.sim import fold_kernels, routes, slot_kernels
from queasars_tpu_torch.sim.fold_pipeline import (
    extend_fold_pipeline_with_rotation,
    rotation_layer_factors,
)
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.utils import prng
from queasars_tpu_torch.utils.batch_invariant import row_mean


class GroupedOperands(NamedTuple):
    """The device operands of grouped measurement (one entry per QWC group,
    in :func:`~queasars_tpu_torch.paulis.grouping.qwc_groups` order).

    - ``rot_types`` [G, n] int32 / ``rot_angles`` [G, n, 3] float32: each
      group's basis rotation as one genome layer;
    - ``tables`` [G, 2^n] float32: each group's diagonal energy table in
      its rotated basis;
    - ``const``: the identity terms' coefficient (exact, never sampled);
    - ``rot_factors`` [G, n, 2, 2, 2] / ``rot_active`` [G, n_axis_groups]:
      the rotations as kron layers (:func:`rotation_layer_factors`);
    - ``rotate``: per group, whether its rotation is not the identity (host
      booleans, so the kernels need not read ``rot_active`` back).
    """

    rot_types: torch.Tensor
    rot_angles: torch.Tensor
    tables: torch.Tensor
    const: float
    rot_factors: torch.Tensor
    rot_active: torch.Tensor
    rotate: tuple


def make_grouped_operands(rot_types, rot_angles, tables, const, device="cpu") -> GroupedOperands:
    """:class:`GroupedOperands` on ``device`` from the rotation layers, the
    rotated-basis tables and the identity constant (numpy or torch)."""
    rot_types = torch.as_tensor(np.array(rot_types), dtype=torch.int32).to(device)
    rot_angles = torch.as_tensor(np.array(rot_angles), dtype=torch.float32).to(device)
    tables = torch.as_tensor(np.array(tables), dtype=torch.float32).to(device).contiguous()
    n_qubits = rot_types.shape[1]
    rot_factors, rot_active = rotation_layer_factors(rot_types, rot_angles, n_qubits)
    rotate = tuple(bool(r) for r in rot_active.bool().any(dim=1).cpu().tolist())
    return GroupedOperands(
        rot_types=rot_types.contiguous(), rot_angles=rot_angles.contiguous(), tables=tables,
        const=float(const), rot_factors=rot_factors.contiguous(),
        rot_active=rot_active.contiguous(), rotate=rotate,
    )


def grouped_operands(operator, device="cpu") -> GroupedOperands:
    """Host-side build of the grouped-measurement operands of ``operator``
    (ValueError when it has no non-identity term)."""
    from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table
    from queasars_tpu_torch.paulis.grouping import measurement_rotation_layer, qwc_groups

    const, groups = qwc_groups(operator)
    n = operator.n_qubits
    if not groups:
        raise ValueError(
            "the operator has no non-identity terms -- nothing to measure "
            "(its expectation is the identity constant)"
        )
    layers = [measurement_rotation_layer(g, n) for g in groups]
    tables = torch.stack([diagonal_energy_table(g.diagonal, dtype=torch.float32) for g in groups])
    return make_grouped_operands(
        np.stack([t for t, _ in layers]), np.stack([a for _, a in layers]), tables,
        np.float32(const), device,
    )


def grouped_shard_operands(operator):
    """Host operands of the amplitude-sharded grouped sampler
    (``sim/sharded_evaluator.py``): the groups' rotation layers and their
    terms padded to one length, for the shard-local table build
    (``sharded_statevector.build_device_tables_batch``); no 2^n table is
    made on the host.

    :return: ``(rot_types [G, n] int32, rot_angles [G, n, 3] float32,
        coeffs [G, K] float32, z_masks [G, K] uint32, const float)``, ``K``
        the largest group's term count, zero coefficients inert padding
    """
    from queasars_tpu_torch.paulis.grouping import measurement_rotation_layer, qwc_groups

    n = operator.n_qubits
    if n > 32:
        raise NotImplementedError("sharded grouped sampling limited to n<=32 qubits")
    const, groups = qwc_groups(operator)
    if not groups:
        raise ValueError(
            "the operator has no non-identity terms -- nothing to measure "
            "(its expectation is the identity constant)"
        )
    layers = [measurement_rotation_layer(g, n) for g in groups]
    k_max = max(g.diagonal.n_terms for g in groups)
    coeffs = np.zeros((len(groups), k_max), np.float32)
    masks = np.zeros((len(groups), k_max), np.uint32)
    for i, g in enumerate(groups):
        k_g = g.diagonal.n_terms
        coeffs[i, :k_g] = g.diagonal.coeffs.real.astype(np.float32)
        masks[i, :k_g] = g.diagonal.z[:, 0].astype(np.uint32)
    return (np.stack([t for t, _ in layers]).astype(np.int32),
            np.stack([a for _, a in layers]).astype(np.float32), coeffs, masks, float(const))


def grouped_weights(operator) -> np.ndarray:
    """Per-group coefficient L1 norms ``w_g = sum_k |c_k|`` (the shot
    allocation weights of :func:`allocate_shots`), in group order."""
    from queasars_tpu_torch.paulis.grouping import qwc_groups

    _, groups = qwc_groups(operator)
    return np.array([float(np.abs(g.diagonal.coeffs.real).sum()) for g in groups], np.float64)


def allocate_shots(weights, total: int) -> tuple[int, ...]:
    """Split a total shot budget across measurement groups in proportion
    to their weights (the variance-optimal rule for the groups' shot-noise
    bounds ``w_g / sqrt(S_g)``): every group gets one shot, the rest is
    split by largest remainder, ties by group index."""
    weights = np.asarray(weights, np.float64)
    n_groups = int(weights.size)
    if total < n_groups:
        raise ValueError(
            f"a total budget of {total} shots cannot give each of the "
            f"{n_groups} measurement groups at least one shot"
        )
    if not np.all(weights > 0):
        raise ValueError("every group weight must be positive")
    ideal = weights / weights.sum() * (total - n_groups)
    base = np.floor(ideal).astype(np.int64)
    remainder = total - n_groups - int(base.sum())
    order = np.argsort(-(ideal - base), kind="stable")
    base[order[:remainder]] += 1
    return tuple(int(s) + 1 for s in base)


def group_shot_counts(shots, n_groups: int) -> tuple[int, ...]:
    """Per-group shots from an int (every group) or a per-group tuple."""
    if isinstance(shots, (tuple, list)):
        if len(shots) != n_groups:
            raise ValueError(f"{len(shots)} shot counts for {n_groups} groups")
        return tuple(int(s) for s in shots)
    return (int(shots),) * n_groups


def _group_uniforms(keys, g: int, shots: int, device) -> torch.Tensor:
    """Group g's uniforms [P, shots]: ``uniform(fold_in(keys, g), shots)``."""
    return prng.uniform(prng.fold_in(keys, g), (shots,)).to(device)


def _rotation_genome(rot_type, rot_angle, pop: int):
    """One group's rotation as a one-layer genome of the population."""
    n = rot_type.shape[0]
    device = rot_angle.device
    return (
        rot_type.to(torch.int32).expand(pop, 1, n).contiguous(),
        torch.full((pop, 1, n), -1, dtype=torch.int32, device=device),
        rot_angle.float().expand(pop, 1, n, 3).contiguous(),
        torch.ones((pop, 1), dtype=torch.bool, device=device),
    )


def _rotated_probs(states, rot_type, rot_angle, n_qubits: int) -> torch.Tensor:
    """Measurement probabilities [P, 2^n] of ``states`` [P, 2, 2^n] in one
    group's rotated basis: the rotation layer on the slot states kernel
    from the states."""
    rotated = slot_kernels.population_states(
        *_rotation_genome(rot_type, rot_angle, states.shape[0]), n_qubits, states.contiguous()
    )
    return rotated[:, 0] ** 2 + rotated[:, 1] ** 2


def grouped_energies_from_states(states, keys, operands: GroupedOperands, *, shots):
    """Shot-sampled energies [P] of simulated ``states`` [P, 2, 2^n]: per
    group the rotated probabilities and the flat sampler with the keys
    ``fold_in(keys, g)`` (``keys`` [P, 2]), the shots' mean energy, summed
    over groups onto the identity constant.  ``shots``: an int or a
    per-group tuple (:func:`allocate_shots`)."""
    n_qubits = operands.rot_types.shape[1]
    counts = group_shot_counts(shots, operands.tables.shape[0])
    total = torch.zeros(states.shape[0], dtype=torch.float32, device=states.device)
    for g, g_shots in enumerate(counts):
        probs = _rotated_probs(states, operands.rot_types[g], operands.rot_angles[g], n_qubits)
        idx = sample_indices(prng.fold_in(keys, g), probs, g_shots)
        total = total + row_mean(operands.tables[g][idx])
    return operands.const + total


def grouped_exact_energies_from_states(states, operands: GroupedOperands) -> torch.Tensor:
    """Exact (infinite-shot) energies [P]: each group's true rotated-basis
    probabilities against its table, summed onto the identity constant; the
    oracle of :func:`grouped_energies_from_states`, equal to the general
    Pauli expectation up to float rounding."""
    n_qubits = operands.rot_types.shape[1]
    total = torch.zeros(states.shape[0], dtype=torch.float32, device=states.device)
    for g in range(operands.tables.shape[0]):
        probs = _rotated_probs(states, operands.rot_types[g], operands.rot_angles[g], n_qubits)
        total = total + probs @ operands.tables[g]
    return operands.const + total


def append_rotation_layer(gate_types, controls, angles, layer_mask, rot_type, rot_angle):
    """Genome tensors [P, L, ...] extended by one basis-rotation layer
    ([P, L+1, ...], mask True).  Masked-off layers are skipped wherever they
    sit, so the appended layer applies last."""
    ext = _rotation_genome(rot_type, rot_angle, gate_types.shape[0])
    return tuple(
        torch.cat([t, e.to(t.dtype)], dim=1).contiguous()
        for t, e in zip((gate_types, controls, angles, layer_mask), ext)
    )


def grouped_shot_energies_kernels(
    gate_types, controls, angles, layer_mask, keys, operands: GroupedOperands, *,
    n_qubits: int, shots, fold: bool, initial_state=None,
):
    """Grouped sampling on the in-kernel samplers (the reference's
    ``grouped_shot_energies_pallas``): on the fold route (``fold``, from
    ``routes.sampler_route``) the one-launch grouped kernel when
    ``routes.grouped_one_launch`` holds, else the folded sampler once per
    group on the base pipeline extended by that group's rotation; on the
    slot route the slot sampler once per group on the genome extended by the
    rotation layer.  ``initial_state``: None or per-individual [P, 2, 2^n];
    ``shots``: an int or a per-group tuple."""
    device = angles.device
    n_groups = operands.tables.shape[0]
    counts = group_shot_counts(shots, n_groups)
    total = torch.zeros(gate_types.shape[0], dtype=torch.float32, device=device)
    if not fold:
        for g, g_shots in enumerate(counts):
            ext = append_rotation_layer(
                gate_types, controls, angles, layer_mask,
                operands.rot_types[g], operands.rot_angles[g],
            )
            idx = slot_kernels.sampled_shot_indices(
                *ext, _group_uniforms(keys, g, g_shots, device), n_qubits, initial_state
            )
            total = total + row_mean(operands.tables[g][idx.long()])
        return operands.const + total
    base = routes.fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits)
    if routes.grouped_one_launch(n_qubits, device, n_groups):
        fracs = [_group_uniforms(keys, g, s, device) for g, s in enumerate(counts)]
        indices = fold_kernels.grouped_shot_indices_folded(
            base, operands.rot_factors, operands.rot_active, fracs, n_qubits, initial_state,
            rotate=operands.rotate,
        )
        for g, idx in enumerate(indices):
            total = total + row_mean(operands.tables[g][idx.long()])
        return operands.const + total
    for g, g_shots in enumerate(counts):
        pipeline = extend_fold_pipeline_with_rotation(
            base, operands.rot_types[g], operands.rot_angles[g], n_qubits
        )
        idx = fold_kernels.sampled_shot_indices_folded(
            pipeline, _group_uniforms(keys, g, g_shots, device), n_qubits, initial_state
        )
        total = total + row_mean(operands.tables[g][idx.long()])
    return operands.const + total


def grouped_shot_energies(
    gate_types, controls, angles, layer_mask, keys, operands: GroupedOperands, *,
    n_qubits: int, shots, initial_state=None,
):
    """Grouped sampling outside the in-kernel samplers' sizes (the
    reference's ``grouped_shot_energies``): the circuits once on the slot
    states kernel, then :func:`grouped_energies_from_states`."""
    states = slot_kernels.population_states(
        gate_types, controls, angles, layer_mask, n_qubits, initial_state
    )
    return grouped_energies_from_states(states, keys, operands, shots=shots)
