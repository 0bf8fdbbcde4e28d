"""Population objectives for the batched optimizers (exact branch).

Counterpart of the exact diagonal branch of
``queasars_tpu/optim/objective.py``: "angles -> energies" for a population,
on one of two routes, as the JAX package's ``use_pallas=True`` route picks
them:

- the kron-fold route (the default; ``QUEASARS_MXU`` unset or "1"): the
  genome becomes a fold pipeline (``sim/fold_pipeline.py``, with absorbed
  same-group phases) and the fold kernels compute energies
  (``energies_exact_folded``) or, for CVaR, probabilities
  (``population_probs_folded``);
- the slot route (``QUEASARS_MXU=0``, or a size or device the fold kernels
  do not take): the slot kernels ``energies_exact`` / ``population_probs``.

On the CPU both run their plain versions; the fold route is chosen only for
tensors on the card (:func:`mxu_fold_enabled`).  :func:`population_probs`
makes the same choice for the solve's final measurement distribution.
"""

from __future__ import annotations

import os

import torch

from queasars_tpu_torch.sim import fold_kernels, slot_kernels
from queasars_tpu_torch.sim.expectation import cvar_expectation_from_probs
from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline


def mxu_fold_enabled(use_mxu, n_qubits: int, path: str = "exact", device="cuda") -> bool:
    """Resolve the kron-fold knob as the reference does: an explicit
    ``use_mxu`` wins, else ``QUEASARS_MXU`` (default "1"); either way the
    fold kernels must take the ``path`` at the size on ``device``
    (:func:`~queasars_tpu_torch.sim.fold_kernels.fold_supported`)."""
    if use_mxu is None:
        use_mxu = os.environ.get("QUEASARS_MXU", "1") == "1"
    return bool(use_mxu) and fold_kernels.fold_supported(n_qubits, device, path)


def population_probs(
    gate_types, controls, angles, layer_mask, *, n_qubits: int, initial_state=None, use_mxu=None
) -> torch.Tensor:
    """Measurement probabilities [P, 2^n] on the route ``use_mxu`` picks
    (None: :func:`mxu_fold_enabled` decides)."""
    if mxu_fold_enabled(use_mxu, n_qubits, device=angles.device):
        pipeline = build_fold_pipeline(
            gate_types, controls, angles, layer_mask, n_qubits, absorb_diag=True
        )
        return fold_kernels.population_probs_folded(pipeline, n_qubits, initial_state)
    return slot_kernels.population_probs(
        gate_types, controls, angles, layer_mask, n_qubits, initial_state
    )


def population_energies(
    gate_types,
    controls,
    angles,
    layer_mask,
    table,
    sorted_energies,
    energy_order,
    alpha,
    *,
    n_qubits: int,
    use_cvar: bool,
    initial_state=None,
    use_mxu=None,
) -> torch.Tensor:
    """Energies [P] for the population at the given angle tensor;
    ``initial_state`` is None (|0...0>) or per-individual [P, 2, 2^n].
    The operands are :func:`objective_operands`' fields; ``use_mxu`` picks
    the route (None: :func:`mxu_fold_enabled` decides)."""
    if use_cvar:
        probs = population_probs(
            gate_types, controls, angles, layer_mask, n_qubits=n_qubits,
            initial_state=initial_state, use_mxu=use_mxu,
        )
        return cvar_expectation_from_probs(probs, sorted_energies, energy_order, alpha)
    if mxu_fold_enabled(use_mxu, n_qubits, device=angles.device):
        pipeline = build_fold_pipeline(
            gate_types, controls, angles, layer_mask, n_qubits, absorb_diag=True
        )
        return fold_kernels.energies_exact_folded(pipeline, table, n_qubits, initial_state)
    return slot_kernels.energies_exact(
        gate_types, controls, angles, layer_mask, table, n_qubits, initial_state
    )


def objective_operands(evaluator) -> dict:
    """The operands of an evaluator's objective, as keyword arguments of
    :func:`population_energies` (TypeError for unsupported evaluators)."""
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    if not isinstance(evaluator, StatevectorExpectationEvaluator):
        raise TypeError(f"unsupported evaluator type for batched optimization: {type(evaluator)!r}")
    return dict(
        table=evaluator._table,
        sorted_energies=evaluator._sorted,
        energy_order=evaluator._order,
        alpha=evaluator.alpha,
        use_cvar=evaluator.alpha < 1.0,
    )
