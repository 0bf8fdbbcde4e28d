"""Population objectives for the batched optimizers (exact branch).

Counterpart of the exact diagonal branch of
``queasars_tpu/optim/objective.py``: "angles -> energies" for a population,
through the slot kernels on the card (``pallas_energies_exact`` /
``pallas_population_probs`` in the JAX package's ``use_pallas=True,
use_mxu=False`` route) and their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.sim import slot_kernels
from queasars_tpu_torch.sim.expectation import cvar_expectation_from_probs


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
) -> torch.Tensor:
    """Energies [P] for the population at the given angle tensor;
    ``initial_state`` is None (|0...0>) or per-individual [P, 2, 2^n].
    The operands are :func:`objective_operands`' fields."""
    if use_cvar:
        probs = slot_kernels.population_probs(
            gate_types, controls, angles, layer_mask, n_qubits, initial_state
        )
        return cvar_expectation_from_probs(probs, sorted_energies, energy_order, alpha)
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
