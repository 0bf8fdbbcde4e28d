"""Layer-prefix cache shared by the batched optimizers.

Counterpart of ``queasars_tpu/optim/prefix.py``.  When a parameter sweep
only touches each individual's LAST real layer (the
EVQELastLayerParameterSearch hot path, reference evqe.py:199-204), the state
after the frozen prefix layers does not depend on the probes: it is
simulated once per sweep (under :func:`prefix_mask`, on the engine
:func:`choose_prefix_engine` picks), and every probe applies a single layer
from the cached per-individual state.

Mathematically identical to the full-circuit objective; float rounding may
differ at the ulp level.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.optim.objective import mxu_fold_enabled
from queasars_tpu_torch.sim import fold_kernels, slot_kernels
from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline

#: the slot states kernel's size cap in the reference (its VMEM limit)
SLOT_STATES_MAX_QUBITS = 20


def prefix_mask(layer_mask: torch.Tensor, first_free_layer: torch.Tensor) -> torch.Tensor:
    """[P, L] mask of the real layers before each individual's
    ``first_free_layer`` [P]."""
    layers = torch.arange(layer_mask.shape[1], device=layer_mask.device)
    return layer_mask & (layers[None, :] < first_free_layer[:, None])


def choose_prefix_engine(n_qubits: int, device) -> str:
    """The engine for frozen-prefix states, as the reference picks it:
    ``"slot"`` (the slot states kernel) up to n=20 and off the card;
    ``"fold"`` (the folded states kernel) at n=21-22 when the fold route
    is on; ``"slot"`` otherwise (where the reference takes its jnp engine,
    the port's slot kernel has no size cap)."""
    if n_qubits > SLOT_STATES_MAX_QUBITS and mxu_fold_enabled(None, n_qubits, "exact", device):
        return "fold"
    return "slot"


def simulate_prefix_states(
    gate_types, controls, angles, mask, n_qubits: int, initial_state=None, mode: str = "slot"
) -> torch.Tensor:
    """[P, 2, 2^n] states after the layers ``mask`` keeps, from |0...0> or
    per-individual ``initial_state``, on the engine ``mode`` names."""
    if mode == "fold":
        pipeline = build_fold_pipeline(
            gate_types, controls, angles, mask, n_qubits, absorb_diag=True
        )
        return fold_kernels.population_states_folded(pipeline, n_qubits, initial_state)
    if mode != "slot":
        raise ValueError(f"unknown prefix engine {mode!r}")
    return slot_kernels.population_states(
        gate_types, controls, angles, mask, n_qubits, initial_state
    )
