"""Layer-prefix cache shared by the batched optimizers.

Counterpart of ``queasars_tpu/optim/prefix.py``.  When a parameter sweep
only touches each individual's LAST real layer (the
EVQELastLayerParameterSearch hot path, reference evqe.py:199-204), the state
after the frozen prefix layers does not depend on the probes: it is
simulated once per sweep by the states kernel
(``slot_kernels.population_states`` under the mask below), and every probe
applies a single layer from the cached per-individual state.

Mathematically identical to the full-circuit objective; float rounding may
differ at the ulp level.
"""

from __future__ import annotations

import torch


def prefix_mask(layer_mask: torch.Tensor, first_free_layer: torch.Tensor) -> torch.Tensor:
    """[P, L] mask of the real layers before each individual's
    ``first_free_layer`` [P]."""
    layers = torch.arange(layer_mask.shape[1], device=layer_mask.device)
    return layer_mask & (layers[None, :] < first_free_layer[:, None])
