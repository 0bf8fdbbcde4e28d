"""Layer-prefix cache shared by the batched optimizers.

Counterpart of ``queasars_tpu/optim/prefix.py``.  When a parameter sweep
only touches each individual's LAST real layer (the
EVQELastLayerParameterSearch hot path, reference evqe.py:199-204), the state
after the frozen prefix layers does not depend on the probes: it is
simulated once per sweep (under :func:`prefix_mask`, on the engine
``sim/routes.py`` picks for prefixes), and every probe applies a single layer
from the cached per-individual state (:func:`build_prefix_transform`).
:func:`cache_enabled` and :func:`prefix_enabled` resolve the optimizers'
``cache_prefix`` knob.

Mathematically identical to the full-circuit objective; float rounding may
differ at the ulp level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from queasars_tpu_torch.sim import routes
from queasars_tpu_torch.utils.profiling import spanned


def prefix_mask(layer_mask: torch.Tensor, first_free_layer: torch.Tensor) -> torch.Tensor:
    """[P, L] mask of the real layers before each individual's
    ``first_free_layer`` [P]."""
    layers = torch.arange(layer_mask.shape[1], device=layer_mask.device)
    return layer_mask & (layers[None, :] < first_free_layer[:, None])


@spanned("evaluator.simulate_prefix_states")
def simulate_prefix_states(
    gate_types, controls, angles, mask, n_qubits: int, initial_state=None
) -> torch.Tensor:
    """[P, 2, 2^n] states after the layers ``mask`` keeps, from |0...0> or
    per-individual ``initial_state``, on the engine ``routes.prefix_fold``
    picks."""
    return routes.states(gate_types, controls, angles, mask, n_qubits, initial_state)


def kernel_route(operands: dict) -> bool:
    """The reference's ``use_pallas`` for these :func:`objective_operands`:
    every objective but a general operator's exact one (which the reference
    gives ``use_pallas=False``) runs on the fused kernel route.  The port's
    kernels also take a shared start state, which the reference's do not."""
    return not (operands["use_general"] and not operands["use_shots"])


def cache_enabled(cache_flag: Optional[bool], operands: dict) -> bool:
    """Resolve the ``cache_prefix`` knob as the reference does: an explicit
    True/False wins; None enables it exactly on the kernel route
    (:func:`kernel_route`).  With it off, the fused multi-slot searches
    decline."""
    return kernel_route(operands) if cache_flag is None else bool(cache_flag)


def prefix_enabled(cache_flag: Optional[bool], operands: dict, mesh, last_layer) -> bool:
    """Whether a search caches its prefix (the reference's
    ``prefix_enabled``): only with ``last_layer`` and without a population
    mesh, then as :func:`cache_enabled` resolves."""
    if last_layer is None or mesh is not None:
        return False
    return cache_enabled(cache_flag, operands)


@dataclass
class PrefixTransform:
    """A last-layer sweep's operands rewritten to one layer over the cached
    prefix states (device tensors)."""

    gate_types: torch.Tensor     # [P, 1, n]
    controls: torch.Tensor       # [P, 1, n]
    layer_mask: torch.Tensor     # [P, 1] all True
    angles: torch.Tensor         # [P, 1, n, 3] the optimized layer's slice
    coords: torch.Tensor         # [P, K, 3] with the layer column set to 0
    initial_state: torch.Tensor  # [P, 2, 2^n] the cached prefix states
    full_angles: torch.Tensor    # the untransformed [P, L, n, 3] tensor
    last_layer: torch.Tensor     # [P] the optimized layer per individual

    def merge(self, out_angles: torch.Tensor) -> torch.Tensor:
        """Scatter the optimized layer slice back into the full tensor."""
        merged = self.full_angles.clone()
        rows = torch.arange(merged.shape[0], device=merged.device)
        merged[rows, self.last_layer] = out_angles[:, 0]
        return merged


def build_prefix_transform(
    gate_types, controls, angles, layer_mask, coords, last_layer, n_qubits: int,
    initial_state=None,
) -> PrefixTransform:
    """Simulate each individual's frozen prefix (its real layers before
    ``last_layer`` [P], from ``initial_state`` or |0...0>) once and rewrite
    the sweep's operands to that one layer (the reference's
    ``build_prefix_transform``)."""
    pop = gate_types.shape[0]
    rows = torch.arange(pop, device=angles.device)
    ll = torch.as_tensor(last_layer, dtype=torch.long, device=angles.device)
    prefix = simulate_prefix_states(
        gate_types, controls, angles, prefix_mask(layer_mask, ll), n_qubits, initial_state
    )
    layer_coords = coords.clone()
    layer_coords[:, :, 0] = 0
    return PrefixTransform(
        gate_types=gate_types[rows, ll][:, None].contiguous(),
        controls=controls[rows, ll][:, None].contiguous(),
        layer_mask=torch.ones((pop, 1), dtype=torch.bool, device=angles.device),
        angles=angles[rows, ll][:, None].contiguous(),
        coords=layer_coords,
        initial_state=prefix,
        full_angles=angles,
        last_layer=ll,
    )
