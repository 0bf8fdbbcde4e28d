"""Launchers for the last-layer NFT sweep.

Counterpart of ``queasars_tpu/optim/sweep_kernel_launch.py``.  Two variants
share the contract:

- slot (:func:`nft_layer_sweep_launch`): prefix states from the slot states
  kernel, then the whole ``maxiter`` sweep on the slot sweep kernel;
- folded (:func:`nft_layer_sweep_folded_launch`): the prefix's fold pipeline
  (absorbed phases on) through the folded states kernel, then the folded
  sweep, whose probes apply the swept layer as two kron layers and a phase
  pass with that layer's factors rebuilt on the card as angles move.

On the card neither kernel synchronises with the host; the folded variant
first copies the swept layer's gate structure to the host (one wait per
launch) to build the sweep metadata there, as the reference does.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.optim.prefix import prefix_mask
from queasars_tpu_torch.sim import fold_kernels, slot_kernels
from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline


def _swept_layer(tensors, last_layer):
    """Each individual's ``last_layer`` slice of [P, L, ...] tensors."""
    rows = torch.arange(last_layer.shape[0], device=last_layer.device)
    return [t[rows, last_layer].contiguous() for t in tensors]


def nft_layer_sweep_launch(
    gate_types, controls, angles, layer_mask, last_layer, coords_qa,
    n_free, active, table, *, n_qubits: int, maxiter: int, reset_interval: int,
    initial_state=None,
):
    """Device tensors in (genome [P, L, n] tensors, ``last_layer`` [P]
    long, ``coords_qa`` [P, K, 2] int32, ``n_free`` [P] int32, ``active``
    [P] bool, ``table`` [2^n]); returns (optimized layer angles [P, n, 3],
    final energies [P])."""
    prefix = slot_kernels.population_states(
        gate_types, controls, angles, prefix_mask(layer_mask, last_layer), n_qubits,
        initial_state,
    )
    return slot_kernels.nft_layer_sweep(
        *_swept_layer((gate_types, controls, angles), last_layer),
        coords_qa, n_free, active, prefix, table,
        n_qubits, maxiter, reset_interval,
    )


def nft_layer_sweep_folded_launch(
    gate_types, controls, angles, layer_mask, last_layer, coords_qa,
    n_free, active, table, *, n_qubits: int, maxiter: int, reset_interval: int,
    initial_state=None,
):
    """The folded variant of :func:`nft_layer_sweep_launch`, same contract.
    The swept layer's CU3 compaction and group activity are static during
    the sweep: :func:`~queasars_tpu_torch.sim.fold_kernels.fold_sweep_metadata`
    computes them on the host from that layer's gate structure."""
    gate1, ctrl1, angles1 = _swept_layer((gate_types, controls, angles), last_layer)
    meta = fold_kernels.fold_sweep_metadata(gate1.cpu().numpy(), ctrl1.cpu().numpy(), n_qubits)
    meta = [torch.as_tensor(m, device=angles.device) for m in meta]
    pipeline = build_fold_pipeline(
        gate_types, controls, angles, prefix_mask(layer_mask, last_layer), n_qubits,
        absorb_diag=True,
    )
    prefix = fold_kernels.population_states_folded(pipeline, n_qubits, initial_state)
    return fold_kernels.nft_layer_sweep_folded(
        gate1, angles1, coords_qa, n_free, active, prefix, table, *meta,
        n_qubits, maxiter, reset_interval,
    )
