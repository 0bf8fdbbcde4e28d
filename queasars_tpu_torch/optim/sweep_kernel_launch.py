"""Launchers for the last-layer NFT sweep.

Counterpart of ``queasars_tpu/optim/sweep_kernel_launch.py``.  Two variants
share the contract, and :func:`nft_layer_sweep_launch` takes the one
``routes.fold_enabled`` picks (path ``"sweep"``), as the objective's entry
points do:

- slot: prefix states from the slot states kernel, then the whole
  ``maxiter`` sweep on the slot sweep kernel;
- folded (:func:`nft_layer_sweep_folded_launch`): prefix states on the fold
  route (``routes.states``), then the folded sweep, which applies the swept
  layer as two kron layers and a phase pass with that layer's factors
  rebuilt on the card from the current angles.

On the card each sweep first reads the steps at which some individual's
probed qubit changes back to the host (``slot_kernels.sweep_transitions``,
one wait), and the folded variant also copies the swept layer's gate
structure to the host to build the sweep metadata there, as the reference
does (``wait.fold_sweep_metadata``).  The step loops only enqueue launches.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.optim.prefix import prefix_mask
from queasars_tpu_torch.sim import fold_kernels, routes, slot_kernels
from queasars_tpu_torch.utils.profiling import span, spanned


def _swept_layer(tensors, last_layer):
    """Each individual's ``last_layer`` slice of [P, L, ...] tensors."""
    rows = torch.arange(last_layer.shape[0], device=last_layer.device)
    return [t[rows, last_layer].contiguous() for t in tensors]


@spanned("evaluator.nft_layer_sweep_launch")
def nft_layer_sweep_launch(
    gate_types, controls, angles, layer_mask, last_layer, coords_qa,
    n_free, active, table, *, n_qubits: int, maxiter: int, reset_interval: int,
    initial_state=None,
):
    """Device tensors in (genome [P, L, n] tensors, ``last_layer`` [P]
    long, ``coords_qa`` [P, K, 2] int32, ``n_free`` [P] int32, ``active``
    [P] bool, ``table`` [2^n]); returns (optimized layer angles [P, n, 3],
    final energies [P]) from the variant ``routes.fold_enabled`` picks."""
    if routes.fold_enabled(None, n_qubits, "sweep", angles.device):
        return nft_layer_sweep_folded_launch(
            gate_types, controls, angles, layer_mask, last_layer, coords_qa, n_free, active,
            table, n_qubits=n_qubits, maxiter=maxiter, reset_interval=reset_interval,
            initial_state=initial_state,
        )
    prefix = routes.states(
        gate_types, controls, angles, prefix_mask(layer_mask, last_layer), n_qubits,
        initial_state, fold=False,
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
    with span("wait.fold_sweep_metadata"):
        gate1_host, ctrl1_host = gate1.cpu().numpy(), ctrl1.cpu().numpy()
    meta = fold_kernels.fold_sweep_metadata(gate1_host, ctrl1_host, n_qubits)
    meta = [torch.as_tensor(m, device=angles.device) for m in meta]
    prefix = routes.states(
        gate_types, controls, angles, prefix_mask(layer_mask, last_layer), n_qubits,
        initial_state, fold=True,
    )
    return fold_kernels.nft_layer_sweep_folded(
        gate1, angles1, coords_qa, n_free, active, prefix, table, *meta,
        n_qubits, maxiter, reset_interval,
    )
