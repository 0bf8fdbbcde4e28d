"""Launcher for the last-layer NFT sweep on the slot kernels.

Counterpart of the slot variant of ``queasars_tpu/optim/sweep_kernel_launch.py``
(``nft_layer_sweep_launch``): prefix states from the states kernel, then the
whole ``maxiter`` sweep from those states.  On the card neither step
synchronises with the host.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.optim.prefix import prefix_mask
from queasars_tpu_torch.sim import slot_kernels


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
    rows = torch.arange(gate_types.shape[0], device=gate_types.device)
    return slot_kernels.nft_layer_sweep(
        gate_types[rows, last_layer].contiguous(),
        controls[rows, last_layer].contiguous(),
        angles[rows, last_layer].contiguous(),
        coords_qa, n_free, active, prefix, table,
        n_qubits, maxiter, reset_interval,
    )
