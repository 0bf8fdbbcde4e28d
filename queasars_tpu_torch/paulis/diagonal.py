"""Diagonal (Z/I-only) Pauli-sum evaluation: energy tables (PyTorch).

Counterpart of ``queasars_tpu/paulis/diagonal.py``.  A diagonal operator's
expectation reduces to ``sum_i |psi_i|^2 * e_i`` against the per-basis-state
energy table ``e_i = sum_k c_k * (-1)^popcount(z_k & i)``.

That table is the Walsh-Hadamard transform of the coefficient vector
indexed by Z mask, so it is computed as ``n`` butterfly passes over a
``[2^n]`` float64 vector (O(n 2^n), independent of the term count) on the
requested device, and cast on return.
"""

from __future__ import annotations

import numpy as np
import torch

from queasars_tpu_torch.paulis.pauli_sum import PauliSum


def diagonal_terms(op: PauliSum) -> tuple[np.ndarray, np.ndarray]:
    """Extract (coeffs_f64, z_masks_u64) from a diagonal PauliSum (n<=64)."""
    if not op.is_diagonal:
        raise ValueError("operator is not diagonal (contains X/Y terms)")
    if op.n_qubits > 64:
        raise NotImplementedError("diagonal tables limited to n<=64 qubits")
    coeffs = op.coeffs
    if np.abs(coeffs.imag).max(initial=0.0) > 1e-12:
        raise ValueError("diagonal operator must have real coefficients")
    return coeffs.real.astype(np.float64), op.z_masks_lo64()


def diagonal_energy_table(op: PauliSum, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Dense [2^n] energy table, accumulated in float64."""
    coeffs, z_masks = diagonal_terms(op)
    n = op.n_qubits
    if n > 30:
        raise NotImplementedError("dense energy tables limited to n<=30 qubits")
    table = torch.zeros(1 << n, dtype=torch.float64, device=device)
    table.index_add_(
        0,
        torch.as_tensor(z_masks.astype(np.int64), device=device),
        torch.as_tensor(coeffs, device=device),
    )
    # butterfly on bit q: (a, b) -> (a + b, a - b) — the sign flip where
    # bit q of both the mask and the basis index is set
    for q in range(n):
        view = table.view(-1, 2, 1 << q)
        low, high = view[:, 0, :].clone(), view[:, 1, :]
        view[:, 0, :] += high
        view[:, 1, :] = low - high
    return table.to(dtype)
