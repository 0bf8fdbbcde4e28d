"""COBYLA host optimizer (API-parity cold path).

Counterpart of ``queasars_tpu/optim/cobyla.py``.  The reference supports
any qiskit-algorithms optimizer including COBYLA (SciPy Fortran under the
hood).  Here COBYLA wraps ``scipy.optimize.minimize`` against the
evaluator's batched population energies (on the card, the slot energies
kernel) for one individual at a time: sequential by design, a
compatibility path, not the hot path (use
:class:`~queasars_tpu_torch.optim.nft.BatchedNFT` or
:class:`~queasars_tpu_torch.optim.spsa.BatchedSPSA` for population-scale
runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy.optimize import minimize as scipy_minimize

from queasars_tpu_torch.genome.packing import PackedPopulation


@dataclass(frozen=True)
class CobylaConfig:
    maxiter: int = 100
    rhobeg: float = 0.5
    tol: float = 1e-4


class ScipyCobyla:
    """Per-individual COBYLA over the free-parameter coordinates."""

    def __init__(self, config: CobylaConfig = CobylaConfig()):
        self.config = config

    def minimize(
        self,
        evaluator,
        packed: PackedPopulation,
        coords: np.ndarray,
        n_free: np.ndarray,
        active: np.ndarray,
        angles: Optional[np.ndarray] = None,
        seed: int = 0,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Same contract as BatchedNFT.minimize (sequential inside)."""
        current = np.array(packed.angles if angles is None else angles, copy=True)
        total_nfev = 0
        for i in range(packed.n_individuals):
            if not active[i] or n_free[i] == 0:
                continue
            c = coords[i, : n_free[i]]
            x0 = np.array([current[i, l, q, k] for l, q, k in c], dtype=np.float64)

            def fun(x, i=i, c=c):
                trial = current.copy()
                for (l, q, k), value in zip(c, x):
                    trial[i, l, q, k] = value
                return float(evaluator.evaluate_packed(packed, angles=trial)[i])

            result = scipy_minimize(
                fun,
                x0,
                method="COBYLA",
                options={"maxiter": self.config.maxiter, "rhobeg": self.config.rhobeg},
                tol=self.config.tol,
            )
            for (l, q, k), value in zip(c, result.x):
                current[i, l, q, k] = float(value)
            total_nfev += int(result.nfev)
        energies = np.asarray(evaluator.evaluate_packed(packed, angles=current))
        return current, energies, total_nfev
