"""Stateful SPSA termination checker.

Counterpart of ``queasars_tpu/optim/spsa_termination.py`` (numpy only, the
same class), itself a behavioral port of
queasars/utility/spsa_termination.py:11-143: terminates
when the relative change in function value stays below a threshold for a
window of consecutive iterations, or when a maxfev cap is reached; tracks
the best value/parameters and the full value history; auto-resets when
reused on a fresh optimization (detected by a non-increasing evaluation
count, :59-66).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SPSATerminationChecker:
    """Callback-style termination state for SPSA runs.

    :param minimum_relative_change: relative change threshold
    :param allowed_consecutive_violations: consecutive below-threshold
        iterations tolerated before terminating (0 = terminate at first)
    :param maxfev: optional hard cap on function evaluations
    """

    def __init__(
        self,
        minimum_relative_change: float,
        allowed_consecutive_violations: int,
        maxfev: Optional[int] = None,
    ):
        self._minimum_relative_change = minimum_relative_change
        self._window = allowed_consecutive_violations + 1
        self._maxfev = maxfev
        self._reset()

    def _reset(self) -> None:
        self._values: list[float] = []
        self._changes: list[float] = []
        self._nfev = 0
        self._nfev_history: list[float] = []
        self._best_value = float("inf")
        self._best_parameters: Optional[np.ndarray] = None
        self._done = False

    def _record(self, nfev: int, parameters: np.ndarray, value: float) -> None:
        self._values.append(value)
        self._nfev_history.append(nfev)
        if value < self._best_value:
            self._best_value = value
            self._best_parameters = np.asarray(parameters).copy()

    def _stalled(self) -> bool:
        """True when the last ``window`` relative changes all sit below the
        threshold (the reference's consecutive-violation rule)."""
        if len(self._values) < 2:
            return False
        previous = self._values[-2]
        self._changes.append(abs(self._values[-1] - previous) / previous)
        recent = self._changes[-self._window :]
        return len(recent) >= self._window and max(recent) < self._minimum_relative_change

    def termination_check(
        self,
        n_function_evaluations: int,
        parameter_values: np.ndarray,
        function_value: float,
        step_size: float,
        accepted: bool,
    ) -> bool:
        """SPSA callback signature (nfev, x, fx, stepsize, accepted) -> stop?

        Reference: spsa_termination.py:48-96 (including the reuse
        auto-reset and the maxfev check preceding the accepted gate).
        """
        if self._done or n_function_evaluations < self._nfev:
            self._reset()
        self._nfev = n_function_evaluations

        if self._maxfev is not None and self._nfev >= self._maxfev:
            return True
        if not accepted:
            return False

        self._record(n_function_evaluations, parameter_values, function_value)
        if self._stalled():
            self._done = True
            return True
        return False

    @property
    def n_function_evaluations(self) -> int:
        return self._nfev

    @property
    def function_value_history(self) -> list[float]:
        return self._values

    @property
    def n_function_evaluation_history(self) -> list[float]:
        return self._nfev_history

    @property
    def best_function_value(self) -> float:
        return self._best_value

    @property
    def best_parameter_values(self) -> np.ndarray:
        if self._best_parameters is None:
            raise ValueError(
                "no accepted evaluation recorded yet — run the optimizer "
                "before reading best_parameter_values"
            )
        return self._best_parameters
