"""Validated wrapper for black-box bitstring objective functions.

Counterpart of ``queasars_tpu/utils/bitstring_evaluation.py`` (behavioral
port of queasars/circuit_evaluation/bitstring_evaluation.py:7-57); host code,
consumed by ``sim/evaluators.py::BitstringFunctionEvaluator``.
"""

from __future__ import annotations

from typing import Callable


class BitstringEvaluationException(Exception):
    """Raised when a bitstring objective cannot be evaluated."""


class BitstringEvaluator:
    """Wraps ``Callable[[str], float]`` with input-length validation.

    :param input_length: exact length of bitstrings this evaluator accepts
    :param evaluation_function: maps a '0'/'1' string to a float

    Reference: queasars/circuit_evaluation/bitstring_evaluation.py:7-57.
    """

    def __init__(self, input_length: int, evaluation_function: Callable[[str], float]):
        if input_length < 1:
            raise ValueError("input_length must be at least 1!")
        self._input_length = input_length
        self._evaluation_function = evaluation_function

    @property
    def input_length(self) -> int:
        return self._input_length

    def evaluate_bitstring(self, bitstring: str) -> float:
        """Validate then apply the wrapped function.

        Reference: bitstring_evaluation.py:20-48 (length check, charset
        check, result-type check).
        """
        if len(bitstring) != self._input_length:
            raise BitstringEvaluationException(
                f"Bitstring length {len(bitstring)} does not match the "
                f"expected input length {self._input_length}!"
            )
        if any(ch not in "01" for ch in bitstring):
            raise BitstringEvaluationException(
                "Bitstrings may only contain the characters 0 and 1!"
            )
        result = self._evaluation_function(bitstring)
        if not isinstance(result, (int, float)):
            raise BitstringEvaluationException(
                "The evaluation function must return a real number!"
            )
        return float(result)
