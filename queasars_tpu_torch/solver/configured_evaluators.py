"""Evaluator configuration records.

Analog of queasars/circuit_evaluation/configured_primitives.py:9-22: the
reference pairs a primitive with its shot/precision setting so the config
travels with it; here the records carry what is needed to build the
evaluators (there is no opaque primitive object to wrap).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ConfiguredSampler:
    """Shot-based evaluation settings (analog of ConfiguredSamplerV2,
    configured_primitives.py:9-14).

    :param shots: measurement shots per circuit evaluation
    :param seed: RNG seed for the measurement sampling
    :param shot_allocation: for non-diagonal operators (measured via QWC
        grouping), how the groups share the budget — ``"per_group"``
        (default: every group gets ``shots``) or ``"proportional"``
        (``shots`` is the total, split across groups by their coefficient
        L1 norms — the variance-optimal rule).  Ignored for diagonal
        operators
    """

    shots: int
    seed: int = 0
    shot_allocation: str = "per_group"

    def __post_init__(self):
        if self.shots < 1:
            raise ValueError("shots must be at least 1")
        if self.shot_allocation not in ("per_group", "proportional"):
            raise ValueError("shot_allocation must be 'per_group' or 'proportional'")


@dataclass
class ConfiguredEstimator:
    """Expectation-path settings (analog of ConfiguredEstimatorV2,
    configured_primitives.py:17-22).

    :param precision: target standard error of each reported energy; the
        reference forwards this to Aer's shot-noise model
        (circuit_evaluation.py:210-213), here it is realized the same way
        — ``ceil(precision**-2)`` multinomial measurement shots per
        evaluation through the sampler machinery (seeded, checkpointable).
        None or 0 = exact (deterministic) evaluation.  For non-diagonal
        operators the shots go through QWC measurement grouping with
        per-group allocation, so the realized total standard error can
        exceed ``precision`` when there is more than one group — see
        StatevectorExpectationEvaluator's precision note.
    :param seed: RNG seed for the precision shot stream
    """

    precision: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.precision is not None and self.precision < 0:
            raise ValueError("precision must be non-negative")
