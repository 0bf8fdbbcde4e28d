"""Full-solver-state checkpointing: crash/preemption recovery that resumes
the *exact* trajectory.

Counterpart of ``queasars_tpu/solver/checkpoint.py`` with its
``FORMAT_TAG``, version and schema, so a checkpoint written by either
package resumes in the other.  The port's evaluators draw their shots from
threefry keys (``utils/prng.py``) indexed by the round counter, and nothing
on these paths draws from a ``torch.Generator``, so the counter is the
whole of the evaluator's consumable randomness.

The reference can only serialize results and populations
(base/serialization.py:20-260) — nothing restarts a solve, and a
population alone cannot reproduce the uninterrupted trajectory because the
operator RNGs, ledger and best-so-far live outside it.  This module
captures everything the generation loop mutates:

- the current population (post-pipeline),
- every evolutionary operator's ``random.Random`` state,
- the generation counter and the per-generation evaluation ledger,
- all population evaluation results so far (trajectory + termination
  replay input),
- the best individual/value so far,
- the evaluator's consumable randomness (the shot-key counter).

Resuming through ``resume_from_checkpoint=`` restores all of it, so
``crash at generation k -> resume`` produces bit-identical remaining
generations to the run that never crashed (pinned by
tests/test_torch_checkpoint.py).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from random import Random
from typing import Any, Optional

from queasars_tpu_torch.evolve.base import BasePopulationEvaluationResult
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.genome.serialization import (
    EVQEPopulationJSONDecoder,
    EVQEPopulationJSONEncoder,
)

FORMAT_TAG = "queasars_tpu_solver_state"
#: version 2: estimator ``precision`` consumable randomness is a sampler
#: shot counter (the multinomial noise law); version-1 checkpoints of
#: precision>0 solves carried a Gaussian ``noise_rng`` state instead,
#: which no current evaluator can consume — restoring one is rejected
#: loudly (see restore_evaluator_state) rather than silently resuming
#: under a different noise law
FORMAT_VERSION = 2


def _encode_population(obj):
    """Encode a population/individual of either genome family (EVQE layer
    genomes or QNEAT gene genomes — the current population may be QNEAT,
    evaluation results always carry lowered EVQE populations)."""
    from queasars_tpu_torch.genome.qneat import QNEATIndividual, QNEATPopulation
    from queasars_tpu_torch.genome.serialization import QNEATPopulationJSONEncoder

    if isinstance(obj, (QNEATPopulation, QNEATIndividual)):
        return QNEATPopulationJSONEncoder().default(obj)
    return EVQEPopulationJSONEncoder().default(obj)


def _decode_population(obj):
    from queasars_tpu_torch.genome.serialization import QNEATPopulationJSONDecoder

    text = json.dumps(obj)
    if isinstance(obj, dict) and "qneat_population_individuals" in obj:
        return QNEATPopulationJSONDecoder().decode(text)
    return EVQEPopulationJSONDecoder().decode(text)


def random_state_to_json(rng: Random) -> list:
    """``Random.getstate()`` as JSON-safe nested lists."""
    version, internal, gauss_next = rng.getstate()
    return [version, list(internal), gauss_next]


def random_state_from_json(payload: list) -> tuple:
    version, internal, gauss_next = payload
    return (version, tuple(internal), gauss_next)


def operator_rng_states(operators) -> list[dict[str, list]]:
    """Collect every ``random.Random`` attribute of every operator, keyed
    by attribute name (operators are matched by pipeline position)."""
    states: list[dict[str, list]] = []
    for operator in operators:
        entry = {
            name: random_state_to_json(value)
            for name, value in vars(operator).items()
            if isinstance(value, Random)
        }
        states.append(entry)
    return states


def restore_operator_rng_states(operators, states: list[dict[str, list]]) -> None:
    if len(states) != len(operators):
        raise ValueError(
            f"checkpoint has RNG states for {len(states)} operators, "
            f"but the pipeline has {len(operators)}"
        )
    for operator, entry in zip(operators, states):
        for name, payload in entry.items():
            rng = getattr(operator, name, None)
            if not isinstance(rng, Random):
                raise ValueError(f"operator {type(operator).__name__} has no RNG attribute {name!r}")
            rng.setstate(random_state_from_json(payload))


def evaluator_state(evaluator) -> dict[str, Any]:
    """Consumable randomness of an evaluator: its shot-key counter (the
    port's evaluators keep no other)."""
    if hasattr(evaluator, "_counter"):
        return {"counter": int(evaluator._counter)}
    return {}


def restore_evaluator_state(evaluator, state: dict[str, Any]) -> None:
    """Restore the shot-key counter; a version-1 Gaussian ``noise_rng``
    state is refused, since no evaluator here can consume it."""
    if "noise_rng" in state:
        raise ValueError(
            "checkpoint carries a Gaussian precision-noise RNG state "
            "(format version 1), but the configured evaluator realizes "
            "precision as multinomial shot sampling (format version 2+) "
            "and cannot consume it — resuming would continue under a "
            "different noise law than the original run.  Restart the "
            "solve instead of resuming this checkpoint."
        )
    if "counter" in state and hasattr(evaluator, "_counter"):
        evaluator._counter = int(state["counter"])


@dataclass
class SolverCheckpoint:
    """Deserialized full solver state (see module docstring)."""

    population: EVQEPopulation
    n_generations: int
    n_circuit_evaluations: list[int]
    population_evaluations: list[BasePopulationEvaluationResult]
    best_individual: Optional[EVQEIndividual]
    best_expectation_value: Optional[float]
    operator_rngs: list[dict[str, list]]
    evaluator: dict[str, Any]


def write_checkpoint(
    path: str,
    population: EVQEPopulation,
    n_generations: int,
    n_circuit_evaluations: list[int],
    population_evaluations: list[BasePopulationEvaluationResult],
    best_individual: Optional[EVQEIndividual],
    best_expectation_value: Optional[float],
    operators,
    evaluator,
) -> None:
    """Atomically persist the full solver state as one JSON file."""
    encoder = EVQEPopulationJSONEncoder()
    payload = {
        "format": FORMAT_TAG,
        "version": FORMAT_VERSION,
        "population": _encode_population(population),
        "n_generations": n_generations,
        "n_circuit_evaluations": list(n_circuit_evaluations),
        "population_evaluations": [
            {
                "population": encoder.default(result.population),
                "expectation_values": list(result.expectation_values),
                "best_individual": encoder.default(result.best_individual),
                "best_expectation_value": result.best_expectation_value,
            }
            for result in population_evaluations
        ],
        "best_individual": None if best_individual is None else encoder.default(best_individual),
        "best_expectation_value": best_expectation_value,
        "operator_rngs": operator_rng_states(operators),
        "evaluator": evaluator_state(evaluator),
    }
    tmp_path = path + ".tmp"
    with open(tmp_path, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp_path, path)


def load_checkpoint(path: str) -> SolverCheckpoint:
    """Load a full solver-state checkpoint (or, for backward
    compatibility, a population-only JSON, which restores with fresh
    counters and RNGs)."""
    with open(path) as fh:
        raw = fh.read()
    decoder = EVQEPopulationJSONDecoder()
    payload = json.loads(raw)
    if not (isinstance(payload, dict) and payload.get("format") == FORMAT_TAG):
        # population-only file written by older checkpoints
        return SolverCheckpoint(
            population=decoder.decode(raw),
            n_generations=0,
            n_circuit_evaluations=[],
            population_evaluations=[],
            best_individual=None,
            best_expectation_value=None,
            operator_rngs=[],
            evaluator={},
        )

    def decode_tree(obj):
        return decoder.decode(json.dumps(obj))

    evaluations = [
        BasePopulationEvaluationResult(
            population=decode_tree(entry["population"]),
            expectation_values=tuple(entry["expectation_values"]),
            best_individual=decode_tree(entry["best_individual"]),
            best_expectation_value=entry["best_expectation_value"],
        )
        for entry in payload["population_evaluations"]
    ]
    best = payload["best_individual"]
    return SolverCheckpoint(
        population=_decode_population(payload["population"]),
        n_generations=payload["n_generations"],
        n_circuit_evaluations=list(payload["n_circuit_evaluations"]),
        population_evaluations=evaluations,
        best_individual=None if best is None else decode_tree(best),
        best_expectation_value=payload["best_expectation_value"],
        operator_rngs=payload["operator_rngs"],
        evaluator=payload["evaluator"],
    )
