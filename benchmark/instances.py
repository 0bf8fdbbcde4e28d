"""Seeded random JSSP instances as plain data.

A frozen copy of the upstream QUEASARS generator
(job_shop_scheduling/random_problem_instances.py): the same ``Random`` call
sequence, so a seed gives the upstream instance.  An instance is
``{"jobs": [[[machine, duration], ...], ...]}`` with machines named
``m0 .. m{k-1}``.
"""

from __future__ import annotations

from math import isclose
from random import Random

from benchmark.reference.encoding import n_qubits


def _draw(value_or_distribution, rng: Random):
    if not isinstance(value_or_distribution, dict):
        return value_or_distribution
    if not isclose(sum(value_or_distribution.values()), 1, abs_tol=0.001):
        raise ValueError("distribution probabilities must sum to 1")
    return rng.choices(population=list(value_or_distribution),
                       weights=list(value_or_distribution.values()), k=1)[0]


def _numeric_keys(distribution):
    """JSON object keys are strings: durations and amounts are numbers."""
    if not isinstance(distribution, dict):
        return distribution
    return {float(k) if "." in str(k) else int(k): v for k, v in distribution.items()}


def random_instance(family: dict, seed: int) -> dict:
    """The instance of ``family`` (``n_jobs``, ``n_machines``,
    ``relative_op_amount``, ``op_duration``) drawn with ``seed``."""
    rng = Random(seed)
    machines = [f"m{i}" for i in range(family["n_machines"])]
    amount = _numeric_keys(family["relative_op_amount"])
    duration = _numeric_keys(family["op_duration"])
    jobs = []
    for _ in range(family["n_jobs"]):
        n_ops = round(_draw(amount, rng) * family["n_machines"])
        chosen = rng.sample(population=machines, k=n_ops)
        rng.shuffle(chosen)
        jobs.append([[machine, _draw(duration, rng)] for machine in chosen])
    return {"jobs": jobs}


def instances_with_qubits(family: dict, first_seed: int, count: int,
                          limit: int = 100000) -> list[tuple[int, dict]]:
    """The first ``count`` (seed, instance) pairs from ``first_seed`` on
    whose encoding has ``family["qubits"]`` qubits under
    ``family["makespan_limit"]``."""
    found = []
    for seed in range(first_seed, first_seed + limit):
        instance = random_instance(family, seed)
        try:
            width = n_qubits(instance, family["makespan_limit"])
        except ValueError:
            continue
        if width == family["qubits"]:
            found.append((seed, instance))
            if len(found) == count:
                return found
    raise ValueError(f"fewer than {count} instances with {family['qubits']} qubits")
