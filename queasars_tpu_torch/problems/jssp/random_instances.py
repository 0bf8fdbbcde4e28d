"""Seeded random JSSP instance generation.

Behavioral port of queasars/job_shop_scheduling/random_problem_instances.py:
14-101 (value-or-distribution specs, same naming scheme m{i}/job{i}/op{j},
same Random call order so identical seeds yield identical instances).
"""

from __future__ import annotations

from math import isclose
from random import Random
from typing import Optional, TypeVar, Union

from queasars_tpu_torch.problems.jssp.problem_instances import (
    Job,
    JobShopSchedulingProblemInstance,
    Machine,
    Operation,
)

T = TypeVar("T")


def _get_random_value_from_distribution(distribution: dict[T, float], random_generator: Random) -> T:
    """Draw one key of ``distribution`` weighted by its probability value
    (reference: random_problem_instances.py:14-28)."""
    if not isclose(sum(distribution.values()), 1, abs_tol=0.001):
        raise ValueError("distribution probabilities must sum to 1")
    return random_generator.choices(
        population=list(distribution.keys()), weights=list(distribution.values()), k=1
    )[0]


def _get_value(value_or_distribution: Union[T, dict[T, float]], random_generator: Random) -> T:
    if isinstance(value_or_distribution, dict):
        return _get_random_value_from_distribution(value_or_distribution, random_generator)
    return value_or_distribution


def random_job_shop_scheduling_instance(
    instance_name: str,
    n_jobs: int,
    n_machines: int,
    relative_op_amount: Union[float, dict[float, float]],
    op_duration: Union[int, dict[int, float]],
    random_seed: Optional[int] = None,
) -> JobShopSchedulingProblemInstance:
    """Generate a seeded random JSSP instance.

    :param relative_op_amount: operations per job relative to n_machines
        (value or probability distribution)
    :param op_duration: processing duration per operation (value or
        probability distribution)

    Reference: random_problem_instances.py:49-101 (identical sampling
    sequence: per job draw op count, ``sample`` machines, ``shuffle``, then
    draw durations in operation order).
    """
    random_generator = Random(random_seed)
    machines = tuple(Machine(f"m{i}") for i in range(n_machines))

    jobs: list[Job] = []
    for i in range(n_jobs):
        n_ops = round(_get_value(relative_op_amount, random_generator) * n_machines)
        op_machines = random_generator.sample(population=machines, k=n_ops)
        random_generator.shuffle(op_machines)
        operations = tuple(
            Operation(
                name=f"op{j}",
                job_name=f"job{i}",
                machine=op_machine,
                processing_duration=_get_value(op_duration, random_generator),
            )
            for j, op_machine in enumerate(op_machines)
        )
        jobs.append(Job(name=f"job{i}", operations=operations))

    return JobShopSchedulingProblemInstance(name=instance_name, machines=machines, jobs=tuple(jobs))
