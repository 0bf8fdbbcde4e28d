"""Exact classical JSSP reference solvers.

Counterpart of ``queasars_tpu/problems/jssp/exact_solver.py`` (host code).

Replaces the reference's optional SCIP MILP path
(queasars/job_shop_scheduling/scip_solver.py) as the *validation oracle*:

- :func:`solve_jssp_exact` — branch-and-bound over operation start times;
  always available (pure Python, no native deps), exact optimal makespan.
- :class:`JSSPSCIPModelEncoder` — API-compatible MILP encoder, available
  only when ``pyscipopt`` is installed (same optional-extra stance as the
  reference, pyproject.toml:41-44).

The oracle is host-side and cold-path by design (reference scip_solver is
the same); it exists to pin the expected optimum in tests and examples.
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional

from queasars_tpu_torch.problems.jssp.problem_instances import (
    Job,
    JobShopSchedulingProblemInstance,
    JobShopSchedulingResult,
    Machine,
    Operation,
    PotentiallyScheduledOperation,
    ScheduledOperation,
)


def solve_jssp_exact(
    instance: JobShopSchedulingProblemInstance,
    makespan_limit: Optional[int] = None,
) -> Optional[JobShopSchedulingResult]:
    """Find a schedule with provably minimal makespan via branch-and-bound.

    Operations are scheduled job-order-first with per-machine busy interval
    tracking; the search prunes branches whose lower bound (current partial
    makespan) already exceeds the incumbent.  Returns None if no schedule
    fits within ``makespan_limit``.
    """
    operations: list[Operation] = [op for job in instance.jobs for op in job.operations]
    horizon = sum(op.processing_duration for op in operations)
    limit = horizon if makespan_limit is None else min(makespan_limit, horizon)

    # per-job remaining-duration tail (for earliest-finish lower bounds)
    job_tail: dict[Operation, int] = {}
    for job in instance.jobs:
        tail = 0
        for op in reversed(job.operations):
            tail += op.processing_duration
            job_tail[op] = tail

    best_makespan: list[Optional[int]] = [None]
    best_assignment: list[Optional[dict[Operation, int]]] = [None]

    machine_busy: dict[Machine, list[tuple[int, int]]] = {m: [] for m in instance.machines}
    assignment: dict[Operation, int] = {}

    def overlaps(machine: Machine, start: int, end: int) -> bool:
        return any(start < b_end and b_start < end for b_start, b_end in machine_busy[machine])

    def recurse(job_idx: int, op_idx: int, current_makespan: int) -> None:
        if job_idx == len(instance.jobs):
            if best_makespan[0] is None or current_makespan < best_makespan[0]:
                best_makespan[0] = current_makespan
                best_assignment[0] = dict(assignment)
            return
        job = instance.jobs[job_idx]
        if op_idx == len(job.operations):
            recurse(job_idx + 1, 0, current_makespan)
            return
        op = job.operations[op_idx]
        earliest = 0
        if op_idx > 0:
            prev = job.operations[op_idx - 1]
            earliest = assignment[prev] + prev.processing_duration
        # latest start so the job tail still fits the limit
        latest = limit - job_tail[op]
        for start in range(earliest, latest + 1):
            end = start + op.processing_duration
            bound = max(current_makespan, end)
            if best_makespan[0] is not None and bound >= best_makespan[0]:
                break  # starts only grow; nothing later can improve
            if overlaps(op.machine, start, end):
                continue
            assignment[op] = start
            machine_busy[op.machine].append((start, end))
            recurse(job_idx, op_idx + 1, bound)
            machine_busy[op.machine].pop()
            del assignment[op]

    recurse(0, 0, 0)
    if best_assignment[0] is None:
        return None

    schedule: dict[Job, tuple[PotentiallyScheduledOperation, ...]] = {}
    for job in instance.jobs:
        schedule[job] = tuple(
            ScheduledOperation(operation=op, start_time=best_assignment[0][op]) for op in job.operations
        )
    return JobShopSchedulingResult(problem_instance=instance, schedule=schedule)


class JSSPSCIPModelEncoder:
    """MILP encoder mirroring the reference's pyscipopt model.

    Same model shape as queasars/job_shop_scheduling/scip_solver.py:21-167:
    integer start variables with lb=0, an integer makespan objective variable,
    job-order precedence constraints, and binary order variables per machine
    operation pair for big-M-free disjunctive non-overlap.

    Raises ImportError at construction when pyscipopt is unavailable.
    """

    def __init__(self, jssp_instance: JobShopSchedulingProblemInstance):
        try:
            from pyscipopt import Model  # noqa: PLC0415
        except ImportError as exc:  # pragma: no cover - optional dependency
            raise ImportError(
                "JSSPSCIPModelEncoder requires pyscipopt; install it or use "
                "queasars_tpu_torch.problems.jssp.exact_solver.solve_jssp_exact instead."
            ) from exc

        self._jssp_instance = jssp_instance
        self._machine_operations: dict[Machine, list[Operation]] = {
            machine: [] for machine in jssp_instance.machines
        }
        for job in jssp_instance.jobs:
            for operation in job.operations:
                self._machine_operations[operation.machine].append(operation)

        self._model = Model()
        self._variables_prepared = False
        self._constraints_prepared = False
        self._optimization_var = None
        self._operation_start_variables: dict[Operation, object] = {}

    def get_model(self):
        """Build (once) and return the SCIP model (reference: scip_solver.py:52-65)."""
        if not self._variables_prepared:
            self._prepare_variables()
        if not self._constraints_prepared:
            self._prepare_constraints()
        return self._model

    def parse_solution(self, solution) -> JobShopSchedulingResult:
        """Parse a SCIP solution into a schedule (reference: scip_solver.py:67-84)."""
        job_schedules: dict[Job, tuple[PotentiallyScheduledOperation, ...]] = {}
        for job in self._jssp_instance.jobs:
            entries: list[PotentiallyScheduledOperation] = []
            for operation in job.operations:
                start_time = int(solution[self._operation_start_variables[operation]])
                entries.append(ScheduledOperation(operation=operation, start_time=start_time))
            job_schedules[job] = tuple(entries)
        return JobShopSchedulingResult(problem_instance=self._jssp_instance, schedule=job_schedules)

    def _prepare_variables(self):
        """Integer start vars (lb=0) + makespan objective var
        (reference: scip_solver.py:86-108)."""
        if self._variables_prepared:
            return
        self._optimization_var = self._model.addVar("optimization_var", vtype="INTEGER", lb=0)
        self._model.setObjective(self._optimization_var)
        for job in self._jssp_instance.jobs:
            for operation in job.operations:
                self._operation_start_variables[operation] = self._model.addVar(
                    operation.identifier, vtype="INTEGER", lb=0
                )
        self._variables_prepared = True

    def _prepare_constraints(self):
        """Precedence + disjunctive machine non-overlap constraints
        (reference: scip_solver.py:110-167)."""
        if self._constraints_prepared:
            return
        if not self._variables_prepared:
            self._prepare_variables()

        for job in self._jssp_instance.jobs:
            for i in range(len(job.operations) - 1):
                self._model.addCons(
                    self._operation_start_variables[job.operations[i]] + job.operations[i].processing_duration
                    <= self._operation_start_variables[job.operations[i + 1]],
                    name=f"precedence_{job.operations[i].identifier}_{job.operations[i + 1].identifier}",
                )
            last = job.operations[-1]
            self._model.addCons(
                self._operation_start_variables[last] + last.processing_duration <= self._optimization_var,
                name=f"makespan_{last.identifier}",
            )

        for machine, operations in self._machine_operations.items():
            for op_1, op_2 in combinations(operations, 2):
                order_var = self._model.addVar(
                    f"order_{op_1.identifier}_{op_2.identifier}", vtype="BINARY"
                )
                self._model.addCons(
                    order_var * (self._operation_start_variables[op_1] + op_1.processing_duration)
                    <= self._operation_start_variables[op_2],
                    name=f"order1_{op_1.identifier}_{op_2.identifier}_{machine.name}",
                )
                self._model.addCons(
                    (1 - order_var) * (self._operation_start_variables[op_2] + op_2.processing_duration)
                    <= self._operation_start_variables[op_1],
                    name=f"order2_{op_2.identifier}_{op_1.identifier}_{machine.name}",
                )
        self._constraints_prepared = True
