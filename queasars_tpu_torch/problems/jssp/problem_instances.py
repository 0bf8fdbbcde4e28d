"""JSSP data model: validated frozen dataclasses and schedule results.

Behavioral port of queasars/job_shop_scheduling/problem_instances.py:11-431
(same validation rules, same identifier/makespan/validity semantics) with no
Qiskit dependency.  These objects are host-side only; the device never sees
them — the encoder lowers everything to packed Pauli masks.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from textwrap import indent
from typing import Optional, cast

from typing import TypeGuard


class JobShopSchedulingProblemException(Exception):
    """Raised for invalid job shop scheduling data.

    Reference: problem_instances.py:430-431.
    """


@dataclass(frozen=True)
class Machine:
    """A machine on which operations run. Reference: problem_instances.py:11-26."""

    name: str

    def __post_init__(self):
        if self.name == "":
            raise JobShopSchedulingProblemException("a Machine needs a non-empty name")

    def __repr__(self):
        return self.name


@dataclass(frozen=True)
class Operation:
    """One processing step of a job. Reference: problem_instances.py:29-73.

    :param name: operation identifier, unique within its job
    :param job_name: name of the owning job (must match)
    :param machine: machine the operation runs on
    :param processing_duration: time units needed, >= 1
    """

    name: str
    job_name: str
    machine: Machine
    processing_duration: int

    @property
    def identifier(self) -> str:
        """``job_name + "_" + name`` — unique in a valid instance
        (reference: problem_instances.py:52-60)."""
        return self.job_name + "_" + self.name

    def __post_init__(self):
        if self.name == "":
            raise JobShopSchedulingProblemException("an Operation needs a non-empty name")
        if self.job_name == "":
            raise JobShopSchedulingProblemException("an Operation needs a non-empty job_name")
        if self.processing_duration <= 0:
            raise JobShopSchedulingProblemException(
                f"processing_duration must be >= 1 (got {self.processing_duration})"
            )

    def __repr__(self):
        return f"{self.identifier}({self.machine.name}, {self.processing_duration})"


@dataclass(frozen=True)
class Job:
    """An ordered tuple of operations. Reference: problem_instances.py:76-138.

    Validation: non-empty name, >= 1 operation, unique operation identifiers,
    matching job_name on every operation, no machine visited twice.
    """

    name: str
    operations: tuple[Operation, ...]

    def is_consistent_with_machines(self, machines: tuple[Machine, ...]) -> bool:
        """True if all operations use only the given machines
        (reference: problem_instances.py:91-103)."""
        return all(operation.machine in machines for operation in self.operations)

    def __post_init__(self):
        if self.name == "":
            raise JobShopSchedulingProblemException("a Job needs a non-empty name")
        if len(self.operations) == 0:
            raise JobShopSchedulingProblemException(
                "a Job needs at least one Operation (got none)"
            )
        identifiers = {operation.identifier for operation in self.operations}
        if len(identifiers) != len(self.operations):
            raise JobShopSchedulingProblemException("duplicate operation identifiers within one Job")
        visited: set[Machine] = set()
        for operation in self.operations:
            if operation.job_name != self.name:
                raise JobShopSchedulingProblemException(
                    f"operation carries job_name {operation.job_name!r} inside job {self.name!r}"
                )
            if operation.machine in visited:
                raise JobShopSchedulingProblemException(
                    f"machine {operation.machine} appears in several of this job's operations"
                )
            visited.add(operation.machine)

    def __repr__(self):
        body = "".join(str(op) + "\n" for op in self.operations)
        return f"{self.name}:\n" + indent(body, "  ")


@dataclass(frozen=True)
class JobShopSchedulingProblemInstance:
    """A full JSSP instance. Reference: problem_instances.py:141-200.

    Validation: non-empty name, unique machines, unique job names, jobs only
    visit declared machines.
    """

    name: str
    machines: tuple[Machine, ...]
    jobs: tuple[Job, ...]

    def __post_init__(self):
        if self.name == "":
            raise JobShopSchedulingProblemException(
                "a JobShopSchedulingProblemInstance needs a non-empty name"
            )
        if len(set(self.machines)) != len(self.machines):
            raise JobShopSchedulingProblemException(
                "duplicate Machines in the problem instance"
            )
        if len({job.name for job in self.jobs}) != len(self.jobs):
            raise JobShopSchedulingProblemException(
                "duplicate Job names in the problem instance"
            )
        for job in self.jobs:
            if not job.is_consistent_with_machines(machines=self.machines):
                raise JobShopSchedulingProblemException(
                    "a Job references a Machine the problem instance does not list "
                    + "in its machines attribute"
                )

    def __repr__(self):
        machines = "".join(str(m) + "\n" for m in self.machines)
        jobs = "".join(str(j) for j in self.jobs)
        return (
            self.name
            + "\n"
            + indent("Machines:\n", "  ")
            + indent(machines, "    ")
            + indent("Jobs:\n", "  ")
            + indent(jobs, "    ")
        )


@dataclass(frozen=True)
class PotentiallyScheduledOperation(ABC):
    """Scheduling status of one operation. Reference: problem_instances.py:203-220."""

    operation: Operation

    @property
    @abstractmethod
    def is_scheduled(self) -> bool:
        """Whether the operation was successfully scheduled."""


@dataclass(frozen=True)
class UnscheduledOperation(PotentiallyScheduledOperation):
    """An operation that could not be scheduled. Reference: problem_instances.py:223-237."""

    @property
    def is_scheduled(self) -> bool:
        return False

    def __repr__(self):
        return f"{str(self.operation)} was not scheduled."


@dataclass(frozen=True)
class ScheduledOperation(PotentiallyScheduledOperation):
    """An operation scheduled at ``start_time``. Reference: problem_instances.py:240-267."""

    start_time: int

    @property
    def is_scheduled(self) -> bool:
        return True

    @property
    def end_time(self) -> int:
        return self.start_time + self.operation.processing_duration

    def __repr__(self):
        return f"{str(self.operation)} starts at: {self.start_time} and ends at: {self.end_time}"


def ensure_all_operations_are_scheduled(
    schedule: dict[Job, tuple[PotentiallyScheduledOperation, ...]],
) -> TypeGuard[dict[Job, tuple[ScheduledOperation, ...]]]:
    """TypeGuard: every operation in the schedule is actually scheduled
    (reference: problem_instances.py:270-286)."""
    return all(
        all(not isinstance(op, UnscheduledOperation) for op in job_schedule)
        for job_schedule in schedule.values()
    )


class JobShopSchedulingResult:
    """An attempted solution to a JSSP instance.

    Reference: problem_instances.py:289-427 — same construction checks
    (schedule covers exactly the instance's jobs with identically ordered
    operations), lazy validity (job order + machine overlap) and makespan.
    """

    def __init__(
        self,
        problem_instance: JobShopSchedulingProblemInstance,
        schedule: dict[Job, tuple[PotentiallyScheduledOperation, ...]],
    ):
        if set(problem_instance.jobs) != set(schedule.keys()):
            raise JobShopSchedulingProblemException(
                "the result schedules a different Job set than the problem "
                + "instance it claims to solve"
            )
        for job in problem_instance.jobs:
            if job.operations != tuple(entry.operation for entry in schedule[job]):
                raise JobShopSchedulingProblemException(
                    "a Job's schedule covers a different operation set than the Job defines"
                )
        self._problem_instance = problem_instance
        self._schedule = schedule
        self._is_valid: Optional[bool] = None
        self._makespan: Optional[int] = None

    @property
    def problem_instance(self) -> JobShopSchedulingProblemInstance:
        return self._problem_instance

    @property
    def schedule(self) -> dict[Job, tuple[PotentiallyScheduledOperation, ...]]:
        return self._schedule

    @property
    def valid_schedule(self) -> dict[Job, tuple[ScheduledOperation, ...]]:
        """The schedule, narrowed to ScheduledOperation, if valid — else raises
        (reference: problem_instances.py:340-351)."""
        if self.is_valid:
            return cast("dict[Job, tuple[ScheduledOperation, ...]]", self._schedule)
        raise JobShopSchedulingProblemException(
            "this result is not a valid schedule; valid_schedule is unavailable"
        )

    @property
    def is_valid(self) -> bool:
        if self._is_valid is None:
            self._is_valid = self._check_valid()
        return self._is_valid

    @property
    def makespan(self) -> Optional[int]:
        """Latest end time across jobs, or None if invalid
        (reference: problem_instances.py:365-379)."""
        if not self.is_valid:
            return None
        if self._makespan is None:
            self._makespan = max(ops[-1].end_time for ops in self.valid_schedule.values())
        return self._makespan

    def _check_valid(self) -> bool:
        """Job-order and machine-overlap validity
        (reference: problem_instances.py:381-418)."""
        if not ensure_all_operations_are_scheduled(self._schedule):
            return False
        schedule = cast("dict[Job, tuple[ScheduledOperation, ...]]", self._schedule)

        per_machine: dict[Machine, list[ScheduledOperation]] = {
            machine: [] for machine in self._problem_instance.machines
        }
        for job in self._problem_instance.jobs:
            previous: Optional[ScheduledOperation] = None
            for scheduled in schedule[job]:
                per_machine[scheduled.operation.machine].append(scheduled)
                if previous is not None and scheduled.start_time < previous.end_time:
                    return False
                previous = scheduled

        for machine_ops in per_machine.values():
            previous = None
            for scheduled in sorted(machine_ops, key=lambda s: s.start_time):
                if previous is not None and scheduled.start_time < previous.end_time:
                    return False
                previous = scheduled
        return True

    def __repr__(self):
        header = f"{self._problem_instance.name}: schedule, makespan {self.makespan}\n"
        text = ""
        for job in self._problem_instance.jobs:
            text += indent(f"{job.name}:\n", "  ")
            for scheduled in self._schedule[job]:
                text += indent(f"{str(scheduled)}\n", "    ")
        return header + text
