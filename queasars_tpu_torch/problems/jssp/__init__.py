"""Job Shop Scheduling problem domain: data model, domain-wall Hamiltonian
encoder, random instance generation and the exact branch-and-bound oracle
(port of queasars_tpu/problems/jssp/).
"""

from queasars_tpu_torch.problems.jssp.problem_instances import (
    Machine,
    Operation,
    Job,
    JobShopSchedulingProblemInstance,
    PotentiallyScheduledOperation,
    UnscheduledOperation,
    ScheduledOperation,
    JobShopSchedulingResult,
    JobShopSchedulingProblemException,
    ensure_all_operations_are_scheduled,
)
from queasars_tpu_torch.problems.jssp.domain_wall_variables import DomainWallVariable
from queasars_tpu_torch.problems.jssp.encoder import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance,
)
from queasars_tpu_torch.problems.jssp.exact_solver import solve_jssp_exact

__all__ = [
    "Machine",
    "Operation",
    "Job",
    "JobShopSchedulingProblemInstance",
    "PotentiallyScheduledOperation",
    "UnscheduledOperation",
    "ScheduledOperation",
    "JobShopSchedulingResult",
    "JobShopSchedulingProblemException",
    "ensure_all_operations_are_scheduled",
    "DomainWallVariable",
    "JSSPDomainWallHamiltonianEncoder",
    "random_job_shop_scheduling_instance",
    "solve_jssp_exact",
]
