"""Time-indexed JSSP -> diagonal Pauli-sum Hamiltonian (domain-wall encoding).

Behavioral port of
queasars/job_shop_scheduling/domain_wall_hamiltonian_encoder.py:23-373,
producing a :class:`~queasars_tpu_torch.paulis.pauli_sum.PauliSum` (Z/I-only) whose
energy table matches the reference Hamiltonian's eigenvalues to 1e-8 on
exhaustive small-instance spectra.  All coefficient accumulation happens in
float64 on the host (the exponential makespan weights
``(n_jobs+1)**makespan_limit`` overflow float32 quickly — reference:
domain_wall_hamiltonian_encoder.py:335).

Hamiltonian structure (reference: _prepare_hamiltonian, :189-230):

  H =   precedence_penalty * sum(precedence terms)
      + overlap_penalty    * sum(machine-overlap terms)
      + encoding_penalty   * sum((1 + max_constraints) * viability terms)
      + max_opt_value * (1 - share) * makespan term
      + max_opt_value * share       * early-start term
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional

from queasars_tpu_torch.paulis import PauliSum, pauli_identity_string
from queasars_tpu_torch.problems.jssp.domain_wall_variables import DomainWallVariable
from queasars_tpu_torch.problems.jssp.problem_instances import (
    Job,
    JobShopSchedulingProblemInstance,
    JobShopSchedulingResult,
    Machine,
    Operation,
    PotentiallyScheduledOperation,
    ScheduledOperation,
    UnscheduledOperation,
)
from queasars_tpu_torch.utils.profiling import spanned


class JSSPDomainWallHamiltonianEncoder:
    """Encodes a JSSP instance as a diagonal Hamiltonian.

    :param jssp_instance: the problem to encode
    :param makespan_limit: maximum allowed makespan of candidate solutions
    :param encoding_penalty: penalty for breaking a domain-wall variable
    :param overlap_constraint_penalty: penalty for machine-overlap violations
        (must be < encoding_penalty)
    :param precedence_constraint_penalty: penalty for precedence violations
        (must be < encoding_penalty)
    :param max_opt_value: upper bound of the optimization term (should be
        smaller than each penalty for a clean valid/invalid separation)
    :param opt_all_operations_share: share of max_opt_value diverted from
        the makespan term to the linear early-start term, in [0, 1]

    Reference: domain_wall_hamiltonian_encoder.py:23-75 (same defaults).
    """

    @spanned("encode")
    def __init__(
        self,
        jssp_instance: JobShopSchedulingProblemInstance,
        makespan_limit: int,
        encoding_penalty: float = 300,
        overlap_constraint_penalty: float = 100,
        precedence_constraint_penalty: float = 100,
        max_opt_value: float = 100,
        opt_all_operations_share: float = 0,
    ):
        self.jssp_instance = jssp_instance
        self.makespan_limit = makespan_limit
        self._encoding_prepared = False
        self._hamiltonian_prepared = False
        self._machine_operations: dict[Machine, list[Operation]] = {}
        self._operation_start_variables: dict[Operation, DomainWallVariable[int]] = {}
        self._operation_constraint_counts: dict[tuple[Operation, int], int] = {}
        self._n_qubits = 0
        self._hamiltonian: Optional[PauliSum] = None
        self._encoding_penalty = encoding_penalty
        self._overlap_constraint_penalty = overlap_constraint_penalty
        self._precedence_constraint_penalty = precedence_constraint_penalty
        self._max_opt_value = max_opt_value
        self._opt_all_operations_share = opt_all_operations_share

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def n_qubits(self) -> int:
        """Qubits needed to encode the instance (reference: :77-85)."""
        if not self._encoding_prepared:
            self._prepare_encoding()
        return self._n_qubits

    @spanned("encode")
    def get_problem_hamiltonian(self) -> PauliSum:
        """The problem Hamiltonian as a diagonal PauliSum (reference: :87-104)."""
        if not self._encoding_prepared:
            self._prepare_encoding()
        if not self._hamiltonian_prepared:
            self._prepare_hamiltonian()
        assert self._hamiltonian is not None
        return self._hamiltonian

    def translate_result_bitstring(self, bitstring: str) -> JobShopSchedulingResult:
        """Decode a measured bitstring into a schedule.

        The bitstring is in measurement order (leftmost char = highest qubit),
        exactly like the reference which reverses it before decoding
        (domain_wall_hamiltonian_encoder.py:121).
        """
        if len(bitstring) != self.n_qubits:
            raise ValueError("bitstring length differs from the encoding qubit count")
        if not self._encoding_prepared:
            self._prepare_encoding()

        reversed_bits = bitstring[::-1]
        if any(ch not in "01" for ch in reversed_bits):
            raise ValueError("bitstring characters must all be '0' or '1'")
        bit_list = [1 if ch == "1" else 0 for ch in reversed_bits]
        return self.translate_result_bitlist(bit_list)

    def translate_result_bitlist(self, bit_list: list[int]) -> JobShopSchedulingResult:
        """Decode a little-endian bit list (bit q = qubit q) into a schedule."""
        if not self._encoding_prepared:
            self._prepare_encoding()
        job_schedules: dict[Job, tuple[PotentiallyScheduledOperation, ...]] = {}
        for job in self.jssp_instance.jobs:
            entries: list[PotentiallyScheduledOperation] = []
            for operation in job.operations:
                start_time = self._operation_start_variables[operation].value_from_bitlist(bit_list)
                if start_time is not None:
                    entries.append(ScheduledOperation(operation=operation, start_time=start_time))
                else:
                    entries.append(UnscheduledOperation(operation=operation))
            job_schedules[job] = tuple(entries)
        return JobShopSchedulingResult(problem_instance=self.jssp_instance, schedule=job_schedules)

    def translate_result_state(self, state: int) -> JobShopSchedulingResult:
        """Decode an integer basis-state index (bit q = qubit q)."""
        return self.translate_result_bitlist([(state >> q) & 1 for q in range(self.n_qubits)])

    # ------------------------------------------------------------------
    # encoding
    # ------------------------------------------------------------------

    def _prepare_encoding(self) -> None:
        """Assign a domain-wall start-time variable per operation, with the
        feasible window narrowed by predecessor/successor durations.

        Reference: domain_wall_hamiltonian_encoder.py:146-187.
        """
        for job in self.jssp_instance.jobs:
            start_offset = 0
            end_offset = sum(op.processing_duration for op in job.operations)
            if end_offset > self.makespan_limit:
                raise ValueError(
                    f"makespan_limit {self.makespan_limit} is infeasible: job "
                    f"{job.name}'s operations alone take {end_offset} time steps"
                )
            for operation in job.operations:
                self._machine_operations.setdefault(operation.machine, []).append(operation)
                n_start_times = self.makespan_limit - (start_offset + end_offset) + 1
                variable: DomainWallVariable[int] = DomainWallVariable(
                    qubit_start_index=self._n_qubits,
                    values=tuple(range(start_offset, start_offset + n_start_times)),
                )
                self._operation_start_variables[operation] = variable
                for start_time in variable.values:
                    self._operation_constraint_counts[(operation, start_time)] = 0
                self._n_qubits += variable.n_qubits
                start_offset += operation.processing_duration
                end_offset -= operation.processing_duration
        self._encoding_prepared = True

    def _prepare_hamiltonian(self) -> None:
        """Assemble the five term groups (reference: :189-230)."""
        precedence_terms = [
            self._operation_precedence_term(job.operations[i], job.operations[i + 1])
            for job in self.jssp_instance.jobs
            for i in range(len(job.operations) - 1)
        ]

        overlap_terms = [
            self._operation_overlap_term(op_1, op_2)
            for operations in self._machine_operations.values()
            if len(operations) >= 2
            for op_1, op_2 in combinations(operations, 2)
        ]

        viability_terms = []
        for job in self.jssp_instance.jobs:
            for operation in job.operations:
                variable = self._operation_start_variables[operation]
                max_constraints = max(
                    (self._operation_constraint_counts[(operation, t)] for t in variable.values),
                    default=0,
                )
                viability_terms.append(
                    variable.viability_term(quantum_circuit_n_qubits=self._n_qubits) * (max_constraints + 1)
                )

        zero = pauli_identity_string(self._n_qubits) * 0.0
        hamiltonian = PauliSum.sum(
            [
                (PauliSum.sum(precedence_terms) if precedence_terms else zero)
                * self._precedence_constraint_penalty,
                (PauliSum.sum(overlap_terms) if overlap_terms else zero) * self._overlap_constraint_penalty,
                PauliSum.sum(viability_terms) * self._encoding_penalty,
                self._makespan_optimization_term()
                * (self._max_opt_value * (1 - self._opt_all_operations_share)),
                self._early_start_term() * (self._max_opt_value * self._opt_all_operations_share),
            ]
        )
        self._hamiltonian = hamiltonian.simplify(atol=0.0)
        self._hamiltonian_prepared = True

    def _operation_overlap_term(self, operation_1: Operation, operation_2: Operation) -> PauliSum:
        """Indicator summing to 1 on states where the two operations overlap
        in time on their shared machine (reference: :232-277, including the
        impossible-pair pruning at :252-255 and constraint counting at
        :269-270)."""
        var_1 = self._operation_start_variables[operation_1]
        var_2 = self._operation_start_variables[operation_2]

        if var_1.values[-1] + operation_1.processing_duration <= var_2.values[0]:
            return pauli_identity_string(self._n_qubits) * 0.0
        if var_2.values[-1] + operation_2.processing_duration <= var_1.values[0]:
            return pauli_identity_string(self._n_qubits) * 0.0

        overlaps = [
            (start_1, start_2)
            for start_1 in var_1.values
            for start_2 in var_2.values
            if start_1 < start_2 + operation_2.processing_duration
            and start_2 < start_1 + operation_1.processing_duration
        ]

        local_terms = []
        for start_1, start_2 in overlaps:
            self._operation_constraint_counts[(operation_1, start_1)] += 1
            self._operation_constraint_counts[(operation_2, start_2)] += 1
            local_terms.append(
                var_1.value_term(value=start_1, quantum_circuit_n_qubits=self._n_qubits).compose(
                    var_2.value_term(value=start_2, quantum_circuit_n_qubits=self._n_qubits)
                )
            )
        return PauliSum.sum(local_terms)

    def _operation_precedence_term(self, operation_1: Operation, operation_2: Operation) -> PauliSum:
        """Indicator summing to 1 on states where operation_2 starts before
        operation_1 has finished (reference: :279-321)."""
        var_1 = self._operation_start_variables[operation_1]
        var_2 = self._operation_start_variables[operation_2]

        if var_1.values[-1] + operation_1.processing_duration <= var_2.values[0]:
            return pauli_identity_string(self._n_qubits) * 0.0

        violations = [
            (start_1, start_2)
            for start_1 in var_1.values
            for start_2 in var_2.values
            if not start_1 + operation_1.processing_duration <= start_2
        ]

        local_terms = []
        for start_1, start_2 in violations:
            self._operation_constraint_counts[(operation_1, start_1)] += 1
            self._operation_constraint_counts[(operation_2, start_2)] += 1
            local_terms.append(
                var_1.value_term(value=start_1, quantum_circuit_n_qubits=self._n_qubits).compose(
                    var_2.value_term(value=start_2, quantum_circuit_n_qubits=self._n_qubits)
                )
            )
        return PauliSum.sum(local_terms)

    def _makespan_optimization_term(self) -> PauliSum:
        """Exponentially weighted end-time penalty on each job's last
        operation, normalized to [0, 1] expectation (reference: :323-349,
        weights ``(n_jobs+1)**operation_end / (n_jobs*(n_jobs+1)**limit)``)."""
        n_jobs = len(self.jssp_instance.jobs)
        max_optimization_value = n_jobs * float(n_jobs + 1) ** self.makespan_limit

        local_terms = []
        for job in self.jssp_instance.jobs:
            last_operation = job.operations[-1]
            variable = self._operation_start_variables[last_operation]
            for start_time in variable.values:
                operation_end = start_time + last_operation.processing_duration
                weight = float(n_jobs + 1) ** operation_end / max_optimization_value
                local_terms.append(
                    variable.value_term(value=start_time, quantum_circuit_n_qubits=self._n_qubits) * weight
                )
        return PauliSum.sum(local_terms)

    def _early_start_term(self) -> PauliSum:
        """Linear late-start penalty over all operations, normalized to [0, 1]
        expectation (reference: :351-373)."""
        max_optimization_value = sum(
            len(variable.values) - 1 for variable in self._operation_start_variables.values()
        )
        local_terms = [pauli_identity_string(self._n_qubits) * 0.0]
        for variable in self._operation_start_variables.values():
            for i, value in enumerate(variable.values):
                if i == 0:
                    continue
                local_terms.append(
                    variable.value_term(value=value, quantum_circuit_n_qubits=self._n_qubits)
                    * (i / max_optimization_value)
                )
        return PauliSum.sum(local_terms)
