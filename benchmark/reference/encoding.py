"""The domain-wall JSSP encoding, written plainly over all basis states.

A frozen, independent copy of the rules of the upstream QUEASARS encoder
(job_shop_scheduling/domain_wall_hamiltonian_encoder.py and
utility/domain_wall_variables.py).  Instead of building Pauli terms, every
term is evaluated as a function of the bits of each basis state, so the
result is the Hamiltonian's diagonal: ``table[x]`` is the energy of basis
state ``x``, with bit ``q`` of ``x`` holding qubit ``q``.

An instance is plain data: ``{"jobs": [[[machine, duration], ...], ...]}``,
each job's operations in their order.

Each operation owns a domain-wall variable that chooses its start time.
With ``k`` start times the variable has ``k - 1`` qubits; with the
variable's bits ``b_0 .. b_{k-2}`` and ``z_j = 1 - 2 b_j``, ``z_{-1} = -1``
and ``z_{k-1} = +1``:

- value ``i`` holds where ``(z_i - z_{i-1}) / 2`` is 1;
- the variable is broken by ``sum_{i=-1}^{k-2} (1 - z_i z_{i+1}) / 2 - 1``
  (0 on a single domain wall, ``w - 1`` on ``w`` walls).

The Hamiltonian adds the precedence and machine-overlap indicator products,
the viability terms (each weighted by one more than its operation's largest
constraint count), the exponentially weighted makespan term and the linear
early-start term, with the encoder's default penalties.
"""

from __future__ import annotations

from itertools import combinations

import torch

#: the encoder's default weights (domain_wall_hamiltonian_encoder.py:23-75)
DEFAULT_WEIGHTS = dict(
    encoding_penalty=300.0,
    overlap_constraint_penalty=100.0,
    precedence_constraint_penalty=100.0,
    max_opt_value=100.0,
    opt_all_operations_share=0.0,
)


def start_time_variables(instance: dict, makespan_limit: int) -> list[list[dict]]:
    """Per job, per operation: ``{"start": first qubit, "values": start
    times, "duration": d, "machine": m}``; the feasible start times are
    narrowed by the durations of the operations before and after."""
    jobs, qubit = [], 0
    for ops in instance["jobs"]:
        start_offset, end_offset = 0, sum(d for _, d in ops)
        if end_offset > makespan_limit:
            raise ValueError(f"makespan_limit {makespan_limit} is infeasible for a job")
        variables = []
        for machine, duration in ops:
            n_starts = makespan_limit - (start_offset + end_offset) + 1
            values = list(range(start_offset, start_offset + n_starts))
            variables.append(dict(start=qubit, values=values, duration=duration, machine=machine))
            qubit += n_starts - 1
            start_offset += duration
            end_offset -= duration
        jobs.append(variables)
    return jobs


def n_qubits(instance: dict, makespan_limit: int) -> int:
    """Qubits the encoding of ``instance`` takes."""
    return sum(len(v["values"]) - 1 for job in start_time_variables(instance, makespan_limit)
               for v in job)


class _Bits:
    """``z`` values of every qubit over all basis states, made on demand."""

    def __init__(self, n: int, dtype, device):
        self.index = torch.arange(1 << n, dtype=torch.int64, device=device)
        self.dtype = dtype
        self.cache: dict[int, torch.Tensor] = {}

    def z(self, qubit: int) -> torch.Tensor:
        if qubit not in self.cache:
            bit = (self.index >> qubit) & 1
            self.cache[qubit] = (1 - 2 * bit).to(self.dtype)
        return self.cache[qubit]

    def constant(self, value: float) -> torch.Tensor:
        return torch.full_like(self.index, 0, dtype=self.dtype) + value


def _z_dash(bits: _Bits, var: dict, i: int):
    """``Z'_i`` of a variable: -1 before it, +1 after it, Z on its qubit."""
    k = len(var["values"]) - 1
    if i == -1:
        return -1.0
    if i == k:
        return 1.0
    return bits.z(var["start"] + i)


def _value(bits: _Bits, var: dict, value: int):
    """The indicator that ``var`` holds ``value`` (1 for a single
    variable value)."""
    if len(var["values"]) == 1:
        return 1.0
    i = var["values"].index(value)
    return (_z_dash(bits, var, i) - _z_dash(bits, var, i - 1)) * 0.5


def _viability(bits: _Bits, var: dict):
    k = len(var["values"]) - 1
    if k == 0:
        return 0.0
    total = -1.0
    for i in range(-1, k):
        total = total + (1.0 - _z_dash(bits, var, i) * _z_dash(bits, var, i + 1)) * 0.5
    return total


def energy_table(instance: dict, makespan_limit: int, *, dtype=torch.float64, device="cpu",
                 weights: dict | None = None) -> torch.Tensor:
    """The Hamiltonian's diagonal [2^n] in ``dtype`` on ``device``."""
    w = dict(DEFAULT_WEIGHTS, **(weights or {}))
    jobs = start_time_variables(instance, makespan_limit)
    n = sum(len(v["values"]) - 1 for job in jobs for v in job)
    bits = _Bits(n, dtype, device)
    counts = {(j, o, t): 0 for j, job in enumerate(jobs) for o, v in enumerate(job)
              for t in v["values"]}

    def pair_sum(a, b, violates):
        (ja, oa), (jb, ob) = a, b
        va, vb = jobs[ja][oa], jobs[jb][ob]
        total = 0.0
        for s1 in va["values"]:
            for s2 in vb["values"]:
                if violates(s1, va["duration"], s2, vb["duration"]):
                    counts[(ja, oa, s1)] += 1
                    counts[(jb, ob, s2)] += 1
                    total = total + _value(bits, va, s1) * _value(bits, vb, s2)
        return total

    precedence = 0.0
    for j, job in enumerate(jobs):
        for o in range(len(job) - 1):
            first, second = job[o], job[o + 1]
            if first["values"][-1] + first["duration"] <= second["values"][0]:
                continue
            precedence = precedence + pair_sum(
                (j, o), (j, o + 1), lambda s1, d1, s2, d2: not s1 + d1 <= s2)

    by_machine: dict = {}
    for j, job in enumerate(jobs):
        for o, var in enumerate(job):
            by_machine.setdefault(var["machine"], []).append((j, o))
    overlap = 0.0
    for ops in by_machine.values():
        for a, b in combinations(ops, 2):
            va, vb = jobs[a[0]][a[1]], jobs[b[0]][b[1]]
            if va["values"][-1] + va["duration"] <= vb["values"][0]:
                continue
            if vb["values"][-1] + vb["duration"] <= va["values"][0]:
                continue
            overlap = overlap + pair_sum(
                a, b, lambda s1, d1, s2, d2: s1 < s2 + d2 and s2 < s1 + d1)

    viability = 0.0
    for j, job in enumerate(jobs):
        for o, var in enumerate(job):
            most = max(counts[(j, o, t)] for t in var["values"])
            viability = viability + _viability(bits, var) * (most + 1)

    n_jobs = len(jobs)
    scale = n_jobs * float(n_jobs + 1) ** makespan_limit
    makespan = 0.0
    for job in jobs:
        last = job[-1]
        for t in last["values"]:
            makespan = makespan + _value(bits, last, t) * (
                float(n_jobs + 1) ** (t + last["duration"]) / scale)

    late = sum(len(v["values"]) - 1 for job in jobs for v in job)
    early = 0.0
    for job in jobs:
        for var in job:
            for i, t in enumerate(var["values"][1:], start=1):
                early = early + _value(bits, var, t) * (i / late)

    share = w["opt_all_operations_share"]
    table = (bits.constant(0.0)
             + precedence * w["precedence_constraint_penalty"]
             + overlap * w["overlap_constraint_penalty"]
             + viability * w["encoding_penalty"]
             + makespan * (w["max_opt_value"] * (1 - share))
             + early * (w["max_opt_value"] * share))
    return table.to(dtype)
