"""The comparison that decides ``correct``: the port's answers against the
plain reference (``benchmark/reference``), which re-encodes each instance
and re-simulates each circuit itself, in float64.

The numbers compared, each a gap taken over the answers checked and scaled
by the largest magnitude of the reference's energy table:

- ``eigenvalue_gap``: a solve's eigenvalue against the reference energy of
  its best individual's circuit;
- ``probability_gap``: the probabilities of the eigenstate's leading
  bitstrings against the reference's (not scaled);
- ``bitstring_energy_gap``: the energies the port's Hamiltonian gives those
  bitstrings against the reference table's;
- ``population_energy_gap``: every energy the solve reports for its final
  generation's individuals against the reference energy of each one's
  circuit (a population evaluated in part, or with its energies mixed up,
  shows here even where the best individual is sound);
- ``energy_gap``: every energy of a checked evaluator call against the
  reference energy of that circuit at those angles.

``dtype`` puts the reference in another precision: the control runs it in
bfloat16 in the port's place.
"""

from __future__ import annotations

import json
import math

import torch

from benchmark.reference import encoding, statevector

SOLVE_NUMBERS = ("eigenvalue_gap", "probability_gap", "bitstring_energy_gap",
                 "population_energy_gap")
ENERGY_NUMBERS = ("energy_gap",)


class Reference:
    """Energy tables per instance, kept for the answers of one run."""

    def __init__(self, makespan_limit: int, device, dtype=torch.float64):
        self.makespan_limit = makespan_limit
        self.device, self.dtype = device, dtype
        self.tables: dict = {}
        self.energies: dict = {}

    def table(self, key, instance: dict) -> torch.Tensor:
        if key not in self.tables:
            self.tables[key] = encoding.energy_table(
                instance, self.makespan_limit, dtype=self.dtype, device=self.device)
        return self.tables[key]

    def probabilities(self, circuit: dict) -> torch.Tensor:
        return statevector.probabilities(circuit, dtype=self.dtype, device=self.device)

    def energy(self, key, instance: dict, circuit: dict) -> float:
        """The energy of ``circuit`` under instance ``key``'s table, in
        this reference's dtype (kept: circuits repeat in a population)."""
        name = (key, json.dumps(circuit))
        if name not in self.energies:
            table = self.table(key, instance)
            self.energies[name] = statevector.energy(self.probabilities(circuit), table)
        return self.energies[name]


def solve_gaps(answer: dict, instance_key, instance: dict, ref: Reference,
               truth: Reference | None = None) -> dict:
    """The solve numbers of one answer.  With ``truth`` (the float64
    reference), ``ref`` stands in the port's place: its own energy of the
    circuit, probabilities and table entries are judged instead."""
    judge = truth or ref
    table = judge.table(instance_key, instance).double()
    scale = float(table.abs().max())
    probs = judge.probabilities(answer["circuit"]).double()
    expected = float((probs * table).sum())
    states = torch.tensor(answer["states"], dtype=torch.int64, device=table.device)
    if truth is None:
        eigenvalue = answer["eigenvalue"]
        reported = torch.tensor(answer["probabilities"], dtype=torch.float64)
        energies = torch.tensor(answer["state_energies"], dtype=torch.float64)
    else:
        lower_probs = ref.probabilities(answer["circuit"])
        lower_table = ref.table(instance_key, instance)
        eigenvalue = float((lower_probs * lower_table.to(lower_probs.dtype)).sum())
        reported = lower_probs[states].double().cpu()
        energies = lower_table[states].double().cpu()
    population = 0.0
    for plain, value in answer["population"]:
        if truth is not None:
            value = ref.energy(instance_key, instance, plain)
        gap = (float("inf") if value is None
               else abs(value - judge.energy(instance_key, instance, plain)) / scale)
        population = max(population, gap)
    return {
        "eigenvalue_gap": abs(eigenvalue - expected) / scale,
        "probability_gap": float((reported - probs[states].cpu()).abs().max()),
        "bitstring_energy_gap": float((energies - table[states].cpu()).abs().max()) / scale,
        "population_energy_gap": population,
    }


def energy_gap(energies, circuits: list[dict], instance_key, instance: dict, ref: Reference,
               truth: Reference | None = None) -> float:
    """The largest energy gap over one call's population.  With ``truth``,
    ``ref`` stands in the port's place, as in :func:`solve_gaps`."""
    judge = truth or ref
    table = judge.table(instance_key, instance).double()
    scale = float(table.abs().max())
    largest = 0.0
    for value, plain in zip(energies, circuits):
        expected = float((judge.probabilities(plain).double() * table).sum())
        if truth is not None:
            lower = ref.probabilities(plain)
            value = float((lower * ref.table(instance_key, instance).to(lower.dtype)).sum())
        largest = max(largest, abs(float(value) - expected) / scale)
    return largest


def worst(records: list[dict], names) -> dict:
    """The largest reading of each number over the answers checked."""
    return {name: max((r[name] for r in records), default=None) for name in names}


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Every number within its limit; each with its limit, for the line (a
    number that is not finite, such as an energy never reported, shows as
    null and fails)."""
    shown, ok = {}, True
    for name, value in readings.items():
        limit = limits[name]
        if value is not None and not math.isfinite(value):
            value = None
        shown[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, shown
