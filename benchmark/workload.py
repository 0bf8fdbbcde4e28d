"""The one traffic generator: it reads a traffic mix's parameters
(``benchmark/traffic/<name>.json``) and a configuration
(``benchmark/configs/<name>.json``) and lays out, from ``--seed``, what a
run sends.  It draws every random number itself; the program receives only
the generated inputs.

Two kinds of mix:

- ``solve``: a closed loop of EVQE solves.  Solve ``i`` runs the solver
  seed drawn from (``--seed``, ``i``).  With ``fresh_instances`` false every
  solve takes the configuration's instance (the first of its family and
  width from ``first_seed`` on); with it true, solve ``i`` takes the first
  instance of the family and width among instance seeds drawn from
  (``--seed``, ``i``), so no request repeats.  The warm-up solves draw from
  streams of their own.
- ``energies``: a closed loop of calls of the evaluator on a fixed
  population of random genomes (``population`` of ``layers`` layers, packed
  in at least ``min_layers``), its structure drawn from ``--seed``; call
  ``i`` hands it the angle tensor drawn from (``--seed``, ``i``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark.instances import instances_with_qubits, random_instance
from benchmark.reference.encoding import n_qubits

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file named {name!r} under {kind}: "
                                f"{path} is missing")
    return json.loads(path.read_text())


def stream(seed: int, *labels: int) -> np.random.Generator:
    """A generator of its own for (``seed``, labels); any whole seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *labels]))


def _seed(rng: np.random.Generator) -> int:
    return int(rng.integers(0, 2**31 - 1))


def drawn_instance(family: dict, rng: np.random.Generator) -> tuple[int, dict]:
    """The first (instance seed, instance) among seeds drawn from ``rng``
    whose encoding has ``family["qubits"]`` qubits."""
    while True:
        seed = _seed(rng)
        instance = random_instance(family, seed)
        try:
            width = n_qubits(instance, family["makespan_limit"])
        except ValueError:
            continue
        if width == family["qubits"]:
            return seed, instance


@dataclass
class SolvePlan:
    family: dict
    seed: int
    fresh_instances: bool
    fixed: tuple[int, dict]                # the configuration's (instance seed, instance)

    def _request(self, label: int, i: int) -> tuple[int, dict, int]:
        solver_seed = _seed(stream(self.seed, label, i))
        if not self.fresh_instances:
            return (*self.fixed, solver_seed)
        return (*drawn_instance(self.family, stream(self.seed, label + 10, i)), solver_seed)

    def request(self, i: int) -> tuple[int, dict, int]:
        """Solve ``i``'s (instance seed, instance, solver seed)."""
        return self._request(11, i)

    def warmup(self, k: int) -> tuple[int, dict, int]:
        """The ``k``-th warm-up solve's request, apart from the window's."""
        return self._request(12, k)


@dataclass
class EnergiesPlan:
    genome_seed: int
    population: int
    layers: int
    min_layers: int
    seed: int

    def angles(self, i: int, shape: tuple) -> np.ndarray:
        """Call ``i``'s angle tensor: uniform in [0, 2 pi) as float32."""
        return (stream(self.seed, 2, i).random(shape) * (2 * np.pi)).astype(np.float32)

    def warmup_angles(self, k: int, shape: tuple) -> np.ndarray:
        """The ``k``-th warm-up call's angle tensor, apart from the window's."""
        return (stream(self.seed, 5, k).random(shape) * (2 * np.pi)).astype(np.float32)


def plan_solves(config: dict, traffic: dict, seed: int) -> SolvePlan:
    family = config["instance"]
    fixed = instances_with_qubits(family, family["first_seed"], 1)[0]
    return SolvePlan(family=family, seed=seed, fresh_instances=traffic["fresh_instances"],
                     fixed=fixed)


def plan_energies(config: dict, traffic: dict, seed: int) -> EnergiesPlan:
    return EnergiesPlan(genome_seed=int(stream(seed, 3).integers(0, 2**31 - 1)),
                        population=traffic["population"], layers=traffic["layers"],
                        min_layers=traffic["min_layers"], seed=seed)


def reservoir_slot(seed: int, i: int) -> int:
    """Where request ``i`` lands in the reservoir of requests checked
    against the reference: a whole number in [0, i] drawn from ``--seed``;
    below the reservoir's size it replaces that entry.  The reservoir then
    holds a uniform sample of the window's requests."""
    return int(stream(seed, 4, i).integers(0, i + 1))
