"""Pluggable external evaluation backends -- the reference's L1 plug point.

Counterpart of ``queasars_tpu/sim/external.py``, with its validation
messages.  The reference's circuit-evaluation layer accepts ANY
``BaseEstimatorV2``/``BaseSamplerV2`` at configuration time -- including
IBM Runtime real hardware (reference: circuit_evaluation.py:62-87,
configured_primitives.py:9-22).  This module is the port's equivalent
seam: an ``evaluator=`` injected into a solver configuration drives the
WHOLE evolution loop against a user-supplied backend (external simulator,
cloud service, real QPU) instead of the internal engines.

Two usage shapes:

- subclass :class:`~queasars_tpu_torch.sim.evaluators.BaseCircuitEvaluator`
  and override :meth:`evaluate_packed` (full control over batching), or
- wrap a plain ``evaluate_circuits(circuits, parameter_values) ->
  energies`` callable in :class:`CallbackCircuitEvaluator` -- the
  reference's exact evaluation signature (circuit_evaluation.py:62-87).
  ``circuits`` arrive as genome :class:`EVQEIndividual` objects;
  convert them to OpenQASM 2.0 via
  :func:`queasars_tpu_torch.genome.qasm.individual_to_qasm` to dispatch to
  real hardware or any external simulator.

The batched optimizers detect evaluators without objective operands and
fall back to host-stepped optimization -- one batched
``evaluate_circuits`` call per probe point, which is exactly the
reference's own evaluation shape (mutation.py:63-81).  Expect the
backend's throughput: nothing about the user's backend runs inside the
port's kernels.  The solver still measures the best circuit's final
distribution itself, on the evaluator's ``device`` (the probabilities
kernel on the card).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.sim.evaluators import BaseCircuitEvaluator, CircuitEvaluatorException

#: the reference callback contract (circuit_evaluation.py:62-87):
#: (circuits, parameter_values) -> one energy per circuit
EvaluateCircuitsCallback = Callable[
    [Sequence[EVQEIndividual], Sequence[Sequence[float]]], Sequence[float]
]


class CallbackCircuitEvaluator(BaseCircuitEvaluator):
    """Adapter turning a user-supplied ``evaluate_circuits`` callable into
    a population evaluator the solvers/optimizers can drive.

    The callable receives the batch exactly as the reference's evaluators
    do (circuit_evaluation.py:62-87): a list of circuits (genome
    individuals — their layer structure is the circuit; the parameter
    values stored on them are superseded by the second argument) and a
    list of flat parameter vectors, one per circuit, in the configured
    parameter order.  It must return one energy per circuit.

    :param evaluate_circuits: the backend callable
    :param n_qubits: qubit count of the operator the backend measures
    :param name: optional label used in error messages
    :param device: where the solver measures the best circuit's final
        distribution (None = the CUDA device)
    """

    def __init__(
        self,
        evaluate_circuits: EvaluateCircuitsCallback,
        n_qubits: int,
        name: str = "external backend",
        device=None,
    ):
        super().__init__(n_qubits, device)
        if not callable(evaluate_circuits):
            raise CircuitEvaluatorException("evaluate_circuits must be callable")
        if n_qubits < 1:
            raise CircuitEvaluatorException("n_qubits must be positive")
        self._evaluate = evaluate_circuits
        self._name = name

    def evaluate_packed(
        self, packed: PackedPopulation, angles: np.ndarray | None = None
    ) -> np.ndarray:
        """Unpack the population to (circuits, parameter vectors) and
        dispatch one batched callback call — optimizer probe batches
        (``angles`` override) re-bind each individual's flat vector from
        the probed angle tensor first."""
        if packed.individuals is None:
            raise CircuitEvaluatorException(
                "this packed population carries no host genomes; external "
                "backends need populations built via PackedPopulation.pack"
            )
        if packed.n_qubits != self.n_qubits:
            raise CircuitEvaluatorException(
                f"population acts on {packed.n_qubits} qubits but the "
                f"{self._name} measures {self.n_qubits}"
            )
        a = packed.angles if angles is None else np.asarray(angles)
        circuits = list(packed.individuals)
        parameter_values = [
            packed.angles_to_flat(i, a[i]) for i in range(packed.n_individuals)
        ]
        energies = self._evaluate(circuits, parameter_values)
        out = np.asarray(list(energies), dtype=np.float64)
        if out.shape != (packed.n_individuals,):
            raise CircuitEvaluatorException(
                f"{self._name} returned {out.shape} energies for "
                f"{packed.n_individuals} circuits"
            )
        return out

    def evaluate_circuits(
        self,
        circuits: Sequence[EVQEIndividual],
        parameter_values: Sequence[Sequence[float]],
    ) -> list[float]:
        """Direct pass-through of the reference signature."""
        return [
            float(v)
            for v in self._evaluate(list(circuits), [tuple(p) for p in parameter_values])
        ]


def resolve_injected_evaluator(evaluator, operator, *, role: str = "operator"):
    """Resolve a configuration's ``evaluator=`` entry against an operator.

    Accepts a ready :class:`BaseCircuitEvaluator` instance (used as-is)
    or a factory callable ``operator -> BaseCircuitEvaluator`` (invoked
    per operator — required when aux operators need their own backend
    evaluations).  Validates the qubit count against ``operator`` when it
    exposes one.
    """
    if isinstance(evaluator, BaseCircuitEvaluator):
        resolved = evaluator
    elif callable(evaluator):
        resolved = evaluator(operator)
        if not isinstance(resolved, BaseCircuitEvaluator):
            raise CircuitEvaluatorException(
                "the evaluator factory must return a BaseCircuitEvaluator "
                f"(got {type(resolved).__name__} for the {role})"
            )
    else:
        raise CircuitEvaluatorException(
            "evaluator must be a BaseCircuitEvaluator or a factory "
            f"callable operator -> BaseCircuitEvaluator (got {type(evaluator).__name__})"
        )
    operator_qubits = getattr(operator, "n_qubits", None)
    if operator_qubits is not None and resolved.n_qubits != operator_qubits:
        raise CircuitEvaluatorException(
            f"the injected evaluator measures {resolved.n_qubits} qubits but "
            f"the {role} acts on {operator_qubits}"
        )
    return resolved
