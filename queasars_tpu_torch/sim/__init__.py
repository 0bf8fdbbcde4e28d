"""Statevector engine, slot and fold kernels, expectations and evaluators;
``external`` holds the pluggable external evaluation backends (the
reference's BaseEstimatorV2/BaseSamplerV2 injection capability).

``CallbackCircuitEvaluator`` is exported on first access: the evaluators
import ``paulis``, which imports this package's ``expectation`` module."""

__all__ = ["CallbackCircuitEvaluator"]


def __getattr__(name):
    if name == "CallbackCircuitEvaluator":
        from queasars_tpu_torch.sim.external import CallbackCircuitEvaluator

        return CallbackCircuitEvaluator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
