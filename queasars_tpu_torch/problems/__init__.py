"""Optimization problems encoded as Hamiltonians: JSSP (``problems.jssp``),
spin chains, and QUBO / integer programs with the MaxCut, TSP and
graph-colouring encoders (``problems.qubo``)."""

from queasars_tpu_torch.problems.qubo import (
    BoundedIntegerVariable,
    IntegerQuadraticProgram,
    decode_qubo_bits,
    maxcut_hamiltonian,
    qubo_hamiltonian,
)

__all__ = [
    "BoundedIntegerVariable",
    "IntegerQuadraticProgram",
    "decode_qubo_bits",
    "maxcut_hamiltonian",
    "qubo_hamiltonian",
]
