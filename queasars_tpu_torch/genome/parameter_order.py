"""Flat-parameter ordering modes: canonical vs qiskit-compatible.

A genome's ``parameter_values`` is a flat tuple; *which* rotation angle a
given flat position feeds is a convention:

- ``"canonical"`` (default): per layer, qubits ascending, angles in gate
  order (theta, phi, lambda).  This is the natural tensor-packing order.
- ``"qiskit"``: the ordering the reference inherits implicitly.  The
  reference binds flat vectors to ``QuantumCircuit.parameters``
  (mutation.py:67-70 via circuit_evaluation.py), and qiskit sorts plain
  Parameters *alphabetically by name*; with names
  ``layer{l}_q{q}_{theta,phi,lambda}`` (quantum_gate.py:98-100,
  circuit_layer.py:201-203) the per-layer order becomes: qubits sorted by
  the string ``"q{q}_"`` (so q0 < q10..q19 < q1 < q2 for n >= 11) and,
  within a qubit, (lambda, phi, theta).  Since NFT cycles parameters by
  flat index, this ordering is what makes optimization trajectories match
  the reference step for step.

Layers always occupy contiguous flat blocks in layer order, matching the
reference's storage (individual.py:239-250 builds contiguous
``layer_parameter_indices``).  Note the reference itself becomes
internally inconsistent at >= 10 layers (the full-circuit alphabetical
sort interleaves ``layer10`` before ``layer2`` while its per-layer index
map stays contiguous); we keep the sane contiguous-block semantics there.

The mode is process-global (set once before building solvers), because it
defines how every stored flat vector is interpreted; a per-call override
exists on the packing APIs for tests.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Sequence

_MODES = ("canonical", "qiskit")
_mode = "canonical"

#: angle-component order within one gate, per mode (indices into the
#: (theta, phi, lambda) triplet)
_ANGLE_ORDER = {"canonical": (0, 1, 2), "qiskit": (2, 1, 0)}


def set_parameter_order(mode: str) -> None:
    """Set the global flat-parameter ordering mode."""
    global _mode
    if mode not in _MODES:
        raise ValueError(f"unknown parameter order {mode!r}; expected one of {_MODES}")
    _mode = mode


def get_parameter_order() -> str:
    return _mode


@contextmanager
def parameter_order(mode: str) -> Iterator[None]:
    """Temporarily switch the ordering mode (tests / scoped solves)."""
    previous = get_parameter_order()
    set_parameter_order(mode)
    try:
        yield
    finally:
        set_parameter_order(previous)


def ordered_qubits(parameterized_qubits: Sequence[int], mode: str) -> list[int]:
    """Parameterized qubits of one layer in flat-vector order."""
    if mode == "canonical":
        return sorted(parameterized_qubits)
    return sorted(parameterized_qubits, key=lambda q: f"q{q}_")


def layer_slot_order(parameterized_qubits: Sequence[int], mode: str) -> list[tuple[int, int]]:
    """Flat order of one layer's (qubit, angle-index) parameter slots."""
    angle_order = _ANGLE_ORDER[mode]
    return [(q, a) for q in ordered_qubits(parameterized_qubits, mode) for a in angle_order]
