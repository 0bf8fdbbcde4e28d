"""Population circuit evaluators: "population of genomes -> energies".

Counterpart of the diagonal part of ``queasars_tpu/sim/evaluators.py``
(``BaseCircuitEvaluator``, ``StatevectorExpectationEvaluator``,
``SamplerExpectationEvaluator``).  On the card an exact evaluation goes
through the slot kernels (``sim/slot_kernels.py``), whichever route the
optimizers take: plain expectations through the fused energies kernel, CVaR
through the probabilities kernel.  A sampled evaluation takes the
optimizers' route, as the reference's does: the folded or the slot sampled
kernel (``optim/objective.py``).  On the CPU the same wrappers run their
plain versions.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from math import ceil
from typing import Optional, Sequence, Union

import numpy as np
import torch

from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table
from queasars_tpu_torch.sim import slot_kernels
from queasars_tpu_torch.utils import prng
from queasars_tpu_torch.utils.device import resolve_device


class CircuitEvaluatorException(Exception):
    """Raised for evaluator misuse (reference: circuit_evaluation.py:90)."""


def packed_tensors(packed: PackedPopulation, angles=None, device="cpu") -> tuple:
    """A packed population's genome tensors on ``device``: (gate_types,
    controls, angles, layer_mask); ``angles`` optionally overrides the
    packed angle tensor (numpy or torch)."""
    a = packed.angles if angles is None else angles
    return (
        torch.as_tensor(packed.gate_types, dtype=torch.int32, device=device),
        torch.as_tensor(packed.controls, dtype=torch.int32, device=device),
        torch.as_tensor(a, dtype=torch.float32, device=device),
        torch.as_tensor(packed.layer_mask, dtype=torch.bool, device=device),
    )


def _prepare_initial_state(
    initial_state: Optional[Union[np.ndarray, EVQEIndividual]], n_qubits: int, device
) -> Optional[torch.Tensor]:
    """Accept a complex [2^n] or stacked real [2, 2^n] start state, or an
    :class:`EVQEIndividual` whose circuit prepares the start state (the
    reference's initial-state circuit prepend, circuit_evaluation.py:
    148-149), as re/im planes [2, 2^n] on ``device``."""
    if initial_state is None:
        return None
    if isinstance(initial_state, EVQEIndividual):
        if initial_state.n_qubits != n_qubits:
            raise CircuitEvaluatorException(
                "the initial-state circuit acts on a different qubit count than the operator"
            )
        packed = PackedPopulation.pack([initial_state])
        return slot_kernels.population_states(
            *packed_tensors(packed, device=device), n_qubits
        )[0]
    arr = np.asarray(initial_state)
    if arr.ndim == 1:
        if arr.shape[0] != 1 << n_qubits:
            raise CircuitEvaluatorException("initial_state has the wrong dimension")
        stacked = np.stack([arr.real, arr.imag]).astype(np.float32)
    elif arr.ndim == 2 and arr.shape[0] == 2:
        stacked = arr.astype(np.float32)
    else:
        raise CircuitEvaluatorException("initial_state must be [2^n] complex or [2, 2^n] real")
    norm = float((stacked**2).sum())
    if abs(norm - 1.0) > 1e-5:
        raise CircuitEvaluatorException("initial_state must be normalized")
    return torch.as_tensor(stacked, device=device)


class BaseCircuitEvaluator(ABC):
    """Uniform "population -> energies" contract
    (reference: circuit_evaluation.py:62-87)."""

    def __init__(self, n_qubits: int, device=None):
        self.n_qubits = n_qubits
        self.device = resolve_device(device)

    @abstractmethod
    def evaluate_packed(
        self, packed: PackedPopulation, angles: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Energies [B] for a packed population; ``angles`` optionally
        overrides the packed angle tensor."""

    def evaluate_individuals(self, individuals: Sequence[EVQEIndividual]) -> list[float]:
        """Convenience wrapper: pack then evaluate."""
        packed = PackedPopulation.pack(individuals)
        return [float(v) for v in self.evaluate_packed(packed)]


class _DiagonalEvaluator(BaseCircuitEvaluator):
    """Shared state of the diagonal evaluators: the energy table (sorted
    with its order for CVaR) and the optional start state."""

    def __init__(self, operator: PauliSum, alpha: float, initial_state, device):
        super().__init__(operator.n_qubits, device)
        if not 0 < alpha <= 1:
            raise ValueError("alpha (the CVaR tail fraction) lies outside (0, 1]")
        if not operator.is_diagonal:
            raise NotImplementedError("general (non-diagonal) operators are not ported yet")
        self.operator = operator
        self.alpha = float(alpha)
        self._initial = _prepare_initial_state(initial_state, operator.n_qubits, self.device)
        self._table = diagonal_energy_table(operator, dtype=torch.float32, device=self.device)
        self._order = self._sorted = None

    def _sort_table(self) -> None:
        self._order = torch.argsort(self._table, stable=True)
        self._sorted = self._table[self._order]

    def initial_states(self, pop: int) -> Optional[torch.Tensor]:
        """The shared start state as per-individual [P, 2, 2^n] (None =
        |0...0>)."""
        if self._initial is None:
            return None
        return self._initial.expand(pop, *self._initial.shape).contiguous()

    def evaluate_packed(self, packed, angles=None):
        tensors = packed_tensors(packed, angles, self.device)
        return self.energies(*tensors).cpu().numpy()


class SamplerExpectationEvaluator(_DiagonalEvaluator):
    """Shot-based expectation of a diagonal operator, optionally CVaR over
    the sampled shots (reference: circuit_evaluation.py:94-161).

    :param operator: the Hamiltonian (diagonal; grouped measurement of
        general Pauli sums is not ported yet)
    :param shots: measurement shots per evaluation
    :param alpha: CVaR lower-tail mass in (0, 1]; 1 = plain expectation
    :param seed: base RNG seed; evaluation round c draws its individuals'
        keys from ``split(fold_in(PRNGKey(seed), c), P)``, as the reference
        does, so equal seeds give the reference's shots
    :param initial_state: optional start state prepended to every circuit
    :param device: where evaluation runs (None = the CUDA device)
    """

    def __init__(
        self,
        operator: PauliSum,
        shots: int,
        alpha: float = 1.0,
        seed: int = 0,
        initial_state: Optional[np.ndarray] = None,
        device=None,
    ):
        if shots < 1:
            raise ValueError("shots must be at least 1")
        super().__init__(operator, alpha, initial_state, device)
        self.shots = int(shots)
        self._sort_table()
        self._key = prng.PRNGKey(seed)
        self._counter = 0

    def _next_keys(self, pop: int) -> torch.Tensor:
        """Per-individual keys [pop, 2] of the next evaluation round."""
        self._counter += 1
        return prng.split(prng.fold_in(self._key, self._counter), pop)

    def energies(
        self, gate_types, controls, angles, layer_mask, initial=None, keys=None
    ) -> torch.Tensor:
        """Sampled energies [P] of device genome tensors with the keys
        ``keys`` [P, 2] (None: the next round's), on the optimizers' route
        (the reference's sampler evaluator dispatches as its objective)."""
        from queasars_tpu_torch.optim.objective import objective_operands, population_energies

        if initial is None:
            initial = self.initial_states(gate_types.shape[0])
        if keys is None:
            keys = self._next_keys(gate_types.shape[0])
        return population_energies(
            gate_types, controls, angles, layer_mask, keys=keys, n_qubits=self.n_qubits,
            initial_state=initial, **objective_operands(self),
        )


class StatevectorExpectationEvaluator(_DiagonalEvaluator):
    """Exact expectation of a diagonal operator, optionally CVaR over the
    exact distribution (reference: circuit_evaluation.py:164-219).

    :param operator: the Hamiltonian (diagonal; general Pauli sums are not
        ported yet)
    :param alpha: CVaR lower-tail mass in (0, 1]; 1 = plain expectation
    :param initial_state: optional start state prepended to every circuit
    :param precision: target standard error; above 0 every evaluation is a
        sampler evaluation of ``ceil(precision**-2)`` shots (the reference's
        noise law), through an inner :class:`SamplerExpectationEvaluator`
    :param device: where evaluation runs (None = the CUDA device)
    :param seed: RNG seed of the precision shot stream
    """

    def __init__(
        self,
        operator: PauliSum,
        alpha: float = 1.0,
        initial_state: Optional[np.ndarray] = None,
        precision: float = 0.0,
        device=None,
        seed: int = 0,
    ):
        if precision < 0:
            raise ValueError("precision must be non-negative")
        super().__init__(operator, alpha, initial_state, device)
        self.precision = float(precision)
        self._precision_sampler: Optional[SamplerExpectationEvaluator] = None
        if self.precision > 0.0:
            self._precision_sampler = SamplerExpectationEvaluator(
                operator, shots=int(ceil(self.precision ** -2.0)), alpha=alpha, seed=seed,
                initial_state=initial_state, device=self.device,
            )
        if self.alpha < 1.0:
            self._sort_table()

    @property
    def _counter(self) -> int:
        """The precision shot stream's round counter (the sampler
        evaluator's attribute); AttributeError when precision is 0."""
        if self._precision_sampler is None:
            raise AttributeError("_counter")
        return self._precision_sampler._counter

    @_counter.setter
    def _counter(self, value: int) -> None:
        if self._precision_sampler is None:
            raise AttributeError("_counter")
        self._precision_sampler._counter = int(value)

    def energies(
        self, gate_types, controls, angles, layer_mask, initial=None, keys=None
    ) -> torch.Tensor:
        """Energies [P] of device genome tensors, from ``initial`` states
        when given, else from this evaluator's start state.  Exact energies
        run on the slot kernels, as the reference's ``evaluate_packed`` does
        (the optimizers' objectives take the fold route); with precision
        the inner sampler evaluates (``keys`` as there)."""
        from queasars_tpu_torch.optim.objective import objective_operands, population_energies

        if self._precision_sampler is not None:
            return self._precision_sampler.energies(
                gate_types, controls, angles, layer_mask, initial, keys
            )
        if initial is None:
            initial = self.initial_states(gate_types.shape[0])
        return population_energies(
            gate_types, controls, angles, layer_mask, n_qubits=self.n_qubits,
            initial_state=initial, use_mxu=False, **objective_operands(self),
        )
