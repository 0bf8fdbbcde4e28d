"""Population circuit evaluators: "population of genomes -> energies".

Counterpart of ``queasars_tpu/sim/evaluators.py`` (``BaseCircuitEvaluator``,
``StatevectorExpectationEvaluator``, ``SamplerExpectationEvaluator``,
``BitstringFunctionEvaluator``).  On
the card an exact evaluation of a diagonal operator goes through the slot
kernels (``sim/slot_kernels.py``), whichever route the optimizers take:
plain expectations through the fused energies kernel, CVaR through the
probabilities kernel.  A general (non-diagonal) operator's exact energy is a
dense matvec (n <= 12) or the matrix-free term scan on the slot states
kernel's states.  A sampled evaluation takes the optimizers' route, as the
reference's does: the folded or the slot sampled kernel, or for a general
operator QWC grouped measurement (``optim/objective.py``,
``sim/grouped_sampling.py``).  A black-box bitstring objective samples the
probabilities kernel of the optimizers' route and evaluates the objective on
the host.  On the CPU the same wrappers run their plain versions.

With a population mesh attached (:meth:`BaseCircuitEvaluator.set_mesh`,
``parallel/mesh.py``), every population evaluation runs block by block
over the mesh's devices through :meth:`BaseCircuitEvaluator._run_batched`
(the reference's per-individual executor fan-out, selection.py:75-84); a
general operator's exact energy then takes the term scan, not the dense
matvec, as the reference's does.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from math import ceil
from typing import Optional, Sequence, Union

import numpy as np
import torch

from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.parallel.mesh import operand_device, run_batched
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table
from queasars_tpu_torch.sim import slot_kernels
from queasars_tpu_torch.sim.expectation import DenseHermitian, pauli_terms
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.sim.grouped_sampling import (
    allocate_shots,
    grouped_operands,
    grouped_weights,
)
from queasars_tpu_torch.utils import prng
from queasars_tpu_torch.utils.bitstring_evaluation import BitstringEvaluator
from queasars_tpu_torch.utils.device import resolve_device
from queasars_tpu_torch.utils.profiling import span, spanned


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


def expand_initial(initial: Optional[torch.Tensor], pop: int) -> Optional[torch.Tensor]:
    """A shared start state [2, 2^n] as per-individual [P, 2, 2^n] (None
    stays None: |0...0>)."""
    if initial is None:
        return None
    return initial.expand(pop, *initial.shape).contiguous()


class BaseCircuitEvaluator(ABC):
    """Uniform "population -> energies" contract
    (reference: circuit_evaluation.py:62-87).  ``device`` is where the
    evaluator's circuits run (None = the CUDA device); the solver measures
    the best circuit's final distribution there, from
    :meth:`initial_states`.  With a population mesh attached
    (:meth:`set_mesh`), population evaluations run block by block on the
    mesh's devices instead."""

    def __init__(self, n_qubits: int, device=None):
        self.n_qubits = n_qubits
        self.device = resolve_device(device)
        self._initial: Optional[torch.Tensor] = None
        self.mesh = None

    def set_mesh(self, mesh) -> None:
        """Split subsequent population evaluations over ``mesh``'s blocks
        (``parallel/mesh.py``; None detaches)."""
        self.mesh = mesh

    def _run_batched(self, fn, pop_args: tuple, rep_args: tuple = ()) -> np.ndarray:
        """Run ``fn(pop_args, rep_args)`` on the evaluator's device, or over
        the attached mesh (population padded to the mesh's pad multiple,
        outputs cut back); numpy."""
        out = run_batched(self.mesh, fn, pop_args, rep_args)
        with span("wait.evaluate_packed"):
            return out.cpu().numpy()

    def _genome(self, packed: PackedPopulation, angles=None) -> tuple:
        """``packed_tensors`` where :meth:`_run_batched` takes them: on the
        evaluator's device, or on the CPU for the mesh to split."""
        return packed_tensors(packed, angles, operand_device(self.mesh, self.device))

    @abstractmethod
    def evaluate_packed(
        self, packed: PackedPopulation, angles: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Energies [B] for a packed population; ``angles`` optionally
        overrides the packed angle tensor."""

    def initial_states(self, pop: int) -> Optional[torch.Tensor]:
        """The shared start state as per-individual [P, 2, 2^n] (None =
        |0...0>)."""
        return expand_initial(self._initial, pop)

    def evaluate_individuals(self, individuals: Sequence[EVQEIndividual]) -> list[float]:
        """Convenience wrapper: pack then evaluate."""
        packed = PackedPopulation.pack(individuals)
        return [float(v) for v in self.evaluate_packed(packed)]

    def evaluate_circuits(
        self,
        circuits: Sequence[EVQEIndividual],
        parameter_values: Sequence[Sequence[float]],
    ) -> list[float]:
        """Reference-signature compatibility shim
        (circuit_evaluation.py:62-87): "circuits" are genome individuals
        here; each is re-bound with the given parameter vector."""
        bound = [
            EVQEIndividual.change_parameter_values(ind, tuple(params))
            for ind, params in zip(circuits, parameter_values)
        ]
        return self.evaluate_individuals(bound)


class _OperatorEvaluator(BaseCircuitEvaluator):
    """Shared state of the operator evaluators: the operator, the CVaR
    alpha, the optional start state and, for a diagonal operator, its energy
    table (sorted with its order for CVaR).  Direct evaluations take
    ``_use_mxu``'s route (``sim/routes.py``; None: the optimizers' rule)."""

    _use_mxu: Optional[bool] = None

    def __init__(self, operator: PauliSum, alpha: float, initial_state, device):
        super().__init__(operator.n_qubits, device)
        if not 0 < alpha <= 1:
            raise ValueError("alpha (the CVaR tail fraction) lies outside (0, 1]")
        self.operator = operator
        self.alpha = float(alpha)
        self._diagonal = operator.is_diagonal
        self._initial = _prepare_initial_state(initial_state, operator.n_qubits, self.device)
        self._table = self._order = self._sorted = None
        if self._diagonal:
            self._table = diagonal_energy_table(operator, dtype=torch.float32, device=self.device)

    def _sort_table(self) -> None:
        self._order = torch.argsort(self._table, stable=True)
        self._sorted = self._table[self._order]

    def _keys(self, pop: int) -> Optional[torch.Tensor]:
        """The next round's per-individual keys [P, 2] of a sampled
        evaluation, drawn for the whole population before any padding
        (None: exact)."""
        return None

    def _block_energies(self, pop_args, rep_args) -> torch.Tensor:
        """Energies of (gate_types, controls, angles, layer_mask, keys) on
        their device, with (the shared start state, the objective operands)
        there: the function :meth:`evaluate_packed` runs per block."""
        from queasars_tpu_torch.optim.objective import population_energies

        gate_types, controls, angles, layer_mask, keys = pop_args
        shared, operands = rep_args
        return population_energies(
            gate_types, controls, angles, layer_mask, keys=keys, n_qubits=self.n_qubits,
            initial_state=expand_initial(shared, gate_types.shape[0]), use_mxu=self._use_mxu,
            **operands,
        )

    @spanned("evaluator.evaluate_packed")
    def evaluate_packed(self, packed, angles=None):
        from queasars_tpu_torch.optim.objective import objective_operands

        keys = self._keys(packed.n_individuals)
        return self._run_batched(
            self._block_energies, (*self._genome(packed, angles), keys),
            (self._initial, objective_operands(self)),
        )


class SamplerExpectationEvaluator(_OperatorEvaluator):
    """Shot-based expectation, optionally CVaR over the sampled shots
    (reference: circuit_evaluation.py:94-161).  A general Pauli sum is
    measured as hardware would: partitioned into qubit-wise-commuting groups
    (``paulis/grouping.py``), each rotated into its product basis and
    sampled with its own budget; CVaR then needs a diagonal operator.

    :param operator: the Hamiltonian
    :param shots: measurement shots per evaluation (per group for a general
        operator under ``shot_allocation="per_group"``)
    :param alpha: CVaR lower-tail mass in (0, 1]; 1 = plain expectation
    :param seed: base RNG seed; evaluation round c draws its individuals'
        keys from ``split(fold_in(PRNGKey(seed), c), P)``, as the reference
        does, so equal seeds give the reference's shots
    :param initial_state: optional start state prepended to every circuit
    :param device: where evaluation runs (None = the CUDA device)
    :param shot_allocation: how a general operator's groups share the
        budget: ``"per_group"`` (every group gets ``shots``) or
        ``"proportional"`` (``shots`` is the total, split by the groups'
        coefficient L1 norms, ``grouped_sampling.allocate_shots``); ignored
        for a diagonal operator
    """

    def __init__(
        self,
        operator: PauliSum,
        shots: int,
        alpha: float = 1.0,
        seed: int = 0,
        initial_state: Optional[np.ndarray] = None,
        device=None,
        shot_allocation: str = "per_group",
    ):
        if shots < 1:
            raise ValueError("shots must be at least 1")
        if shot_allocation not in ("per_group", "proportional"):
            raise ValueError("shot_allocation must be 'per_group' or 'proportional'")
        super().__init__(operator, alpha, initial_state, device)
        self.shots = int(shots)
        self.shot_allocation = shot_allocation
        self._grouped = None
        self._group_shots: Optional[tuple] = None
        if self._diagonal:
            self._sort_table()
        else:
            if self.alpha < 1.0:
                raise CircuitEvaluatorException(
                    "CVaR (alpha<1) over the sampler path requires a diagonal "
                    "operator: the qubit-wise-commuting groups of a general "
                    "Pauli sum are measured in different bases, so their shots "
                    "do not form one energy distribution to take a tail of"
                )
            self._grouped = grouped_operands(operator, self.device)
            if shot_allocation == "proportional":
                self._group_shots = allocate_shots(grouped_weights(operator), self.shots)
        self._key = prng.PRNGKey(seed)
        self._counter = 0

    def _next_keys(self, pop: int) -> torch.Tensor:
        """Per-individual keys [pop, 2] of the next evaluation round."""
        self._counter += 1
        return prng.split(prng.fold_in(self._key, self._counter), pop)

    _keys = _next_keys


class StatevectorExpectationEvaluator(_OperatorEvaluator):
    """Exact expectation, optionally CVaR over the exact distribution
    (reference: circuit_evaluation.py:164-219).

    :param operator: the Hamiltonian (any PauliSum up to 32 qubits; CVaR
        needs a diagonal one)
    :param alpha: CVaR lower-tail mass in (0, 1]; 1 = plain expectation
    :param initial_state: optional start state prepended to every circuit
    :param precision: target standard error; above 0 every evaluation is a
        sampler evaluation of ``ceil(precision**-2)`` shots (the reference's
        noise law), through an inner :class:`SamplerExpectationEvaluator`
        (grouped, every group with that budget, for a general operator)
    :param device: where evaluation runs (None = the CUDA device)
    :param seed: RNG seed of the precision shot stream
    """

    #: exact energies run on the slot kernels, as the reference's
    #: ``evaluate_packed`` does (the optimizers' objectives take the route
    #: ``sim/routes.py`` picks)
    _use_mxu = False

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
        self._general = self._terms = None
        if self._diagonal:
            if self.alpha < 1.0:
                self._sort_table()
        else:
            if self.alpha < 1.0:
                raise CircuitEvaluatorException("CVaR (alpha<1) requires a diagonal operator")
            if operator.n_qubits > 32:
                raise CircuitEvaluatorException("general operators limited to n<=32 qubits")
            if operator.n_qubits <= 12:
                dense = operator.to_dense_matrix()
                self._general = DenseHermitian(
                    torch.as_tensor(dense.real.astype(np.float32), device=self.device),
                    torch.as_tensor(dense.imag.astype(np.float32), device=self.device),
                )
            else:
                self._general = pauli_terms(operator, self.device)

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

    def set_mesh(self, mesh) -> None:
        super().set_mesh(mesh)
        if self._precision_sampler is not None:
            self._precision_sampler.set_mesh(mesh)

    def general_terms(self):
        """A general operator's Pauli terms (the term scan's operands; built
        on first use where the evaluator holds the dense matrix)."""
        if not isinstance(self._general, DenseHermitian):
            return self._general
        if self._terms is None:
            self._terms = pauli_terms(self.operator, self.device)
        return self._terms

    def evaluate_packed(self, packed, angles=None):
        if self._precision_sampler is not None:
            return self._precision_sampler.evaluate_packed(packed, angles)
        return super().evaluate_packed(packed, angles)


def observed_frequencies(keys: torch.Tensor, probs: torch.Tensor, shots: int):
    """The states that ``shots`` draws per individual hit and their shot
    frequencies, found on ``probs``' device: (the observed states, sorted
    ascending, int64 [K]; frequencies float32 [P, K], counts times the
    float32 reciprocal of ``shots``).  The columns of the empirical
    distribution (``sampling.empirical_probs``) that some individual
    observed, without building it: K <= P * shots."""
    return sample_frequencies(sample_indices(keys, probs, shots), shots)


def sample_frequencies(samples: torch.Tensor, shots: int):
    """:func:`observed_frequencies` of drawn basis indices [P, shots], on
    their device."""
    observed = torch.unique(samples)
    columns = torch.searchsorted(observed, samples)
    counts = torch.zeros((samples.shape[0], observed.shape[0]), dtype=torch.int64,
                         device=samples.device)
    counts.scatter_add_(1, columns, torch.ones_like(columns))
    reciprocal = torch.tensor(1.0 / shots, dtype=torch.float32, device=samples.device)
    return observed, counts.to(torch.float32) * reciprocal


class BitstringFunctionEvaluator(BaseCircuitEvaluator):
    """Black-box bitstring objective over sampled measurements.

    Counterpart of the JAX package's ``BitstringFunctionEvaluator``
    (reference: BitstringCircuitEvaluator, circuit_evaluation.py:222-291):
    each individual's probabilities come from the probabilities kernel of
    the optimizers' route (``optim/objective.py::population_probs``); its
    shots are drawn with ``split(fold_in(PRNGKey(seed), c), P)`` in
    evaluation round c, as the reference's; the observed states and their
    float32 frequencies are found on the device
    (:func:`observed_frequencies`) and only they reach the host, where the
    (host Python) objective runs once per distinct observed state,
    memoised across calls, and the expectation or CVaR is accumulated in
    float64 as the reference does
    (expectation_calculation.py:72-103).  The objective's bitstring is the
    state index written most significant qubit first
    (``format(state, "0{n}b")``: qubit 0 is the last character).

    :param bitstring_evaluator: the objective
    :param shots: measurement shots per evaluation
    :param alpha: CVaR lower-tail mass in (0, 1]; 1 = plain expectation
    :param seed: base RNG seed of the shot stream
    :param initial_state: optional start state prepended to every circuit
    :param device: where the circuits run (None = the CUDA device)
    """

    def __init__(
        self,
        bitstring_evaluator: BitstringEvaluator,
        shots: int,
        alpha: float = 1.0,
        seed: int = 0,
        initial_state: Optional[np.ndarray] = None,
        device=None,
    ):
        super().__init__(bitstring_evaluator.input_length, device)
        if not 0 < alpha <= 1:
            raise ValueError("alpha (the CVaR tail fraction) lies outside (0, 1]")
        if shots < 1:
            raise ValueError("shots must be at least 1")
        self.bitstring_evaluator = bitstring_evaluator
        self.shots = int(shots)
        self.alpha = float(alpha)
        self._initial = _prepare_initial_state(initial_state, self.n_qubits, self.device)
        self._key = prng.PRNGKey(seed)
        self._counter = 0
        self._value_cache: dict[int, float] = {}

    def _next_keys(self, pop: int) -> torch.Tensor:
        """Per-individual keys [pop, 2] of the next evaluation round."""
        self._counter += 1
        return prng.split(prng.fold_in(self._key, self._counter), pop)

    def _state_value(self, state: int) -> float:
        if state not in self._value_cache:
            bitstring = format(state, f"0{self.n_qubits}b")
            self._value_cache[state] = self.bitstring_evaluator.evaluate_bitstring(bitstring)
        return self._value_cache[state]

    def probabilities(self, packed: PackedPopulation, angles=None) -> torch.Tensor:
        """Measurement probabilities [P, 2^n] on the optimizers' route."""
        from queasars_tpu_torch.optim.objective import population_probs

        return population_probs(
            *packed_tensors(packed, angles, self.device), n_qubits=self.n_qubits,
            initial_state=self.initial_states(packed.n_individuals),
        )

    def energies_from_probabilities(self, probs: torch.Tensor, keys: torch.Tensor) -> np.ndarray:
        """Objective values [P] (float64) of the shots drawn from ``probs``
        [P, 2^n] with ``keys`` [P, 2]."""
        return self.energies_from_samples(sample_indices(keys, probs, self.shots))

    def _block_samples(self, pop_args, rep_args) -> torch.Tensor:
        """Drawn basis indices [P, shots] of (gate_types, controls, angles,
        layer_mask, keys) on their device, from the shared start state."""
        from queasars_tpu_torch.optim.objective import population_probs

        *genome, keys = pop_args
        probs = population_probs(
            *genome, n_qubits=self.n_qubits,
            initial_state=expand_initial(rep_args[0], genome[0].shape[0]),
        )
        return sample_indices(keys, probs, self.shots)

    def energies_from_samples(self, samples: torch.Tensor) -> np.ndarray:
        """Objective values [P] (float64) of drawn basis indices [P, shots]."""
        observed, frequencies = sample_frequencies(samples, self.shots)
        observed = observed.cpu().numpy()
        values = np.array([self._state_value(int(s)) for s in observed], dtype=np.float64)
        weights = frequencies.cpu().numpy().astype(np.float64)
        if self.alpha >= 1.0:
            return weights @ values
        # CVaR tail accumulation over states sorted ascending by value --
        # the vectorized equivalent of the reference's sequential loop
        # (expectation_calculation.py:14-32)
        order = np.argsort(values, kind="stable")
        v_sorted = values[order]
        p_sorted = weights[:, order]
        cum_prev = np.cumsum(p_sorted, axis=1) - p_sorted
        tail = np.clip(self.alpha - cum_prev, 0.0, p_sorted)
        return (tail * v_sorted).sum(axis=1) / self.alpha

    def evaluate_packed(self, packed, angles=None):
        """The samples are drawn block by block under a mesh; the objective
        runs on the host over the whole population's observed states."""
        keys = self._next_keys(packed.n_individuals)
        samples = run_batched(
            self.mesh, self._block_samples, (*self._genome(packed, angles), keys),
            (self._initial,),
        )
        return self.energies_from_samples(samples)
