"""Generation-loop solver driver (PyTorch port).

Counterpart of ``queasars_tpu/solver/driver.py`` (behavioral port of
queasars/minimum_eigensolvers/base/evolving_ansatz_minimum_eigensolver.py:
53-478): operator pipeline with budget-aware early stop, result and
evaluation-count callbacks as the generation boundary, termination
criteria, and final result assembly.

The port runs the JAX package's production fused route: the exact
estimator on the slot kernels, the prefix cache, fused multi-slot parameter
search and selection energy reuse; with a configured sampler (or an
estimator ``precision``), shot-sampled evaluation through the in-kernel
samplers -- grouped by QWC measurement groups for a general operator, with
the sampler's ``shot_allocation`` -- and a sampled final distribution in the
computational basis.  Where the fused search does not apply (an exact
estimator solve of a general operator, an optimizer's ``cache_prefix``
off, COBYLA, an evaluator without objective operands),
``EVQEParameterSearch`` runs its per-slot loop.  An injected external
evaluator (``evaluator=``, ``sim/external.py``) or a black-box bitstring
objective (:meth:`EvolvingAnsatzMinimumEigensolver.compute_minimum_function_value`)
drives the optimizers' host-stepped loops.  Checkpoint and resume write and
read the JAX package's format (``solver/checkpoint.py``).  A population
mesh (``mesh`` / ``n_devices``, ``parallel/mesh.py``) is attached to every
evaluator the driver builds, so every population evaluation and search runs
block by block over its devices (the reference's dask-executor seam,
base/evolutionary_algorithm.py:110-118, selection.py:75-84); an injected
evaluator keeps its own placement, as in the reference.  Where the
reference shards amplitudes (``shard_amplitudes=True`` with a mesh, or None
with a mesh and more than 20 qubits), the operator and aux evaluators are
``AmplitudeShardedExpectationEvaluator`` s on the mesh refactored into
(pop, amp) (``sim/sharded_evaluator.py``): the amplitude axis the smallest
power of two that keeps a shard at ``amp_local_qubits`` qubits (or
``amp_devices``), the population the remaining factor.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
from numpy import mean, median

from queasars_tpu_torch.evolve.base import (
    BaseEvolutionaryOperator,
    BasePopulationEvaluationResult,
    OperatorContext,
    PopulationEnergyCache,
)
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.optim.objective import population_probs
from queasars_tpu_torch.sim.evaluators import (
    BaseCircuitEvaluator,
    BitstringFunctionEvaluator,
    CircuitEvaluatorException,
    SamplerExpectationEvaluator,
    StatevectorExpectationEvaluator,
    packed_tensors,
)
from queasars_tpu_torch.sim.sampling import quasi_distribution, sample_counts
from queasars_tpu_torch.solver.configured_evaluators import ConfiguredEstimator, ConfiguredSampler
from queasars_tpu_torch.solver.result import EvolvingAnsatzMinimumEigensolverResult
from queasars_tpu_torch.solver.termination_criteria import (
    EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion,
)
from queasars_tpu_torch.utils import prng
from queasars_tpu_torch.utils.bitstring_evaluation import BitstringEvaluator
from queasars_tpu_torch.utils.profiling import solve_entry, span, spanned

ListOrDict = Union[list, dict, None]

#: folded into the sampler's seed for the final distribution's key
EIGENSTATE_KEY_SALT = 0x5EED


@dataclass
class EvolvingAnsatzMinimumEigensolverConfiguration:
    """Driver configuration
    (reference: evolving_ansatz_minimum_eigensolver.py:53-119).

    :param population_initializer: problem-size (qubits) -> initial population
    :param evolutionary_operators: the per-generation operator pipeline
    :param configured_sampler: shot settings: with no estimator every
        evaluation samples them; either way they sample the final
        distribution
    :param configured_estimator: expectation settings (exact, or
        shot-based with ``precision > 0``); one of the two is required
        unless an ``evaluator`` is injected
    :param max_generations / max_circuit_evaluations / termination_criterion:
        at least one must be set
    :param evaluator: a pluggable external evaluation backend
        (``sim/external.py``): a ready ``BaseCircuitEvaluator`` instance or
        a factory ``operator -> BaseCircuitEvaluator`` (needed when aux
        operators should also be measured externally).  When set, every
        fitness evaluation goes through it and the optimizers step on the
        host; a configured sampler still samples the final distribution.
    :param distribution_alpha_tail: CVaR alpha of the sampler path
    :param initial_population: optional start population
    :param pack_min_layers: fixed lower bound of the packed layer dimension
    :param checkpoint_path: when set, the full solver state (population,
        operator RNG states, generation counter, evaluation ledger,
        trajectory, best-so-far, the evaluator's shot counter) is written
        there as JSON after every completed pipeline pass
    :param resume_from_checkpoint: a checkpoint written through
        ``checkpoint_path`` (by either package); the solve continues where
        it stopped and reproduces the uninterrupted run's remaining
        trajectory
    :param mesh: a :class:`~queasars_tpu_torch.parallel.mesh.PopulationMesh`
        to split the population axis over: every evaluation and search
        then runs block by block on its devices
    :param n_devices: shorthand for ``mesh``: ``population_mesh(n_devices)``
        over the first cards, or ``n_devices`` CPU blocks when ``device`` is
        the CPU
    :param shard_amplitudes: split each statevector over the mesh's
        amplitude axis (``sim/sharded_evaluator.py``); None shards a mesh
        solve above 20 qubits, True any mesh solve, False none
    :param amp_devices: cells of the amplitude axis (None: the smallest
        power of two keeping a shard at ``amp_local_qubits`` qubits)
    :param amp_local_qubits: the largest shard, in qubits, the default
        factorization allows (20)
    :param parameter_order: "canonical" or "qiskit" flat-parameter order
    :param reuse_selection_energies: selection reuses the exact final
        energies of the preceding last-layer search (None = on)
    :param device: where the solve runs (None = the CUDA device)
    """

    population_initializer: Callable[[int], EVQEPopulation]
    evolutionary_operators: list[BaseEvolutionaryOperator]
    configured_sampler: Optional[ConfiguredSampler]
    configured_estimator: Optional[ConfiguredEstimator]
    max_generations: Optional[int]
    max_circuit_evaluations: Optional[int]
    termination_criterion: Optional[EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion]
    evaluator: Optional[object] = None
    distribution_alpha_tail: float = 1.0
    initial_population: Optional[EVQEPopulation] = field(default=None)
    pack_min_layers: Optional[int] = None
    checkpoint_path: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None
    mesh: Optional[object] = None
    n_devices: Optional[int] = None
    parameter_order: str = "canonical"
    reuse_selection_energies: Optional[bool] = None
    device: Optional[object] = None
    shard_amplitudes: Optional[bool] = None
    amp_devices: Optional[int] = None
    amp_local_qubits: int = 20

    def __post_init__(self):
        if (
            self.max_generations is None
            and self.max_circuit_evaluations is None
            and self.termination_criterion is None
        ):
            raise ValueError(
                "no stopping condition configured: set max_generations, "
                "max_circuit_evaluations and/or a termination_criterion"
            )
        if (
            self.configured_sampler is None
            and self.configured_estimator is None
            and self.evaluator is None
        ):
            raise ValueError(
                "provide a configured_sampler and/or a configured_estimator "
                "(or inject an external evaluator)"
            )


class EvolvingAnsatzMinimumEigensolver:
    """Minimum eigensolver evolving the ansatz architecture alongside its
    rotation angles (reference: evolving_ansatz_minimum_eigensolver.py:
    122-478)."""

    def __init__(self, configuration: EvolvingAnsatzMinimumEigensolverConfiguration):
        self.configuration = configuration
        self.logger = logging.getLogger(__name__)

    def _resolve_mesh(self):
        """The population mesh to run on (None = the configured device)."""
        if self.configuration.mesh is not None:
            return self.configuration.mesh
        if self.configuration.n_devices is not None:
            from queasars_tpu_torch.parallel.mesh import mesh_of

            return mesh_of(self.configuration.n_devices, self.configuration.device)
        return None

    def amplitude_sharding_applies(self, mesh, n_qubits: int) -> bool:
        """Whether a solve shards amplitudes: never without a mesh or with
        ``shard_amplitudes=False``; by default above 20 qubits."""
        requested = self.configuration.shard_amplitudes
        if requested is False or mesh is None:
            return False
        if requested is None:
            return n_qubits > 20
        return True

    def resolve_amp_devices(self, mesh, n_qubits: int) -> int:
        """The (pop, amp) factorization: ``amp_devices``, or the smallest
        power-of-two amplitude axis that keeps each shard at
        ``amp_local_qubits`` qubits or fewer; the population keeps the
        remaining devices."""
        if self.configuration.amp_devices is not None:
            return self.configuration.amp_devices
        total = mesh.size
        amp = 1
        while (amp < total and n_qubits - (amp.bit_length() - 1)
               > self.configuration.amp_local_qubits):
            amp *= 2
        return amp

    def compute_minimum_eigenvalue(
        self,
        operator: PauliSum,
        aux_operators: ListOrDict = None,
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        """Find the minimum eigenvalue of ``operator`` (reference: :177-199)."""
        return self.compute_minimum_eigenvalue_with_initial_state(
            operator=operator, aux_operators=aux_operators, initial_state=None
        )

    @solve_entry
    def compute_minimum_eigenvalue_with_initial_state(
        self,
        operator: PauliSum,
        aux_operators: ListOrDict = None,
        initial_state: Union[np.ndarray, EVQEIndividual, None] = None,
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        """Like :meth:`compute_minimum_eigenvalue`, starting every circuit
        from ``initial_state`` (a [2^n] complex or [2, 2^n] re/im state, or
        an :class:`EVQEIndividual` preparing it; reference: :201-276)."""
        if self.configuration.evaluator is not None:
            return self._solve_with_injected_evaluator(operator, aux_operators, initial_state)

        mesh = self._resolve_mesh()

        @spanned("evaluator.build")
        def build_evaluator(op: PauliSum) -> BaseCircuitEvaluator:
            config = self.configuration
            if self.amplitude_sharding_applies(mesh, op.n_qubits):
                from queasars_tpu_torch.sim.sharded_evaluator import (
                    AmplitudeShardedExpectationEvaluator,
                )

                amp = self.resolve_amp_devices(mesh, op.n_qubits)
                estimator = config.configured_estimator
                if estimator is not None:
                    return AmplitudeShardedExpectationEvaluator(
                        operator=op, mesh=mesh, precision=estimator.precision or 0.0,
                        seed=estimator.seed, initial_state=initial_state, amp_devices=amp,
                    )
                sampler = config.configured_sampler
                return AmplitudeShardedExpectationEvaluator(
                    operator=op, mesh=mesh, shots=sampler.shots,
                    alpha=config.distribution_alpha_tail, seed=sampler.seed,
                    initial_state=initial_state, amp_devices=amp,
                    shot_allocation=sampler.shot_allocation,
                )
            if config.configured_estimator is not None:
                evaluator = StatevectorExpectationEvaluator(
                    operator=op, alpha=1.0, initial_state=initial_state,
                    precision=config.configured_estimator.precision or 0.0,
                    seed=config.configured_estimator.seed, device=config.device,
                )
            else:
                sampler = config.configured_sampler
                evaluator = SamplerExpectationEvaluator(
                    operator=op, shots=sampler.shots, alpha=config.distribution_alpha_tail,
                    seed=sampler.seed, initial_state=initial_state, device=config.device,
                    shot_allocation=sampler.shot_allocation,
                )
            if mesh is not None:
                evaluator.set_mesh(mesh)
            return evaluator

        evaluator = build_evaluator(operator)
        aux_evaluators: ListOrDict = None
        if isinstance(aux_operators, list):
            aux_evaluators = [build_evaluator(op) for op in aux_operators]
        elif isinstance(aux_operators, dict):
            aux_evaluators = {key: build_evaluator(op) for key, op in aux_operators.items()}
        return self._solve(evaluator, aux_evaluators, initial_state)

    def _solve(self, evaluator, aux_evaluators, initial_state):
        from queasars_tpu_torch.genome.parameter_order import parameter_order

        with parameter_order(self.configuration.parameter_order):
            result = self._solve_by_evolution(evaluator, aux_evaluators)
        result.initial_state = initial_state
        return result

    def _solve_with_injected_evaluator(
        self, operator: PauliSum, aux_operators: ListOrDict, initial_state
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        """Evolution driven by the configuration's injected external
        evaluator (the reference's pluggable-primitive capability:
        evolving_ansatz_minimum_eigensolver.py:227-251)."""
        from queasars_tpu_torch.sim.external import resolve_injected_evaluator

        if initial_state is not None:
            raise CircuitEvaluatorException(
                "initial_state cannot be combined with an injected external "
                "evaluator: the external backend owns state preparation — "
                "prepend the initial-state circuit inside your backend, or "
                "use the internal engines"
            )
        config = self.configuration
        injected = config.evaluator
        evaluator = resolve_injected_evaluator(injected, operator, role="operator")
        aux_evaluators: ListOrDict = None
        if aux_operators is not None:
            if isinstance(injected, BaseCircuitEvaluator) and (
                config.configured_estimator is None and config.configured_sampler is None
            ):
                raise CircuitEvaluatorException(
                    "aux_operators with an injected evaluator INSTANCE need "
                    "either a factory callable (operator -> evaluator) as the "
                    "evaluator, or a configured_estimator/configured_sampler "
                    "for the aux evaluations"
                )

            def build_aux(op: PauliSum):
                if not isinstance(injected, BaseCircuitEvaluator):
                    return resolve_injected_evaluator(injected, op, role="aux operator")
                if config.configured_estimator is not None:
                    return StatevectorExpectationEvaluator(
                        operator=op, precision=config.configured_estimator.precision or 0.0,
                        seed=config.configured_estimator.seed, device=config.device,
                    )
                return SamplerExpectationEvaluator(
                    operator=op, shots=config.configured_sampler.shots,
                    alpha=config.distribution_alpha_tail, seed=config.configured_sampler.seed,
                    device=config.device,
                )

            if isinstance(aux_operators, list):
                aux_evaluators = [build_aux(op) for op in aux_operators]
            else:
                aux_evaluators = {k: build_aux(op) for k, op in aux_operators.items()}
        return self._solve(evaluator, aux_evaluators, None)

    @solve_entry
    def compute_minimum_function_value(
        self,
        operator: BitstringEvaluator,
        aux_operators: ListOrDict = None,
        initial_state: Union[np.ndarray, EVQEIndividual, None] = None,
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        """Minimize a black-box bitstring objective over the configured
        sampler's shots (reference: :278-329); the optimizers step on the
        host against :class:`BitstringFunctionEvaluator`."""
        config = self.configuration
        if config.configured_sampler is None:
            raise ValueError("compute_minimum_function_value requires a configured_sampler!")

        mesh = self._resolve_mesh()

        @spanned("evaluator.build")
        def build_evaluator(op: BitstringEvaluator) -> BaseCircuitEvaluator:
            evaluator = BitstringFunctionEvaluator(
                bitstring_evaluator=op, shots=config.configured_sampler.shots,
                alpha=config.distribution_alpha_tail, seed=config.configured_sampler.seed,
                initial_state=initial_state, device=config.device,
            )
            if mesh is not None:
                evaluator.set_mesh(mesh)
            return evaluator

        evaluator = build_evaluator(operator)
        aux_evaluators: ListOrDict = None
        if isinstance(aux_operators, list):
            aux_evaluators = [build_evaluator(op) for op in aux_operators]
        elif isinstance(aux_operators, dict):
            aux_evaluators = {key: build_evaluator(op) for key, op in aux_operators.items()}
        return self._solve(evaluator, aux_evaluators, initial_state)

    # ------------------------------------------------------------------
    # the generation loop (reference: :331-478)
    # ------------------------------------------------------------------

    def _solve_by_evolution(
        self,
        circuit_evaluator: BaseCircuitEvaluator,
        aux_circuit_evaluators: ListOrDict,
    ) -> EvolvingAnsatzMinimumEigensolverResult:
        n_circuit_evaluations: list[int] = []
        n_generations = 0
        terminate = False
        current_best_individual: Optional[EVQEIndividual] = None
        current_best_expectation_value: Optional[float] = None
        population_evaluations: list[BasePopulationEvaluationResult] = []
        if self.configuration.termination_criterion is not None:
            self.configuration.termination_criterion.reset_state()

        resume_state = None
        if self.configuration.resume_from_checkpoint is not None:
            from queasars_tpu_torch.solver.checkpoint import (
                load_checkpoint,
                restore_evaluator_state,
                restore_operator_rng_states,
            )

            resume_state = load_checkpoint(self.configuration.resume_from_checkpoint)
            n_circuit_evaluations = list(resume_state.n_circuit_evaluations)
            n_generations = resume_state.n_generations
            population_evaluations = list(resume_state.population_evaluations)
            current_best_individual = resume_state.best_individual
            current_best_expectation_value = resume_state.best_expectation_value
            if resume_state.operator_rngs:
                restore_operator_rng_states(
                    self.configuration.evolutionary_operators, resume_state.operator_rngs
                )
            restore_evaluator_state(circuit_evaluator, resume_state.evaluator)
            # replay the termination criterion over the restored trajectory
            # so its internal windows match the uninterrupted run
            if self.configuration.termination_criterion is not None:
                replay_best_individual: Optional[EVQEIndividual] = None
                replay_best_value: Optional[float] = None
                for evaluation in population_evaluations:
                    if (
                        replay_best_value is None
                        or evaluation.best_expectation_value < replay_best_value
                    ):
                        replay_best_individual = evaluation.best_individual
                        replay_best_value = evaluation.best_expectation_value
                    terminate = self.configuration.termination_criterion.check_termination(
                        population_evaluation=evaluation,
                        best_individual=replay_best_individual,
                        best_expectation_value=replay_best_value,
                    )

        def result_callback(evaluation_result: BasePopulationEvaluationResult) -> None:
            nonlocal current_best_individual, current_best_expectation_value
            nonlocal terminate, n_generations

            population_evaluations.append(evaluation_result)
            if (
                current_best_expectation_value is None
                or evaluation_result.best_expectation_value < current_best_expectation_value
            ):
                current_best_individual = evaluation_result.best_individual
                current_best_expectation_value = evaluation_result.best_expectation_value

            self.logger.info("Results for generation: %d", n_generations)
            self.logger.info(
                "generation best expectation value: %f", evaluation_result.best_expectation_value
            )
            filtered = [v for v in evaluation_result.expectation_values if v is not None]
            self.logger.info("generation median expectation value: %f", median(filtered))
            self.logger.info("generation mean expectation value: %f", mean(filtered))

            n_generations += 1

            if self.configuration.termination_criterion is not None:
                terminate = self.configuration.termination_criterion.check_termination(
                    population_evaluation=evaluation_result,
                    best_individual=current_best_individual,
                    best_expectation_value=current_best_expectation_value,
                )

        def circuit_evaluation_callback(evaluations: int) -> None:
            if len(n_circuit_evaluations) < n_generations + 1:
                n_circuit_evaluations.append(evaluations)
            else:
                n_circuit_evaluations[n_generations] += evaluations

        reuse_energies = self.configuration.reuse_selection_energies is not False
        operator_context = OperatorContext(
            circuit_evaluator=circuit_evaluator,
            result_callback=result_callback,
            circuit_evaluation_count_callback=circuit_evaluation_callback,
            pack_min_layers=self.configuration.pack_min_layers,
            energy_cache=PopulationEnergyCache() if reuse_energies else None,
        )

        if resume_state is not None:
            population = resume_state.population
        elif self.configuration.initial_population is not None:
            population = self.configuration.initial_population
        else:
            population = self.configuration.population_initializer(circuit_evaluator.n_qubits)

        self.logger.info("Starting evolution!")

        operators = self.configuration.evolutionary_operators
        labels = [f"operator.{type(operator).__name__}" for operator in operators]
        while not terminate:
            for operator, label in zip(operators, labels):
                # budget checks before each operator (reference: :405-428)
                if (
                    self.configuration.max_circuit_evaluations is not None
                    and sum(n_circuit_evaluations) >= self.configuration.max_circuit_evaluations
                ):
                    terminate = True
                estimated = operator.get_n_expected_circuit_evaluations(
                    population=population, operator_context=operator_context
                )
                if (
                    self.configuration.max_circuit_evaluations is not None
                    and estimated is not None
                    and sum(n_circuit_evaluations) + estimated
                    >= self.configuration.max_circuit_evaluations
                ):
                    terminate = True
                if (
                    self.configuration.max_generations is not None
                    and n_generations >= self.configuration.max_generations
                ):
                    terminate = True
                if terminate:
                    break
                with span(label):
                    population = operator.apply_operator(
                        population=population, operator_context=operator_context
                    )
            else:
                # one full pipeline pass completed: persist the whole solver
                # state, so a crash resumes the exact trajectory
                if self.configuration.checkpoint_path is not None:
                    from queasars_tpu_torch.solver.checkpoint import write_checkpoint

                    write_checkpoint(
                        self.configuration.checkpoint_path,
                        population=population,
                        n_generations=n_generations,
                        n_circuit_evaluations=n_circuit_evaluations,
                        population_evaluations=population_evaluations,
                        best_individual=current_best_individual,
                        best_expectation_value=current_best_expectation_value,
                        operators=self.configuration.evolutionary_operators,
                        evaluator=circuit_evaluator,
                    )

        if current_best_individual is None or len(population_evaluations) == 0:
            raise RuntimeError(
                "the solve terminated before any population evaluation completed "
                "(budget too small for even one selection step?)"
            )

        result = EvolvingAnsatzMinimumEigensolverResult()
        result.eigenvalue = current_best_expectation_value
        result.eigenstate = self._measure_eigenstate(current_best_individual, circuit_evaluator)
        result.best_individual = current_best_individual
        result.circuit_evaluations = n_circuit_evaluations
        result.generations = n_generations
        result.population_evaluation_results = population_evaluations

        if isinstance(aux_circuit_evaluators, list):
            result.aux_operators_evaluated = [
                evaluator.evaluate_individuals([current_best_individual])[0]
                for evaluator in aux_circuit_evaluators
            ]
        elif isinstance(aux_circuit_evaluators, dict):
            result.aux_operators_evaluated = {
                name: evaluator.evaluate_individuals([current_best_individual])[0]
                for name, evaluator in aux_circuit_evaluators.items()
            }

        return result

    def _measure_eigenstate(
        self, individual: EVQEIndividual, evaluator: BaseCircuitEvaluator
    ) -> dict[int, float]:
        """Measurement distribution of the best circuit: its probabilities
        (a probabilities kernel on the card, on the optimizers' route),
        sampled with the configured sampler's shots under the key
        ``fold_in(PRNGKey(seed), 0x5EED)`` when one is configured, exact
        otherwise (reference: driver.py ``_measure_eigenstate``)."""
        with span("eigenstate") as region:
            packed = PackedPopulation.pack([individual])
            probs = population_probs(
                *packed_tensors(packed, device=evaluator.device),
                n_qubits=packed.n_qubits,
                initial_state=evaluator.initial_states(1),
            )[0]
            sampler = self.configuration.configured_sampler
            if sampler is not None:
                key = prng.fold_in(prng.PRNGKey(sampler.seed), EIGENSTATE_KEY_SALT)
                probs = sample_counts(key, probs, sampler.shots)
            with span("wait.eigenstate"):
                values = probs.cpu().numpy()
            if sampler is not None:
                values = values.astype(np.float64) / sampler.shots
            distribution = quasi_distribution(values)
            region.set(entries=len(distribution))
            return distribution
