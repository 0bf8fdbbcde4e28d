"""QNEAT solver facade: speciated neuro-evolution of circuit genomes (PyTorch).

Counterpart of ``queasars_tpu/solver/qneat.py``, with its operator order and
its ``random.Random`` seeding.

Implements the third algorithm the reference names as future work with no
code (reference README.md:3, docs/source/index.rst:10): QNEAT
(arXiv:2304.06981) — NEAT (Stanley & Miikkulainen 2002) over gate genomes
with innovation-number crossover, compatibility speciation and explicit
fitness sharing.  Populations evaluate as one batched device call via
the gene-list -> layered-tensor lowering (genome/qneat.py), so the
evaluators (the slot energies kernel on the card) and the batched
optimizers of the optional polish stage are reused unchanged.

Pipeline per generation (the classic NEAT cycle; selection is the
generation tick, like the reference's EVQE selection):

  [optional QNEATParameterPolish] -> QNEATSpeciationSelection
  (evaluate + speciate + share + reproduce) -> QNEATAngleMutation ->
  QNEATAddGate

``checkpoint_path`` / ``resume_from_checkpoint`` persist and restore the
full solver state (a QNEAT population, operator RNGs, ledger, trajectory,
evaluator randomness) exactly like the EVQE facade.  A population mesh
(``mesh`` / ``n_devices``) splits every evaluation and polish over its
devices, as in the EVQE facade, and ``shard_amplitudes`` / ``amp_devices``
split each statevector over a (pop, amp) factorization of it (EVQE facade
semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from random import Random
from typing import Optional

from queasars_tpu_torch.evolve.base import BaseEvolutionaryOperator
from queasars_tpu_torch.evolve.qneat import (
    QNEATAddGate,
    QNEATAngleMutation,
    QNEATParameterPolish,
    QNEATSpeciationSelection,
)
from queasars_tpu_torch.genome.qneat import QNEATPopulation
from queasars_tpu_torch.solver.configured_evaluators import ConfiguredEstimator, ConfiguredSampler
from queasars_tpu_torch.solver.driver import (
    EvolvingAnsatzMinimumEigensolver,
    EvolvingAnsatzMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.solver.termination_criteria import (
    EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion,
)
from queasars_tpu_torch.utils.random import new_random_seed


@dataclass
class QNEATMinimumEigensolverConfiguration:
    """QNEAT hyperparameter surface.

    :param configured_estimator / configured_sampler: evaluation path
        (same semantics as the EVQE facade)
    :param max_generations / max_circuit_evaluations /
        termination_criterion: at least one required
    :param random_seed: master seed for all evolutionary randomness
    :param population_size: genomes per generation
    :param distance_threshold: compatibility-distance species boundary
    :param c_excess / c_disjoint / c_angles: NEAT distance coefficients
    :param survival_fraction: per-species parent fraction
    :param crossover_probability: offspring via crossover vs clone
    :param elitism_threshold: species size from which the champion
        survives unchanged
    :param angle_mutation_probability / angle_perturbation_probability /
        angle_reset_probability / angle_sigma: weight-mutation knobs
    :param add_gate_probability: structural-mutation rate
    :param rotation_gate_probability: U3 vs CU3 for new genes
    :param optimizer: optional batched optimizer for the hybrid
        parameter-polish stage (None = pure QNEAT weight evolution)
    :param randomize_initial_parameters: random vs zero initial angles
    :param pack_min_layers / distribution_alpha_tail: engine knobs (EVQE
        facade semantics)
    :param checkpoint_path / resume_from_checkpoint: full-state checkpoint
        write / resume (EVQE facade semantics)
    :param mesh / n_devices: population mesh (EVQE facade semantics)
    :param shard_amplitudes / amp_devices: amplitude sharding (EVQE facade
        semantics)
    :param device: where the solve runs (None = the CUDA device)
    """

    configured_estimator: Optional[ConfiguredEstimator]
    configured_sampler: Optional[ConfiguredSampler]
    max_generations: Optional[int]
    max_circuit_evaluations: Optional[int]
    termination_criterion: Optional[EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion]
    random_seed: Optional[int] = None
    population_size: int = 20
    distance_threshold: float = 2.0
    c_excess: float = 1.0
    c_disjoint: float = 1.0
    c_angles: float = 0.4
    survival_fraction: float = 0.5
    crossover_probability: float = 0.75
    elitism_threshold: int = 3
    angle_mutation_probability: float = 0.8
    angle_perturbation_probability: float = 0.9
    angle_reset_probability: float = 0.05
    angle_sigma: float = 0.2
    add_gate_probability: float = 0.3
    rotation_gate_probability: float = 0.5
    optimizer: Optional[object] = None
    randomize_initial_parameters: bool = True
    checkpoint_path: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None
    distribution_alpha_tail: float = 1.0
    pack_min_layers: Optional[int] = None
    mesh: Optional[object] = None
    n_devices: Optional[int] = None
    shard_amplitudes: Optional[bool] = None
    amp_devices: Optional[int] = None
    device: Optional[object] = None

    def __post_init__(self):
        if self.population_size < 2:
            raise ValueError("QNEAT needs a population of at least 2")
        if not 0 < self.survival_fraction <= 1:
            raise ValueError("survival_fraction must be in (0, 1]")


class QNEATMinimumEigensolver(EvolvingAnsatzMinimumEigensolver):
    """Minimum eigensolver evolving gate genomes NEAT-style
    (arXiv:2304.06981) on the port's engine."""

    def __init__(self, configuration: QNEATMinimumEigensolverConfiguration):
        self.qneat_configuration = configuration
        self.random_generator = Random(configuration.random_seed)

        init_seed = new_random_seed(self.random_generator)

        def population_initializer(n_qubits: int) -> QNEATPopulation:
            return QNEATPopulation.initial(
                n_qubits=n_qubits,
                n_individuals=configuration.population_size,
                randomize=configuration.randomize_initial_parameters,
                random_seed=init_seed,
            )

        operators: list[BaseEvolutionaryOperator] = []
        if configuration.optimizer is not None:
            operators.append(
                QNEATParameterPolish(
                    optimizer=configuration.optimizer,
                    random_seed=new_random_seed(self.random_generator),
                )
            )
        operators.extend(
            [
                QNEATSpeciationSelection(
                    distance_threshold=configuration.distance_threshold,
                    c_excess=configuration.c_excess,
                    c_disjoint=configuration.c_disjoint,
                    c_angles=configuration.c_angles,
                    survival_fraction=configuration.survival_fraction,
                    crossover_probability=configuration.crossover_probability,
                    elitism_threshold=configuration.elitism_threshold,
                    random_seed=new_random_seed(self.random_generator),
                ),
                QNEATAngleMutation(
                    mutation_probability=configuration.angle_mutation_probability,
                    perturbation_probability=configuration.angle_perturbation_probability,
                    reset_probability=configuration.angle_reset_probability,
                    sigma=configuration.angle_sigma,
                    random_seed=new_random_seed(self.random_generator),
                ),
                QNEATAddGate(
                    mutation_probability=configuration.add_gate_probability,
                    rotation_probability=configuration.rotation_gate_probability,
                    random_seed=new_random_seed(self.random_generator),
                ),
            ]
        )

        config = EvolvingAnsatzMinimumEigensolverConfiguration(
            population_initializer=population_initializer,
            evolutionary_operators=operators,
            configured_sampler=configuration.configured_sampler,
            configured_estimator=configuration.configured_estimator,
            max_generations=configuration.max_generations,
            max_circuit_evaluations=configuration.max_circuit_evaluations,
            termination_criterion=configuration.termination_criterion,
            distribution_alpha_tail=configuration.distribution_alpha_tail,
            pack_min_layers=configuration.pack_min_layers,
            mesh=configuration.mesh,
            n_devices=configuration.n_devices,
            shard_amplitudes=configuration.shard_amplitudes,
            amp_devices=configuration.amp_devices,
            checkpoint_path=configuration.checkpoint_path,
            resume_from_checkpoint=configuration.resume_from_checkpoint,
            device=configuration.device,
        )
        super().__init__(configuration=config)

    @classmethod
    def supports_aux_operators(cls) -> bool:
        return True
