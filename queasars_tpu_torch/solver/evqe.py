"""EVQE solver facade (PyTorch port).

Counterpart of ``queasars_tpu/solver/evqe.py`` (behavioral port of
queasars/minimum_eigensolvers/evqe/evqe.py:34-255): translates the flat EVQE
hyperparameter surface into the generic driver configuration, building the
six-operator pipeline in the reference's fixed order — last-layer parameter
search, speciation, selection, full parameter search, topological search,
layer removal (:198-230) — with every operator seeded from one master
``Random`` in the same call order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from random import Random
from typing import Callable, Optional

from queasars_tpu_torch.evolve import (
    EVQELastLayerParameterSearch,
    EVQELayerRemoval,
    EVQEParameterSearch,
    EVQESelection,
    EVQESpeciation,
    EVQETopologicalSearch,
)
from queasars_tpu_torch.evolve.base import BaseEvolutionaryOperator
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.optim.nft import BatchedNFT, NFTConfig
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
class EVQEMinimumEigensolverConfiguration:
    """EVQE hyperparameter surface (reference: evqe.py:34-177).

    :param configured_estimator: exact-expectation settings (required)
    :param configured_sampler: not ported yet (must be None)
    :param optimizer: batched parameter optimizer (default NFT(maxiter=40)
        if None); any object with the BatchedNFT.minimize contract
    :param optimizer_n_circuit_evaluations: expected evaluations per
        optimizer run (derived from the optimizer config when None)
    :param max_generations / max_circuit_evaluations /
        termination_criterion: at least one required
    :param random_seed: master seed for all evolutionary randomness
    :param population_size: individuals per generation
    :param speciation_genetic_distance_threshold: species boundary
    :param selection_alpha_penalty: fitness penalty per circuit layer
    :param selection_beta_penalty: fitness penalty per controlled gate
    :param parameter_search_probability / topological_search_probability /
        layer_removal_probability: per-individual mutation probabilities
    :param n_initial_layers: layers per individual in generation 0
    :param use_tournament_selection / tournament_size: selection mode
    :param randomize_initial_population_parameters: random vs zero initial
        angles
    :param initial_population: optional start population
    :param pack_min_layers: fixed lower bound of the packed layer dimension
    :param checkpoint_path / resume_from_checkpoint / mesh / n_devices: not
        ported yet (must be None)
    :param device: where the solve runs (None = the CUDA device)
    """

    configured_estimator: Optional[ConfiguredEstimator]
    configured_sampler: Optional[ConfiguredSampler]
    optimizer: Optional[object]
    optimizer_n_circuit_evaluations: Optional[int]
    max_generations: Optional[int]
    max_circuit_evaluations: Optional[int]
    termination_criterion: Optional[EvolvingAnsatzMinimumEigensolverBaseTerminationCriterion]
    random_seed: Optional[int]
    population_size: int
    speciation_genetic_distance_threshold: int
    selection_alpha_penalty: float
    selection_beta_penalty: float
    parameter_search_probability: float
    topological_search_probability: float
    layer_removal_probability: float
    n_initial_layers: int = 1
    use_tournament_selection: bool = False
    tournament_size: Optional[int] = None
    randomize_initial_population_parameters: bool = True
    initial_population: Optional[EVQEPopulation] = field(default=None)
    pack_min_layers: Optional[int] = None
    checkpoint_path: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None
    mesh: Optional[object] = None
    n_devices: Optional[int] = None
    parameter_order: str = "canonical"
    reuse_selection_energies: Optional[bool] = None
    device: Optional[object] = None

    def __post_init__(self):
        for name in (
            "parameter_search_probability",
            "topological_search_probability",
            "layer_removal_probability",
        ):
            if not 0 <= getattr(self, name) <= 1:
                raise ValueError(f"{name} must lie within [0, 1]")
        if self.n_initial_layers < 1:
            raise ValueError(f"n_initial_layers must be >= 1 (got {self.n_initial_layers})")
        if self.use_tournament_selection and self.tournament_size is None:
            raise ValueError("tournament selection needs an explicit tournament_size")
        if self.use_tournament_selection and self.tournament_size < 1:
            raise ValueError(f"tournament_size must be positive (got {self.tournament_size})")
        if self.use_tournament_selection and self.population_size < self.tournament_size:
            raise ValueError(
                f"tournament_size ({self.tournament_size}) cannot exceed the "
                f"population size ({self.population_size})"
            )


class EVQEMinimumEigensolver(EvolvingAnsatzMinimumEigensolver):
    """The EVQE algorithm (arXiv:1910.09694) on the slot kernels
    (reference: evqe.py:180-255)."""

    def __init__(self, configuration: EVQEMinimumEigensolverConfiguration):
        self.random_generator = Random(configuration.random_seed)

        # the population seed is drawn lazily at solve time, AFTER the
        # operator seeds below — the reference's exact draw order
        # (evqe.py:190-196 evaluates new_random_seed inside the lambda)
        population_initializer: Callable[[int], EVQEPopulation] = (
            lambda n_qubits: EVQEPopulation.random_population(
                n_qubits=n_qubits,
                n_layers=configuration.n_initial_layers,
                n_individuals=configuration.population_size,
                randomize_parameter_values=configuration.randomize_initial_population_parameters,
                random_seed=new_random_seed(self.random_generator),
            )
        )

        optimizer = configuration.optimizer
        if optimizer is None:
            optimizer = BatchedNFT(NFTConfig(maxiter=40))
        optimizer_evals = configuration.optimizer_n_circuit_evaluations
        if optimizer_evals is None and hasattr(optimizer, "config") and hasattr(
            optimizer.config, "n_circuit_evaluations"
        ):
            optimizer_evals = optimizer.config.n_circuit_evaluations()

        # pipeline order and seeding exactly as the reference (evqe.py:198-230)
        evolutionary_operators: list[BaseEvolutionaryOperator] = [
            EVQELastLayerParameterSearch(
                mutation_probability=1,
                optimizer=optimizer,
                optimizer_n_circuit_evaluations=optimizer_evals,
                random_seed=new_random_seed(self.random_generator),
            ),
            EVQESpeciation(
                genetic_distance_threshold=configuration.speciation_genetic_distance_threshold,
                random_seed=new_random_seed(self.random_generator),
            ),
            EVQESelection(
                alpha_penalty=configuration.selection_alpha_penalty,
                beta_penalty=configuration.selection_beta_penalty,
                use_tournament_selection=configuration.use_tournament_selection,
                tournament_size=configuration.tournament_size,
                random_seed=new_random_seed(self.random_generator),
            ),
            EVQEParameterSearch(
                mutation_probability=configuration.parameter_search_probability,
                optimizer=optimizer,
                optimizer_n_circuit_evaluations=optimizer_evals,
                random_seed=new_random_seed(self.random_generator),
            ),
            EVQETopologicalSearch(
                mutation_probability=configuration.topological_search_probability,
                random_seed=new_random_seed(self.random_generator),
            ),
            EVQELayerRemoval(
                mutation_probability=configuration.layer_removal_probability,
                random_seed=new_random_seed(self.random_generator),
            ),
        ]

        config = EvolvingAnsatzMinimumEigensolverConfiguration(
            population_initializer=population_initializer,
            evolutionary_operators=evolutionary_operators,
            configured_sampler=configuration.configured_sampler,
            configured_estimator=configuration.configured_estimator,
            max_generations=configuration.max_generations,
            max_circuit_evaluations=configuration.max_circuit_evaluations,
            termination_criterion=configuration.termination_criterion,
            initial_population=configuration.initial_population,
            pack_min_layers=configuration.pack_min_layers,
            checkpoint_path=configuration.checkpoint_path,
            resume_from_checkpoint=configuration.resume_from_checkpoint,
            mesh=configuration.mesh,
            n_devices=configuration.n_devices,
            parameter_order=configuration.parameter_order,
            reuse_selection_energies=configuration.reuse_selection_energies,
            device=configuration.device,
        )
        super().__init__(configuration=config)

    @classmethod
    def supports_aux_operators(cls) -> bool:
        """Reference: evqe.py:253-255."""
        return True
