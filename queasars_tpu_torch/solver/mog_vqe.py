"""MoG-VQE solver facade: multi-objective evolving-ansatz VQE (PyTorch).

Counterpart of ``queasars_tpu/solver/mog_vqe.py``: MoG-VQE
(arXiv:2007.04424) evolves the ansatz against two objectives (energy,
two-qubit-gate count) with NSGA-II selection, yielding a Pareto front of
accuracy-vs-hardware-cost trade-offs instead of a single champion.

Reuses the EVQE configuration surface and operator pipeline with the
fitness-sharing selection swapped for
:class:`~queasars_tpu_torch.evolve.multiobjective.MultiObjectiveEVQESelection`
(the alpha/beta scalarization penalties and speciation/tournament knobs
are ignored: dominance replaces scalarization).
"""

from __future__ import annotations

from random import Random
from typing import Callable

from queasars_tpu_torch.evolve import (
    EVQELastLayerParameterSearch,
    EVQELayerRemoval,
    EVQEParameterSearch,
    EVQETopologicalSearch,
)
from queasars_tpu_torch.evolve.base import BaseEvolutionaryOperator
from queasars_tpu_torch.evolve.multiobjective import MultiObjectiveEVQESelection, pareto_front
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.optim.nft import BatchedNFT, NFTConfig
from queasars_tpu_torch.solver.driver import (
    EvolvingAnsatzMinimumEigensolver,
    EvolvingAnsatzMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.solver.evqe import EVQEMinimumEigensolverConfiguration
from queasars_tpu_torch.solver.result import EvolvingAnsatzMinimumEigensolverResult
from queasars_tpu_torch.utils.random import new_random_seed


def result_pareto_front(result: EvolvingAnsatzMinimumEigensolverResult):
    """The final generation's non-dominated (energy, controlled-gates) set:
    [(individual, energy, n_controlled_gates), ...]."""
    final = result.final_population_evaluation_result
    if final is None:
        return []
    return pareto_front(list(final.population.individuals), list(final.expectation_values))


class MoGVQEMinimumEigensolver(EvolvingAnsatzMinimumEigensolver):
    """Multi-objective genetic VQE (arXiv:2007.04424).

    Accepts the same configuration as the EVQE facade; the selection
    penalties / speciation / tournament fields are unused.
    """

    def __init__(self, configuration: EVQEMinimumEigensolverConfiguration):
        self.random_generator = Random(configuration.random_seed)

        population_initializer: Callable[[int], EVQEPopulation] = (
            lambda n_qubits: EVQEPopulation.random_population(
                n_qubits=n_qubits,
                n_layers=configuration.n_initial_layers,
                n_individuals=configuration.population_size,
                randomize_parameter_values=configuration.randomize_initial_population_parameters,
                random_seed=new_random_seed(self.random_generator),
            )
        )

        optimizer = configuration.optimizer or BatchedNFT(NFTConfig(maxiter=40))
        optimizer_evals = configuration.optimizer_n_circuit_evaluations
        if optimizer_evals is None and hasattr(optimizer, "config") and hasattr(
            optimizer.config, "n_circuit_evaluations"
        ):
            optimizer_evals = optimizer.config.n_circuit_evaluations()

        evolutionary_operators: list[BaseEvolutionaryOperator] = [
            EVQELastLayerParameterSearch(
                mutation_probability=1,
                optimizer=optimizer,
                optimizer_n_circuit_evaluations=optimizer_evals,
                random_seed=new_random_seed(self.random_generator),
            ),
            MultiObjectiveEVQESelection(
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
            distribution_alpha_tail=configuration.distribution_alpha_tail,
            initial_population=configuration.initial_population,
            pack_min_layers=configuration.pack_min_layers,
            checkpoint_path=configuration.checkpoint_path,
            resume_from_checkpoint=configuration.resume_from_checkpoint,
            mesh=configuration.mesh,
            n_devices=configuration.n_devices,
            shard_amplitudes=configuration.shard_amplitudes,
            parameter_order=configuration.parameter_order,
            reuse_selection_energies=configuration.reuse_selection_energies,
            device=configuration.device,
        )
        super().__init__(configuration=config)

    @classmethod
    def supports_aux_operators(cls) -> bool:
        return True
