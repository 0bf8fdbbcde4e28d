"""EVQE mutation operators: parameter searches, growth, removal.

Behavioral port of
queasars/minimum_eigensolvers/evqe/evolutionary_algorithm/mutation.py:28-399
with the execution model inverted: instead of fanning each selected
individual out as a future that runs its own qiskit optimizer loop
(mutation.py:206-218 — the reference's dominant wall-clock cost), the
selected subset optimizes **in lock-step on device** via the batched
optimizers.  Host-side randomness (Bernoulli selection, per-individual
seeds, layer orders) follows the reference's exact ``random.Random`` call
order.

Evaluation accounting note: the ledger reports the reference-equivalent
count (selected individuals x optimizer evaluations) — the quantity the
budget semantics are defined over — even though the device physically
evaluates the whole batch each step.
"""

from __future__ import annotations

import inspect
from math import ceil
from random import Random
from typing import Optional, Sequence

import numpy as np

from queasars_tpu_torch.evolve.base import BaseEvolutionaryOperator
from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation, unpack_individual
from queasars_tpu_torch.genome.population import EVQEPopulation
from queasars_tpu_torch.utils.random import new_random_seed


def _batched_layer_optimization(
    individuals: Sequence[EVQEIndividual],
    selected: np.ndarray,
    layer_choice: Sequence[Optional[int]],
    optimizer,
    evaluator,
    angles: Optional[np.ndarray],
    packed: PackedPopulation,
    seed: int,
) -> tuple[np.ndarray, int]:
    """Optimize one (per-individual) layer for the selected subset.

    :param layer_choice: per individual, which layer to optimize (may be
        negative; None for unselected individuals)
    :return: (updated angle tensor, final energies [P] as reported by the
        optimizer, reference-equivalent evaluation count)
    """
    pop = len(individuals)
    coords_list: list[np.ndarray] = []
    for i in range(pop):
        if selected[i] and layer_choice[i] is not None:
            coords_list.append(packed.layer_param_coordinates(i, layer_choice[i]))
        else:
            coords_list.append(np.zeros((0, 3), np.int32))
    k_max = max((c.shape[0] for c in coords_list), default=0)
    coords = np.zeros((pop, max(k_max, 1), 3), np.int32)
    n_free = np.zeros(pop, np.int32)
    for i, c in enumerate(coords_list):
        coords[i, : c.shape[0]] = c
        n_free[i] = c.shape[0]
    active = np.logical_and(selected, n_free > 0)

    kwargs = {}
    if "last_layer" in inspect.signature(optimizer.minimize).parameters:
        # layer-prefix-cache hint: valid when every selected individual
        # optimizes its LAST real layer (then the probed parameters cannot
        # affect anything after the optimized layer)
        real_layers = packed.layer_mask.sum(axis=1).astype(np.int32)
        if all(
            layer_choice[i] is None or layer_choice[i] % real_layers[i] == real_layers[i] - 1
            for i in range(pop)
            if selected[i]
        ):
            kwargs["last_layer"] = real_layers - 1

    new_angles, energies, nfev_each = optimizer.minimize(
        evaluator, packed, coords, n_free, active, angles=angles, seed=seed, **kwargs
    )
    return new_angles, energies, int(active.sum()) * int(nfev_each)


class BaseEVQEMutationOperator(BaseEvolutionaryOperator[EVQEPopulation]):
    """Shared Bernoulli-selection plumbing; clears speciation member info
    (reference: mutation.py:160-241).

    :param mutation_probability: per-individual application probability
    :param optimizer: a batched optimizer (BatchedNFT/BatchedSPSA) or None
    :param optimizer_n_circuit_evaluations: expected evaluations per
        optimizer run (None if unknown) — budget pre-estimates
    :param random_seed: operator RNG seed
    """

    def __init__(
        self,
        mutation_probability: float,
        optimizer,
        optimizer_n_circuit_evaluations: Optional[int],
        random_seed: Optional[int] = None,
    ):
        self.mutation_probability = mutation_probability
        self.optimizer = optimizer
        self.optimizer_n_circuit_evaluations = optimizer_n_circuit_evaluations
        self.random_generator = Random(random_seed)

    def _draw_selection(self, population: EVQEPopulation) -> tuple[np.ndarray, list[Optional[int]]]:
        """Bernoulli per individual + child seed per selected individual —
        the reference's exact call order (mutation.py:206-216)."""
        selected = np.zeros(len(population.individuals), dtype=bool)
        seeds: list[Optional[int]] = [None] * len(population.individuals)
        for i in range(len(population.individuals)):
            if self.random_generator.random() <= self.mutation_probability:
                selected[i] = True
                seeds[i] = new_random_seed(self.random_generator)
        return selected, seeds

    @staticmethod
    def _cleared_population(
        population: EVQEPopulation, individuals: Sequence[EVQEIndividual]
    ) -> EVQEPopulation:
        """Mutations invalidate species membership but keep representatives
        (reference: mutation.py:230-235)."""
        return EVQEPopulation(
            individuals=tuple(individuals),
            species_representatives=population.species_representatives,
            species_members=None,
            species_membership=None,
        )

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return None


class EVQELastLayerParameterSearch(BaseEVQEMutationOperator):
    """Optimize only the last layer's parameters of selected individuals
    (reference: mutation.py:244-290; runs with probability 1 as the first
    pipeline stage, evqe.py:199-204)."""

    def apply_operator(self, population, operator_context):
        selected, seeds = self._draw_selection(population)
        individuals = list(population.individuals)
        if not selected.any():
            operator_context.circuit_evaluation_count_callback(0)
            return self._cleared_population(population, individuals)

        packed = PackedPopulation.pack(individuals, min_layers=operator_context.pack_min_layers)
        seed_mix = next((s for s in seeds if s is not None), 0)
        new_angles, energies, n_evals = _batched_layer_optimization(
            individuals, selected, [-1 if s else None for s in selected],
            self.optimizer, operator_context.circuit_evaluator, None, packed, seed_mix,
        )
        packed.angles = new_angles
        for i in range(len(individuals)):
            if selected[i]:
                individuals[i] = unpack_individual(packed, i, individuals[i])

        # on the exact estimator path the sweep's final values ARE the
        # population energies at the final angles — publish them so the
        # selection step that follows (after genome-preserving speciation)
        # can skip its evaluation dispatch
        cache = operator_context.energy_cache
        publishes = getattr(self.optimizer, "publishes_exact_energies", None)
        if (
            cache is not None
            and publishes is not None
            and publishes(operator_context.circuit_evaluator)
        ):
            cache.publish(individuals, energies)

        operator_context.circuit_evaluation_count_callback(n_evals)
        return self._cleared_population(population, individuals)

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        if self.optimizer_n_circuit_evaluations is not None:
            return ceil(
                self.mutation_probability
                * len(population.individuals)
                * self.optimizer_n_circuit_evaluations
            )
        return None


class EVQEParameterSearch(BaseEVQEMutationOperator):
    """Optimize all layers of selected individuals, one layer at a time in
    per-individual random order (reference: mutation.py:92-132, 293-334).

    Batched execution: slot s optimizes each selected individual's s-th
    layer of its own random order simultaneously; individuals with fewer
    layers sit out later slots.
    """

    def apply_operator(self, population, operator_context):
        selected, seeds = self._draw_selection(population)
        individuals = list(population.individuals)
        if not selected.any():
            operator_context.circuit_evaluation_count_callback(0)
            return self._cleared_population(population, individuals)

        # per-individual random layer orders, reproducing
        # optimize_all_parameters_of_individual's call order
        # (choice + remove + new_random_seed per layer, mutation.py:114-129)
        orders: list[list[int]] = []
        slot_seeds: list[list[int]] = []
        for i, individual in enumerate(individuals):
            if not selected[i]:
                orders.append([])
                slot_seeds.append([])
                continue
            randomizer = Random(seeds[i])
            remaining = list(range(len(individual.layers)))
            order: list[int] = []
            child_seeds: list[int] = []
            while remaining:
                layer = randomizer.choice(remaining)
                remaining.remove(layer)
                order.append(layer)
                child_seeds.append(new_random_seed(randomizer))
            orders.append(order)
            slot_seeds.append(child_seeds)

        packed = PackedPopulation.pack(individuals, min_layers=operator_context.pack_min_layers)
        angles = packed.angles
        total_evals = 0
        max_slots = max((len(o) for o in orders), default=0)

        fused = self._apply_fused_slots(
            individuals, selected, orders, slot_seeds, packed, angles,
            operator_context, max_slots,
        )
        if fused is not None:
            angles, total_evals = fused
        else:
            angles, total_evals = self._apply_slot_loop(
                individuals, selected, orders, slot_seeds, packed, angles,
                operator_context, max_slots,
            )

        packed.angles = angles
        for i in range(len(individuals)):
            if selected[i]:
                individuals[i] = unpack_individual(packed, i, individuals[i])

        operator_context.circuit_evaluation_count_callback(total_evals)
        return self._cleared_population(population, individuals)

    def _apply_fused_slots(
        self, individuals, selected, orders, slot_seeds, packed, angles,
        operator_context, max_slots,
    ):
        """One fused device program for all layer slots (optimizer
        permitting) — see BatchedNFT.minimize_slots.  Returns None to fall
        back to the sequential per-slot loop."""
        fused = getattr(self.optimizer, "minimize_slots", None)
        if fused is None or max_slots == 0:
            return None
        pop = len(individuals)
        k_max = 1
        for i in range(pop):
            for layer in orders[i]:
                k_max = max(k_max, packed.layer_param_coordinates(i, layer).shape[0])
        coords = np.zeros((pop, max_slots, k_max, 3), np.int32)
        n_free = np.zeros((pop, max_slots), np.int32)
        active = np.zeros((pop, max_slots), bool)
        # sitting a slot out = optimizing past the last layer: empty
        # suffix, so the fused scan's probes skip those individuals' work
        slot_layers = np.full((pop, max_slots), packed.max_layers, np.int32)
        seeds = np.zeros(max_slots, np.int64)
        for s in range(max_slots):
            seed_set = False
            for i in range(pop):
                if not (selected[i] and s < len(orders[i])):
                    continue
                c = packed.layer_param_coordinates(i, orders[i][s])
                coords[i, s, : c.shape[0]] = c
                n_free[i, s] = c.shape[0]
                active[i, s] = c.shape[0] > 0
                slot_layers[i, s] = orders[i][s]
                if not seed_set:
                    seeds[s] = slot_seeds[i][s]
                    seed_set = True
        result = fused(
            operator_context.circuit_evaluator, packed, coords, n_free, active,
            slot_layers, angles=angles, seeds=seeds,
        )
        if result is None:
            return None
        new_angles, _, nfev_each = result
        total = int(active.sum()) * int(nfev_each)
        return new_angles, total

    def _apply_slot_loop(
        self, individuals, selected, orders, slot_seeds, packed, angles,
        operator_context, max_slots,
    ):
        """Sequential per-slot optimization (one optimizer call per slot)."""
        total_evals = 0
        for s in range(max_slots):
            layer_choice: list[Optional[int]] = [
                orders[i][s] if selected[i] and s < len(orders[i]) else None
                for i in range(len(individuals))
            ]
            slot_selected = np.array([c is not None for c in layer_choice])
            seed_mix = next(
                (slot_seeds[i][s] for i in range(len(individuals)) if slot_selected[i]), 0
            )
            angles, _, n_evals = _batched_layer_optimization(
                individuals, slot_selected, layer_choice,
                self.optimizer, operator_context.circuit_evaluator, angles, packed, seed_mix,
            )
            total_evals += n_evals
        return angles, total_evals

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        if self.optimizer_n_circuit_evaluations is not None:
            sum_layers = sum(len(ind.layers) for ind in population.individuals)
            return ceil(self.mutation_probability * sum_layers * self.optimizer_n_circuit_evaluations)
        return None


class EVQETopologicalSearch(BaseEVQEMutationOperator):
    """Append one random layer (parameters at 0) to selected individuals
    (reference: mutation.py:337-368)."""

    def __init__(self, mutation_probability: float, random_seed: Optional[int] = None):
        super().__init__(mutation_probability, None, None, random_seed)

    def apply_operator(self, population, operator_context):
        selected, seeds = self._draw_selection(population)
        individuals = list(population.individuals)
        for i in range(len(individuals)):
            if selected[i]:
                individuals[i] = EVQEIndividual.add_random_layers(
                    individual=individuals[i],
                    n_layers=1,
                    randomize_parameter_values=False,
                    random_seed=seeds[i],
                )
        operator_context.circuit_evaluation_count_callback(0)
        return self._cleared_population(population, individuals)

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return 0


def remove_random_layers_from_individual(
    individual: EVQEIndividual, random_seed: Optional[int]
) -> EVQEIndividual:
    """Remove a random count (1..L-1) of trailing layers; single-layer
    individuals pass through (reference: mutation.py:135-152)."""
    if len(individual.layers) == 1:
        return individual
    rng = Random(random_seed)
    n_layers_to_remove = rng.randrange(1, len(individual.layers))
    return EVQEIndividual.remove_layers(individual=individual, n_layers=n_layers_to_remove)


class EVQELayerRemoval(BaseEVQEMutationOperator):
    """Remove random trailing layers from selected individuals
    (reference: mutation.py:371-399)."""

    def __init__(self, mutation_probability: float, random_seed: Optional[int] = None):
        super().__init__(mutation_probability, None, None, random_seed)

    def apply_operator(self, population, operator_context):
        selected, seeds = self._draw_selection(population)
        individuals = list(population.individuals)
        for i in range(len(individuals)):
            if selected[i]:
                individuals[i] = remove_random_layers_from_individual(individuals[i], seeds[i])
        operator_context.circuit_evaluation_count_callback(0)
        return self._cleared_population(population, individuals)

    def get_n_expected_circuit_evaluations(self, population, operator_context):
        return 0
