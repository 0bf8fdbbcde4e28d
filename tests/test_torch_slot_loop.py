"""The port's per-slot parameter-search loop and the knobs that choose it,
against the JAX package (CPU).

(1) ``EVQEParameterSearch`` with the prefix cache off runs one
``_batched_layer_optimization`` per slot, on both sides: a 6-qubit
population of 6 against a diagonal table (three-point NFT) and a 6-qubit
TFIM (five-point NFT).  The searched populations are compared as energies
through each side's evaluator, to 1e-5 * max|table| (diagonal) and
1e-4 * sum|c| (general); the evaluation counts are equal.

(2) ``cache_prefix`` and ``in_kernel_sweep`` resolve as the JAX package's
``prefix_enabled`` and ``_in_kernel_sweep_applies`` on its production
route (evaluators built with ``use_pallas=True``, the Pallas size check
passing as on the TPU), for every operand kind.

(3) An exact-estimator TFIM solve, where the parameter search has no fused
route and takes the loop by default: generation 1's energies against the
JAX solve to 1e-5 * sum|c|; and every generation replayed through the
port's host modules with the JAX numerics, equal to the JAX solve.
"""

from __future__ import annotations

import numpy as np
import pytest

import queasars_tpu.sim.pallas_kernels as jax_pallas_kernels
from queasars_tpu.evolve import EVQEParameterSearch as JaxParameterSearch
from queasars_tpu.evolve.base import OperatorContext as JaxContext
from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.optim.prefix import prefix_enabled as jax_prefix_enabled
from queasars_tpu.problems.spin_chains import transverse_field_ising as jax_tfim
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.sim.evaluators import StatevectorExpectationEvaluator as JaxEvaluator
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu_torch.evolve import EVQEParameterSearch
from queasars_tpu_torch.evolve.base import OperatorContext
from queasars_tpu_torch.genome import EVQEPopulation
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.optim.objective import objective_operands
from queasars_tpu_torch.optim.prefix import prefix_enabled
from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
from queasars_tpu_torch.sim.evaluators import (
    SamplerExpectationEvaluator,
    StatevectorExpectationEvaluator,
)
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from tests.test_torch_optim import _operators
from tests.test_torch_solver import SETTINGS, _structures

N = 6
TFIM = dict(coupling=1.0, field=0.9)


def _search(module_search, module_context, optimizer, evaluator, population):
    counts = []
    context = module_context(
        circuit_evaluator=evaluator, result_callback=lambda _: None,
        circuit_evaluation_count_callback=counts.append, pack_min_layers=4,
    )
    out = module_search(1.0, optimizer, None, random_seed=5).apply_operator(population, context)
    return evaluator.evaluate_individuals(list(out.individuals)), counts


def _populations(seed=3):
    """Equal seeded populations of 6 individuals with 1-3 layers."""
    return (
        EVQEPopulation.random_population(N, 3, 6, True, random_seed=seed),
        JaxPopulation.random_population(N, 3, 6, True, random_seed=seed),
    )


@pytest.mark.parametrize("kind", ["diagonal", "tfim"])
def test_slot_loop_matches_jax(kind):
    if kind == "diagonal":
        op, op_ref = _operators(N, seed=4, terms=10)
        config = dict(maxiter=6, reset_interval=4)
        tol = 1e-5 * float(np.abs(np.asarray(JaxEvaluator(op_ref)._table)).max())
    else:
        op, op_ref = transverse_field_ising(N, **TFIM), jax_tfim(N, **TFIM)
        config = dict(maxiter=4, reset_interval=3, five_point=True)
        tol = 1e-4 * float(np.abs(op_ref.coeffs).sum())
    ours, theirs = _populations()
    got, got_counts = _search(
        EVQEParameterSearch, OperatorContext, BatchedNFT(NFTConfig(cache_prefix=False, **config)),
        StatevectorExpectationEvaluator(op, device="cpu"), ours,
    )
    want, want_counts = _search(
        JaxParameterSearch, JaxContext, JaxNFT(JaxNFTConfig(cache_prefix=False, **config)),
        JaxEvaluator(op_ref), theirs,
    )
    assert got_counts == want_counts and got_counts[0] > 0
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _operand_kinds():
    """(name, port evaluator, JAX evaluator) for every operand kind."""
    diag, diag_ref = _operators(N, seed=1)
    tfim, tfim_ref = transverse_field_ising(N, **TFIM), jax_tfim(N, **TFIM)
    return [
        ("exact", StatevectorExpectationEvaluator(diag, device="cpu"),
         JaxEvaluator(diag_ref, use_pallas=True)),
        ("exact cvar", StatevectorExpectationEvaluator(diag, alpha=0.5, device="cpu"),
         JaxEvaluator(diag_ref, alpha=0.5, use_pallas=True)),
        ("exact precision", StatevectorExpectationEvaluator(diag, precision=0.1, device="cpu"),
         JaxEvaluator(diag_ref, precision=0.1, use_pallas=True)),
        ("exact general", StatevectorExpectationEvaluator(tfim, device="cpu"),
         JaxEvaluator(tfim_ref, use_pallas=True)),
        ("sampler", SamplerExpectationEvaluator(diag, shots=16, device="cpu"),
         JaxSampler(diag_ref, shots=16, use_pallas=True)),
        ("sampler cvar", SamplerExpectationEvaluator(diag, shots=16, alpha=0.5, device="cpu"),
         JaxSampler(diag_ref, shots=16, alpha=0.5, use_pallas=True)),
        ("sampler general", SamplerExpectationEvaluator(tfim, shots=16, device="cpu"),
         JaxSampler(tfim_ref, shots=16, use_pallas=True)),
    ]


def test_knobs_resolve_as_jax_on_every_operand_kind(monkeypatch):
    from queasars_tpu.optim.objective import objective_operands as jax_operands

    monkeypatch.setattr(jax_pallas_kernels, "pallas_supported", lambda n, platform: True)
    last = np.zeros(3, np.int32)
    flags = (None, True, False)
    for name, evaluator, reference in _operand_kinds():
        ours, theirs = objective_operands(evaluator), jax_operands(reference)
        for cache in flags:
            for last_layer in (None, last):
                for mesh in (None, "a mesh"):
                    assert prefix_enabled(cache, ours, mesh, last_layer) == jax_prefix_enabled(
                        cache, theirs, mesh, last_layer), (name, cache, last_layer, mesh)
        for sweep in flags:
            for five_point in (False, True):
                port = BatchedNFT(NFTConfig(in_kernel_sweep=sweep, five_point=five_point))
                ref = JaxNFT(JaxNFTConfig(in_kernel_sweep=sweep, five_point=five_point))
                assert port._in_kernel_sweep_applies(ours) == ref._in_kernel_sweep_applies(
                    theirs, N, backend="cpu"), (name, sweep, five_point)


ESTIMATOR = {
    **{k: v for k, v in SETTINGS.items() if k != "configured_sampler"},
    "configured_sampler": None, "parameter_search_probability": 1.0, "population_size": 5,
}
NFT = dict(maxiter=3, reset_interval=2, five_point=True)


class JaxNumbers(JaxEvaluator):
    """The JAX package's evaluator with the two members the port's driver
    reads."""

    device = "cpu"

    def initial_states(self, pop):
        return None


def _port_solver(optimizer):
    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(), optimizer=optimizer, device="cpu", **ESTIMATOR))


def _jax_solver(optimizer):
    return JaxSolver(JaxConfig(configured_estimator=JaxEstimator(), optimizer=optimizer,
                               **ESTIMATOR))


def test_exact_tfim_solve_matches_jax_in_generation_one():
    n = 5
    ours = _port_solver(BatchedNFT(NFTConfig(**NFT))).compute_minimum_eigenvalue(
        transverse_field_ising(n, **TFIM))
    op_ref = jax_tfim(n, **TFIM)
    ref = _jax_solver(JaxNFT(JaxNFTConfig(**NFT))).compute_minimum_eigenvalue(op_ref)
    assert ours.generations == ref.generations == 2
    assert _structures(ours)[0] == _structures(ref)[0]
    assert ours.circuit_evaluations[0] == ref.circuit_evaluations[0]
    np.testing.assert_allclose(
        ours.population_evaluation_results[0].expectation_values,
        ref.population_evaluation_results[0].expectation_values,
        atol=1e-5 * float(np.abs(op_ref.coeffs).sum()), rtol=0,
    )
    assert ours.eigenvalue < 0


def test_exact_tfim_solve_host_call_order_with_the_jax_numerics():
    n = 5
    op_ref = jax_tfim(n, **TFIM)
    optimizer = JaxNFT(JaxNFTConfig(**NFT))
    ref = _jax_solver(optimizer).compute_minimum_eigenvalue(op_ref)
    replay = _port_solver(optimizer)._solve_by_evolution(JaxNumbers(op_ref), None)
    assert _structures(replay) == _structures(ref)
    assert replay.circuit_evaluations == ref.circuit_evaluations
    for got, want in zip(replay.population_evaluation_results, ref.population_evaluation_results):
        np.testing.assert_array_equal(got.expectation_values, want.expectation_values)
    assert replay.eigenvalue == ref.eigenvalue
