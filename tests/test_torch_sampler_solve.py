"""The sampler path end to end: a seeded sampler solve of the port against the JAX
package's, on the 8-qubit 2x2 JSSP instance of the repository's config 1
(``jssp_with_qubits(2, 2, 4, 8, rel=1.0)``) with config 3's evaluation:
512 shots, CVaR 0.5, tournament selection of size 2; population 6, two
generations.

(1) The port alone against the JAX package alone: the genome structure of
generation 1 is identical, its population energies agree to
1e-5 * max|table| (equal shots from equal keys; ulp-level probability
differences may flip a boundary draw, see
tests/test_torch_sampler_evaluator.py -- none does here), and the final
distribution's counts sum to the shots.  Later generations are not
required to match: boundary flips inside NFT steps may steer them apart.

(2) The host call order over every generation: the port's driver and
operators replayed with the JAX package's sampler evaluator and optimizer
doing the numbers give the JAX solver's structures and energies.

(3) The 0x5EED final-distribution counts: on equal probabilities the
port's sampled counts equal the JAX package's exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.problems.jssp import JSSPDomainWallHamiltonianEncoder as JaxEncoder
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu.sim.evaluators import SamplerExpectationEvaluator as JaxSampler
from queasars_tpu.sim.sampling import sample_counts as jax_sample_counts
from queasars_tpu.sim.statevector import probabilities as jax_probabilities
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.solver import ConfiguredSampler as JaxConfiguredSampler
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance
from queasars_tpu_torch.sim.sampling import sample_counts
from queasars_tpu_torch.solver import (
    ConfiguredSampler,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.utils import prng
from tests.test_torch_solver import SETTINGS, _structures

SAMPLER = {
    **{k: v for k, v in SETTINGS.items() if k != "configured_sampler"},
    "configured_estimator": None, "distribution_alpha_tail": 0.5,
    "use_tournament_selection": True, "tournament_size": 2,
}


def _config1_instance():
    """The first seeded random 2x2 JSSP instance at 8 qubits, in both
    packages (experiments/exp_baseline_configs.py:48-58, config 1)."""
    for seed in range(200):
        kwargs = dict(instance_name=f"bl-{seed}", n_jobs=2, n_machines=2,
                      relative_op_amount=1.0, op_duration=1, random_seed=seed)
        h = JSSPDomainWallHamiltonianEncoder(
            random_job_shop_scheduling_instance(**kwargs), makespan_limit=4
        ).get_problem_hamiltonian()
        if h.n_qubits == 8:
            h_ref = JaxEncoder(jax_random_instance(**kwargs), makespan_limit=4).get_problem_hamiltonian()
            return h, h_ref
    raise AssertionError("no 8-qubit instance")


def _jax_solver(optimizer):
    return JaxSolver(JaxConfig(
        configured_sampler=JaxConfiguredSampler(shots=512, seed=0), optimizer=optimizer,
        use_pallas=True, **SAMPLER,
    ))


class JaxSamplerNumbers(JaxSampler):
    """The JAX package's sampler evaluator with the two members the port's
    driver reads."""

    device = "cpu"

    def initial_states(self, pop):
        return None


def test_sampler_solve_matches_jax_in_generation_one(monkeypatch):
    monkeypatch.setenv("QUEASARS_MXU", "0")
    h, h_ref = _config1_instance()
    ours = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_sampler=ConfiguredSampler(shots=512, seed=0),
        optimizer=BatchedNFT(NFTConfig(maxiter=4)), device="cpu", **SAMPLER,
    )).compute_minimum_eigenvalue(h)
    ref = _jax_solver(JaxNFT(JaxNFTConfig(maxiter=4))).compute_minimum_eigenvalue(h_ref)
    assert ours.generations == ref.generations == 2
    assert _structures(ours)[0] == _structures(ref)[0]
    tol = 1e-5 * np.abs(np.asarray(jax_table(h_ref))).max()
    np.testing.assert_allclose(
        ours.population_evaluation_results[0].expectation_values,
        ref.population_evaluation_results[0].expectation_values, atol=tol, rtol=0,
    )
    for result in (ours, ref):
        counts = np.array(list(result.eigenstate.values())) * 512
        np.testing.assert_allclose(counts, np.round(counts), atol=1e-6)
        assert round(counts.sum()) == 512


def test_host_call_order_with_the_jax_numerics():
    """Every generation's structures and energies of the JAX solver, from
    the port's driver and operators with the JAX numerics."""
    h, h_ref = _config1_instance()
    optimizer = JaxNFT(JaxNFTConfig(maxiter=4, cache_prefix=True))
    ref = _jax_solver(optimizer).compute_minimum_eigenvalue(h_ref)
    solver = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_sampler=ConfiguredSampler(shots=512, seed=0), optimizer=optimizer,
        device="cpu", **SAMPLER,
    ))
    replay = solver._solve_by_evolution(JaxSamplerNumbers(h_ref, shots=512, alpha=0.5, seed=0), None)
    assert _structures(replay) == _structures(ref)
    assert replay.circuit_evaluations == ref.circuit_evaluations
    for got, want in zip(replay.population_evaluation_results, ref.population_evaluation_results):
        np.testing.assert_array_equal(got.expectation_values, want.expectation_values)
    assert replay.eigenvalue == ref.eigenvalue


def test_final_distribution_counts_match_jax_on_equal_probabilities():
    h, h_ref = _config1_instance()
    ref = _jax_solver(JaxNFT(JaxNFTConfig(maxiter=4))).compute_minimum_eigenvalue(h_ref)
    packed = JaxPacked.pack([ref.best_individual])
    probs = np.asarray(jax_probabilities(
        packed.gate_types, packed.controls, packed.angles, packed.layer_mask, packed.n_qubits
    ))[0]
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0x5EED)
    want = np.asarray(jax_sample_counts(key, jnp.asarray(probs), 512))
    import torch

    got = sample_counts(prng.fold_in(prng.PRNGKey(0), 0x5EED), torch.tensor(probs), 512)
    np.testing.assert_array_equal(got.numpy(), want)
    assert {i: c / 512 for i, c in enumerate(want) if c} == ref.eigenstate
