"""The slice as a whole: the port's EVQE solve on its kron-fold route
against the JAX package's solve (``use_pallas=True``, ``QUEASARS_MXU=0``,
as tests/test_torch_solver.py runs it).

On the CPU the port's fold route is forced by patching its own predicate
(``fold_kernels.fold_supported``, which otherwise requires tensors on a
CUDA device); the fold wrappers then run their plain versions, and their
calls are counted to show the route was taken.  Nothing in the JAX package
changes.  The fold transform is exact, so the solves agree as the slot
route's does: identical genome structure in every generation, energies
within 1e-4 * max|table| (ulp-level rounding differences inside each NFT
step compound over a solve).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from queasars_tpu.optim import BatchedNFT as JaxNFT
from queasars_tpu.optim import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.problems.jssp import JSSPDomainWallHamiltonianEncoder as JaxEncoder
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu.solver import ConfiguredEstimator as JaxEstimator
from queasars_tpu.solver import EVQEMinimumEigensolver as JaxSolver
from queasars_tpu.solver import EVQEMinimumEigensolverConfiguration as JaxConfig
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance
from queasars_tpu_torch.sim import fold_kernels, fold_pipeline
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from tests.test_torch_solver import SETTINGS, _structures


def test_fold_route_solve_matches_jax(monkeypatch):
    calls = Counter()
    monkeypatch.setattr(
        fold_kernels, "fold_supported",
        lambda n, device, path="exact": fold_pipeline.LANE_BITS <= n <= fold_kernels._CAPS[path],
    )
    for name in ("energies_exact_folded", "population_states_folded", "nft_layer_sweep_folded"):
        def counted(*args, _inner=getattr(fold_kernels, name), _name=name):
            calls[_name] += 1
            return _inner(*args)

        monkeypatch.setattr(fold_kernels, name, counted)

    instance = dict(
        instance_name="t7", n_jobs=2, n_machines=2, relative_op_amount=0.5,
        op_duration={1: 0.5, 2: 0.5}, random_seed=0,
    )
    h = JSSPDomainWallHamiltonianEncoder(
        random_job_shop_scheduling_instance(**instance), makespan_limit=5
    ).get_problem_hamiltonian()
    assert h.n_qubits == 7
    monkeypatch.delenv("QUEASARS_MXU", raising=False)
    ours = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        optimizer=BatchedNFT(NFTConfig(maxiter=4)), device="cpu", **SETTINGS,
    )).compute_minimum_eigenvalue(h)
    assert calls["energies_exact_folded"] > 0 and calls["nft_layer_sweep_folded"] > 0
    assert calls["population_states_folded"] == calls["nft_layer_sweep_folded"]

    monkeypatch.setenv("QUEASARS_MXU", "0")
    h_ref = JaxEncoder(jax_random_instance(**instance), makespan_limit=5).get_problem_hamiltonian()
    ref = JaxSolver(JaxConfig(
        configured_estimator=JaxEstimator(),
        optimizer=JaxNFT(JaxNFTConfig(maxiter=4)), use_pallas=True, **SETTINGS,
    )).compute_minimum_eigenvalue(h_ref)

    assert _structures(ours) == _structures(ref)
    assert ours.circuit_evaluations == ref.circuit_evaluations
    tol = 1e-4 * np.abs(jax_table(h_ref)).max()
    for got, want in zip(ours.population_evaluation_results, ref.population_evaluation_results):
        np.testing.assert_allclose(got.expectation_values, want.expectation_values, atol=tol)
    np.testing.assert_allclose(ours.eigenvalue, ref.eigenvalue, atol=tol)
    assert max(ours.eigenstate, key=ours.eigenstate.get) == max(ref.eigenstate,
                                                                key=ref.eigenstate.get)
