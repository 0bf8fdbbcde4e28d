"""The port's Pauli algebra, JSSP encoder and energy tables against the
JAX package's: Hamiltonian terms exactly, energy tables to 1e-6 relative
(float64 sums taken in another order), decoded schedules exactly."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.paulis import diagonal_energy_table as jax_table
from queasars_tpu.problems.jssp import JSSPDomainWallHamiltonianEncoder as JaxEncoder
from queasars_tpu.problems.jssp.random_instances import (
    random_job_shop_scheduling_instance as jax_random_instance,
)
from queasars_tpu_torch.paulis import PauliSum, diagonal_energy_table
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance


def _both(seed, n_jobs, n_machines, makespan_limit, op_duration):
    kwargs = dict(
        instance_name=f"t-{seed}", n_jobs=n_jobs, n_machines=n_machines,
        relative_op_amount=0.5, op_duration=op_duration, random_seed=seed,
    )
    ours = JSSPDomainWallHamiltonianEncoder(
        random_job_shop_scheduling_instance(**kwargs), makespan_limit=makespan_limit
    )
    ref = JaxEncoder(jax_random_instance(**kwargs), makespan_limit=makespan_limit)
    return ours, ref


@pytest.mark.parametrize(
    "seed,n_jobs,n_machines,makespan_limit,op_duration",
    [(0, 2, 2, 4, 1), (3, 2, 3, 4, 1), (1, 3, 2, 4, {1: 0.5, 2: 0.5})],
)
def test_encoder_hamiltonian_and_table_match_jax(seed, n_jobs, n_machines, makespan_limit, op_duration):
    ours, ref = _both(seed, n_jobs, n_machines, makespan_limit, op_duration)
    h, h_ref = ours.get_problem_hamiltonian(), ref.get_problem_hamiltonian()
    assert h.n_qubits == h_ref.n_qubits
    np.testing.assert_array_equal(h.coeffs, h_ref.coeffs)
    np.testing.assert_array_equal(h.z, h_ref.z)
    np.testing.assert_array_equal(h.x, h_ref.x)
    table = diagonal_energy_table(h).numpy()
    want = jax_table(h_ref)
    np.testing.assert_allclose(table, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # every basis state decodes to the same schedule
    for state in range(0, 1 << h.n_qubits, max(1, (1 << h.n_qubits) // 64)):
        a, b = ours.translate_result_state(state), ref.translate_result_state(state)
        assert a.is_valid == b.is_valid and a.makespan == b.makespan
        assert repr(a) == repr(b)


def test_energy_table_of_a_random_diagonal_sum_matches_jax():
    rng = np.random.default_rng(1)
    n = 9
    labels = ["".join(rng.choice(["I", "Z"], size=n)) for _ in range(30)]
    coeffs = rng.normal(size=30)
    ours = PauliSum.sum([PauliSum.from_label(l, float(c)) for l, c in zip(labels, coeffs)])
    ref = JaxPauliSum.sum([JaxPauliSum.from_label(l, float(c)) for l, c in zip(labels, coeffs)])
    want = jax_table(ref)
    got = diagonal_energy_table(ours, dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert diagonal_energy_table(ours, dtype=torch.float32).dtype == torch.float32
