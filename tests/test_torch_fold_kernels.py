"""Plain versions of the port's fold kernels against the JAX package's
folded Pallas kernels, run in interpret mode at ``precision="highest"`` on
the CPU as tests/test_fold_kernels.py runs them, on one pipeline (built by
the JAX package, absorbed phases on, carried over with ``interop``).

Tolerances are the JAX tests': probabilities and states to 5e-6,
energies ``atol=1e-4, rtol=1e-5`` on a random table.  Also the route
predicates (``fold_supported``, ``mxu_fold_enabled``) and the sweep
metadata, which must agree exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from queasars_tpu.sim.fold_pipeline import build_fold_pipeline as jax_build
from queasars_tpu.sim.pallas_fold_kernels import fold_sweep_metadata as jax_metadata
from queasars_tpu.sim.pallas_fold_kernels import (
    pallas_energies_exact_folded,
    pallas_population_probs_folded,
    pallas_population_states_folded,
)
from queasars_tpu_torch.interop import fold_pipeline_from_numpy
from queasars_tpu_torch.optim.objective import mxu_fold_enabled
from queasars_tpu_torch.optim.prefix import choose_prefix_engine
from queasars_tpu_torch.sim import fold_kernels as fk
from tests.test_torch_fold_pipeline import genome


def _pipelines(n_qubits, pop, seed):
    want = jax_build(*genome(n_qubits, 3, pop, seed), n_qubits, absorb_diag=True)
    return want, fold_pipeline_from_numpy(want)


def _initial(pop, n_qubits, seed):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(pop, 2, 1 << n_qubits)).astype(np.float32)
    return states / np.sqrt((states**2).sum(axis=(1, 2), keepdims=True))


def test_states_and_probs_plain_match_pallas():
    n_qubits = 10
    want_pipe, pipe = _pipelines(n_qubits, 3, seed=n_qubits)
    states = np.asarray(
        pallas_population_states_folded(want_pipe, n_qubits, precision="highest", interpret=True)
    )
    np.testing.assert_allclose(fk.population_states_folded(pipe, n_qubits).numpy(), states,
                               atol=5e-6)
    initial = _initial(3, n_qubits, seed=1)
    probs = np.asarray(pallas_population_probs_folded(
        want_pipe, n_qubits, precision="highest", interpret=True, initial=jnp.asarray(initial)
    ))
    got = fk.population_probs_folded(pipe, n_qubits, torch.from_numpy(initial))
    np.testing.assert_allclose(got.numpy(), probs, atol=5e-6)


@pytest.mark.parametrize("with_initial", [False, True])
def test_energies_plain_match_pallas(with_initial):
    n = 10
    want_pipe, pipe = _pipelines(n, 4, seed=2)
    table = np.random.default_rng(5).normal(size=1 << n).astype(np.float32)
    initial = _initial(4, n, seed=3) if with_initial else None
    want = np.asarray(pallas_energies_exact_folded(
        want_pipe, jnp.asarray(table), n, precision="highest", interpret=True,
        initial=None if initial is None else jnp.asarray(initial),
    ))
    got = fk.energies_exact_folded(
        pipe, torch.from_numpy(table), n, None if initial is None else torch.from_numpy(initial)
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_sweep_metadata_matches_jax_exactly():
    n = 16
    gt, ctrl, _, _ = genome(n, 2, 6, seed=23)
    for got, want in zip(fk.fold_sweep_metadata(gt[:, 1], ctrl[:, 1], n),
                         jax_metadata(gt[:, 1], ctrl[:, 1], n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fold_supported_ranges():
    for path, cap in (("exact", 22), ("sweep", 20)):
        assert [n for n in range(4, 25) if fk.fold_supported(n, "cuda", path)] == list(
            range(7, cap + 1))
        assert not any(fk.fold_supported(n, "cpu", path) for n in range(4, 25))
    with pytest.raises(ValueError):
        fk.fold_supported(10, "cuda", "sampler")


def test_mxu_fold_enabled_resolution(monkeypatch):
    monkeypatch.delenv("QUEASARS_MXU", raising=False)
    assert mxu_fold_enabled(None, 20, "sweep", device="cuda")
    assert not mxu_fold_enabled(None, 21, "sweep", device="cuda")
    assert mxu_fold_enabled(None, 21, device="cuda")
    assert not mxu_fold_enabled(None, 6, device="cuda")
    assert not mxu_fold_enabled(None, 20, device="cpu")
    assert not mxu_fold_enabled(True, 20, device="cpu")
    monkeypatch.setenv("QUEASARS_MXU", "0")
    assert not mxu_fold_enabled(None, 20, device="cuda")
    assert mxu_fold_enabled(True, 20, device="cuda")
    assert not mxu_fold_enabled(False, 20, device="cuda")
    monkeypatch.setenv("QUEASARS_MXU", "1")
    assert mxu_fold_enabled(None, 20, device="cuda")


def test_prefix_engine_choice(monkeypatch):
    monkeypatch.delenv("QUEASARS_MXU", raising=False)
    assert choose_prefix_engine(20, "cuda") == "slot"
    assert choose_prefix_engine(21, "cuda") == "fold"
    assert choose_prefix_engine(22, "cpu") == "slot"
    monkeypatch.setenv("QUEASARS_MXU", "0")
    assert choose_prefix_engine(22, "cuda") == "slot"


def test_fold_wrappers_refuse_mixed_devices():
    _, pipe = _pipelines(7, 2, seed=1)
    table = torch.zeros(1 << 7, device="meta")
    with pytest.raises(ValueError):
        fk.energies_exact_folded(pipe, table, 7)
