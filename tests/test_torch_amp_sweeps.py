"""The amplitude-sharded fold route and device NFT sweeps of the port
(``queasars_tpu_torch/sim/sharded_fold.py``, the sweeps of
``sim/sharded_evaluator.py``) against the JAX package's, after its
``tests/test_sharded_fold.py``, with the port's cells on ``["cpu"] * 8``.

- Folded energies equal the JAX package's ``make_folded_population_energies_fn``
  to 5e-5 at n = 10 and 12, from |0...0> and from a start state, and are
  bit-identical across factorizations; the fold boundary and its checks
  are the JAX package's.
- ``BatchedNFT.minimize`` hands the sweep to the evaluator: the plain
  sweep, the rest-base prefix sweep (``last_layer``) and
  ``minimize_slots``' fused slot sweep end at the JAX package's energies
  to 1e-5 * sum|c| on the fold route (NFT results are compared as
  energies), the per-gate route within 1e-3 * sum|c| of the fold route,
  each bit-identical on 1x2 and 2x1;
  a CVaR evaluator has no device sweep, so the host-stepped loop runs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.optim.nft import BatchedNFT as JaxNFT
from queasars_tpu.optim.nft import NFTConfig as JaxNFTConfig
from queasars_tpu.paulis import PauliSum as JaxPauliSum
from queasars_tpu.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator as JaxEval
from queasars_tpu.sim.sharded_evaluator import pop_amp_mesh as jax_pop_amp_mesh
from queasars_tpu.sim.sharded_fold import make_folded_population_energies_fn
from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.parallel.amplitude import pop_amp_mesh
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator
from queasars_tpu_torch.sim.sharded_fold import (
    check_folded_bits,
    default_folded_bits,
    folded_population_energies,
)
from queasars_tpu_torch.sim.sharded_statevector import build_device_table

CELLS = ["cpu"] * 8

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's many small torch operations on one thread: under
    the suite's parallel workers, torch's intra-op pool on every worker
    oversubscribes the cores and multiplies these tests' time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _packed(n, layers, pop, seed):
    ours = EVQEPopulation.random_population(n, layers, pop, True, random_seed=seed)
    theirs = JaxPopulation.random_population(n, layers, pop, True, random_seed=seed)
    return (PackedPopulation.pack(list(ours.individuals)),
            JaxPacked.pack(list(theirs.individuals)))


def _operator(cls, n, k=12, seed=1):
    rng = np.random.default_rng(seed)
    return cls(n_qubits=n, coeffs=rng.normal(size=k).astype(np.complex128),
               z=rng.integers(0, 1 << n, size=(k, 1)).astype(np.uint64),
               x=np.zeros((k, 1), np.uint64))


def _folded_energies(mesh, packed, operator, n, initial=None):
    table = build_device_table(mesh, operator.coeffs.real, operator.z[:, 0], n)
    return folded_population_energies(
        mesh, n, packed.gate_types, packed.controls, packed.angles, packed.layer_mask, table,
        initial=initial).numpy()


@pytest.mark.parametrize("n_qubits", [10, 12])
def test_folded_energies_match_jax_across_factorizations(n_qubits):
    ours, theirs = _packed(n_qubits, 3, 6, 5)
    operator, operator_ref = _operator(PauliSum, n_qubits), _operator(JaxPauliSum, n_qubits)
    table_ref = np.asarray(JaxEval(operator_ref, jax_pop_amp_mesh(2, 4))._table)
    padded = [np.pad(a, [(0, 2)] + [(0, 0)] * (a.ndim - 1))
              for a in (theirs.gate_types, theirs.controls, theirs.angles, theirs.layer_mask)]
    fn = make_folded_population_energies_fn(jax_pop_amp_mesh(2, 4), n_qubits)
    want = np.asarray(fn(*padded, jnp.asarray(table_ref)))[:6]
    results = [_folded_energies(pop_amp_mesh(p, a, devices=CELLS), ours, operator, n_qubits)
               for p, a in [(1, 8), (8, 1)]]
    np.testing.assert_allclose(results[0], want, atol=5e-5)
    for other in results[1:]:
        np.testing.assert_array_equal(other, results[0])


def test_folded_energies_with_a_start_state():
    n = 10
    ours, theirs = _packed(n, 2, 8, 7)
    operator, operator_ref = _operator(PauliSum, n), _operator(JaxPauliSum, n)
    rng = np.random.default_rng(3)
    raw = rng.normal(size=(2, 1 << n)).astype(np.float32)
    raw /= np.sqrt((raw ** 2).sum())
    table_ref = np.asarray(JaxEval(operator_ref, jax_pop_amp_mesh(2, 4))._table)
    fn = make_folded_population_energies_fn(jax_pop_amp_mesh(2, 4), n, with_initial=True)
    want = np.asarray(fn(theirs.gate_types, theirs.controls, theirs.angles, theirs.layer_mask,
                         jnp.asarray(table_ref), jnp.asarray(raw)))
    results = [_folded_energies(pop_amp_mesh(p, a, devices=CELLS), ours, operator, n, raw)
               for p, a in [(8, 1), (2, 4)]]
    np.testing.assert_allclose(results[0], want, atol=5e-5)
    np.testing.assert_array_equal(results[0], results[1])


def test_default_folded_bits_and_validation():
    assert [default_folded_bits(n) for n in (10, 12, 17, 22)] == [7, 9, 14, 14]
    with pytest.raises(ValueError, match="exceeds"):
        check_folded_bits(7, 9)
    with pytest.raises(ValueError, match="lane"):
        check_folded_bits(7, 5)
    check_folded_bits(7, 7)


def _coords(packed, last_layer=None):
    rows = []
    for i in range(packed.n_individuals):
        c = packed.param_coordinates(i)
        if last_layer is not None:
            c = c[c[:, 0] == last_layer[i]]
        rows.append(c)
    width = max(len(c) for c in rows)
    coords = np.stack([np.pad(c, ((0, width - len(c)), (0, 0))) for c in rows])
    return coords, np.asarray([len(c) for c in rows], np.int32)


def _sweep(cls_eval, nft, config, operator, mesh, packed, kind, use_fold):
    evaluator = cls_eval(operator, mesh, use_fold=use_fold)
    active = np.ones(packed.n_individuals, bool)
    if kind == "slots":
        ll = packed.layer_mask.sum(axis=1).astype(np.int64) - 1
        coords, n_free = _coords(packed, ll)
        slot_layers = np.stack([np.zeros_like(ll), ll], axis=1)
        coords = np.stack([coords, coords], axis=1)
        n_free = np.stack([n_free, n_free], axis=1)
        out = nft(config).minimize_slots(evaluator, packed, coords, n_free,
                                         np.stack([active, active], axis=1), slot_layers)
        return np.asarray(out[0]), np.asarray(out[1])
    if kind == "prefix":
        ll = packed.layer_mask.sum(axis=1).astype(np.int64) - 1
        coords, n_free = _coords(packed, ll)
        out = nft(config).minimize(evaluator, packed, coords, n_free, active, seed=0,
                                   last_layer=ll)
    else:
        coords, n_free = _coords(packed)
        out = nft(config).minimize(evaluator, packed, coords, n_free, active, seed=0)
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("kind", ["plain", "prefix", "slots"])
def test_device_sweeps_match_jax_and_every_factorization(kind):
    """The fold route (the default) against the JAX package's sweep on
    2x4, and the per-gate route against the fold route (1e-3 * sum|c|, the
    JAX package's bar between its routes); each bit-identical on 1x2 and
    2x1."""
    n = 10
    ours, theirs = _packed(n, 3, 5, 12)
    operator, operator_ref = _operator(PauliSum, n), _operator(JaxPauliSum, n)
    cache = kind != "plain"
    _, want = _sweep(JaxEval, JaxNFT, JaxNFTConfig(maxiter=4, cache_prefix=cache), operator_ref,
                     jax_pop_amp_mesh(2, 4), theirs, kind, True)
    config = NFTConfig(maxiter=4, cache_prefix=cache)
    scale = float(np.abs(operator.coeffs).sum())
    routes = {}
    for use_fold in (True, False):
        runs = [_sweep(AmplitudeShardedExpectationEvaluator, BatchedNFT, config, operator,
                       pop_amp_mesh(p, a, devices=["cpu"] * 2), ours, kind, use_fold)
                for p, a in [(1, 2), (2, 1)]]
        np.testing.assert_array_equal(runs[0][0], runs[1][0])
        np.testing.assert_array_equal(runs[0][1], runs[1][1])
        routes[use_fold] = runs[0][1]
    np.testing.assert_allclose(routes[True], want, atol=1e-5 * scale)
    np.testing.assert_allclose(routes[False], routes[True], atol=1e-3 * scale)


def test_cvar_has_no_device_sweep():
    n = 8
    ours, _ = _packed(n, 2, 4, 1)
    evaluator = AmplitudeShardedExpectationEvaluator(_operator(PauliSum, n),
                                                     pop_amp_mesh(2, 4, devices=CELLS),
                                                     alpha=0.5)
    coords, n_free = _coords(ours)
    active = np.ones(ours.n_individuals, bool)
    assert evaluator.nft_minimize(ours, coords, n_free, active, ours.angles,
                                  NFTConfig(maxiter=2), 0) is None
    angles, energies, _ = BatchedNFT(NFTConfig(maxiter=2)).minimize(
        evaluator, ours, coords, n_free, active)
    assert angles.shape == ours.angles.shape and np.all(np.isfinite(energies))
    assert not BatchedNFT().publishes_exact_energies(evaluator)
