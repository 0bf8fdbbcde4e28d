"""The two sampled kernels' plain versions (what the port runs on the CPU,
and what the card's kernels are held against) against the JAX package's
Pallas samplers in interpret mode, at n=14 -- the smallest size the
in-kernel samplers take -- on the JAX package's own workload of
tests/test_in_kernel_sampler.py (P=3, 2 layers).

Both sides get the same threefry uniforms, so the sampled INDICES compare
draw for draw: at least 99.5% must be equal, the JAX package's bar for
two samplers of one stream (boundary draws may flip at the rounding level
of the running sums).  The Pallas kernels return ``table[index]``; with
``table = arange(2^n)`` (exact in float32 at n=14) that is the index.
Each interpret call (several seconds on a CPU) runs once per module.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.sim.fold_pipeline import build_fold_pipeline as jax_build_fold_pipeline
from queasars_tpu.sim.pallas_fold_kernels import pallas_sampled_shot_energies_folded
from queasars_tpu.sim.pallas_kernels import pallas_sampled_shot_energies
from queasars_tpu.sim.statevector import simulate_circuits as jax_simulate
from queasars_tpu_torch.interop import genome_tensors_from_numpy
from queasars_tpu_torch.sim import fold_kernels as fk
from queasars_tpu_torch.sim import slot_kernels as sk
from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.utils import prng

N = 14
POP = 3
BAR = 0.995


@pytest.fixture(scope="module")
def work():
    population = EVQEPopulation.random_population(N, 2, POP, True, random_seed=0)
    packed = JaxPacked.pack(list(population.individuals))
    genome = (packed.gate_types, packed.controls, packed.angles, packed.layer_mask)
    prefix_mask = packed.layer_mask.copy()
    prefix_mask[:, 1:] = False
    suffix_mask = packed.layer_mask.copy()
    suffix_mask[:, :1] = False
    prefix = np.asarray(jax_simulate(*genome[:3], prefix_mask, N))
    return dict(genome=genome, suffix_mask=suffix_mask, prefix=prefix, cache={})


def _uniforms(shots):
    keys = jax.random.split(jax.random.PRNGKey(7), POP)
    frac = np.stack([np.asarray(jax.random.uniform(k, (shots,), jnp.float32)) for k in keys])
    port = prng.uniform(prng.split(prng.PRNGKey(7), POP), (shots,))
    np.testing.assert_array_equal(port.numpy(), frac)
    return frac, port


def _jax_indices(work, kind, shots, with_prefix):
    """The Pallas kernel's sampled indices (interpret mode), cached."""
    key = (kind, shots, with_prefix)
    if key not in work["cache"]:
        gt, ctrl, ang, mask = work["genome"]
        if with_prefix:
            mask = work["suffix_mask"]
        initial = jnp.asarray(work["prefix"]) if with_prefix else None
        frac, _ = _uniforms(shots)
        table = np.arange(1 << N, dtype=np.float32)
        if kind == "slot":
            out = pallas_sampled_shot_energies(
                gt, ctrl, ang, mask, table, frac, N, shots, interpret=True, initial=initial
            )
        else:
            pipeline = jax_build_fold_pipeline(gt, ctrl, ang, mask, N, absorb_diag=True)
            out = pallas_sampled_shot_energies_folded(
                pipeline, table, frac, N, shots, interpret=True, initial=initial
            )
        work["cache"][key] = np.asarray(out).astype(np.int64)
    return work["cache"][key]


def _port_indices(work, kind, shots, with_prefix):
    gt, ctrl, ang, mask = work["genome"]
    if with_prefix:
        mask = work["suffix_mask"]
    tensors = genome_tensors_from_numpy(gt, ctrl, ang, mask)
    initial = torch.tensor(work["prefix"]) if with_prefix else None
    _, frac = _uniforms(shots)
    if kind == "slot":
        out = sk.sampled_shot_indices(*tensors, frac, N, initial)
    else:
        pipeline = build_fold_pipeline(*tensors, N, absorb_diag=True)
        out = fk.sampled_shot_indices_folded(pipeline, frac, N, initial)
    assert out.dtype == torch.int32 and tuple(out.shape) == (POP, shots)
    return out.numpy().astype(np.int64)


@pytest.mark.parametrize(
    "kind, shots, with_prefix",
    [("slot", 512, False), ("slot", 300, False), ("slot", 512, True),
     ("fold", 512, False), ("fold", 300, True)],
)
def test_plain_sampler_matches_pallas_interpret(work, kind, shots, with_prefix):
    got = _port_indices(work, kind, shots, with_prefix)
    assert (got == _jax_indices(work, kind, shots, with_prefix)).mean() >= BAR


def test_plain_versions_are_what_the_wrappers_run_on_the_cpu(work):
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*work["genome"])
    _, frac = _uniforms(64)
    sk.reset_launch_counts()
    fk.reset_launch_counts()
    np.testing.assert_array_equal(
        sk.sampled_shot_indices(gt, ctrl, ang, mask, frac, N),
        sk.sampled_shot_indices_plain(gt, ctrl, ang, mask, frac, N),
    )
    pipeline = build_fold_pipeline(gt, ctrl, ang, mask, N, absorb_diag=True)
    np.testing.assert_array_equal(
        fk.sampled_shot_indices_folded(pipeline, frac, N),
        fk.sampled_shot_indices_folded_plain(pipeline, frac, N),
    )
    assert sk.launch_counts["sampled_shot_indices"] == 0
    assert fk.launch_counts["sampled_shot_indices_folded"] == 0


def test_slot_and_fold_samplers_agree(work):
    """One function, two circuits: the fold pipeline's state differs from
    the slot engine's at the ulp level only."""
    for shots, with_prefix in ((512, False), (300, True)):
        slot = _port_indices(work, "slot", shots, with_prefix)
        assert (slot == _port_indices(work, "fold", shots, with_prefix)).mean() >= BAR


def test_prefix_start_state_samples_the_full_circuit(work):
    """Sampling the suffix from the prefix states draws the full circuit's
    shots, and the hierarchical sampler draws the flat sampler's."""
    from_prefix = _port_indices(work, "slot", 512, True)
    full = _port_indices(work, "slot", 512, False)
    assert (from_prefix == full).mean() >= BAR
    probs = sk.population_probs_plain(*genome_tensors_from_numpy(*work["genome"]), N)
    flat = sample_indices(prng.split(prng.PRNGKey(7), POP), probs, 512)
    assert (full == flat.numpy()).mean() >= BAR


def test_sampled_mean_statistics(work):
    """The mean of 2048 sampled energies lies within 5 standard errors of
    the exact energy, for both plain samplers."""
    rng = np.random.default_rng(1)
    table = torch.tensor(rng.normal(size=1 << N).astype(np.float32))
    tensors = genome_tensors_from_numpy(*work["genome"])
    probs = sk.population_probs_plain(*tensors, N)
    exact = probs @ table
    std = torch.sqrt(torch.clamp(probs @ table**2 - exact**2, min=0) / 2048)
    frac = prng.uniform(prng.split(prng.PRNGKey(9), POP), (2048,))
    pipeline = build_fold_pipeline(*tensors, N, absorb_diag=True)
    for idx in (sk.sampled_shot_indices(*tensors, frac, N),
                fk.sampled_shot_indices_folded(pipeline, frac, N)):
        z = (table[idx.long()].mean(dim=1) - exact) / std.clamp(min=1e-9)
        assert bool((z.abs() < 5).all()), z


def test_epilogue_alone_equals_the_sampled_kernel(work):
    tensors = genome_tensors_from_numpy(*work["genome"])
    states = sk.population_states_plain(*tensors, N)
    _, frac = _uniforms(128)
    np.testing.assert_array_equal(
        sk.sample_planes(states, frac, N), sk.sampled_shot_indices(*tensors, frac, N)
    )


def test_sampler_caps_follow_the_reference():
    assert fk.fold_supported(21, "cuda", "sampler") and not fk.fold_supported(22, "cuda", "sampler")
    assert not fk.fold_supported(21, "cpu", "sampler")
    assert (sk.SAMPLER_MIN_QUBITS, sk.SAMPLER_MAX_QUBITS) == (14, 20)


def test_objective_dispatches_shots_by_route_and_size(work, monkeypatch):
    """``population_shot_indices`` takes the slot sampled kernel, the
    folded one when the fold route applies (forced here by patching the
    port's own predicate, which otherwise needs CUDA tensors), and below
    n=14 the probabilities and the flat sampler, all with the same keys."""
    from queasars_tpu_torch.optim.objective import population_shot_indices
    from queasars_tpu_torch.sim import fold_pipeline

    tensors = genome_tensors_from_numpy(*work["genome"])
    keys = prng.split(prng.PRNGKey(1), POP)
    frac = prng.uniform(keys, (64,))
    slot = population_shot_indices(*tensors, keys, n_qubits=N, shots=64)
    np.testing.assert_array_equal(slot, sk.sampled_shot_indices_plain(*tensors, frac, N))
    monkeypatch.setattr(
        fk, "fold_supported",
        lambda n, device, path="exact": fold_pipeline.LANE_BITS <= n <= fk._CAPS[path],
    )
    pipeline = build_fold_pipeline(*tensors, N, absorb_diag=True)
    np.testing.assert_array_equal(
        population_shot_indices(*tensors, keys, n_qubits=N, shots=64),
        fk.sampled_shot_indices_folded_plain(pipeline, frac, N),
    )
    np.testing.assert_array_equal(
        population_shot_indices(*tensors, keys, n_qubits=N, shots=64, use_mxu=False), slot
    )
    population = EVQEPopulation.random_population(9, 2, POP, True, random_seed=4)
    small = JaxPacked.pack(list(population.individuals))
    small_tensors = genome_tensors_from_numpy(
        small.gate_types, small.controls, small.angles, small.layer_mask
    )
    np.testing.assert_array_equal(
        population_shot_indices(*small_tensors, keys, n_qubits=9, shots=64),
        sample_indices(keys, sk.population_probs_plain(*small_tensors, 9), 64),
    )
