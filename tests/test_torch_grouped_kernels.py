"""The one-launch grouped sampler's plain version (what the port runs on the
CPU, and what the card's kernel is held against) against the JAX package's
``pallas_grouped_shot_energies_folded`` in interpret mode, at n=14 -- the
smallest size the in-kernel samplers take -- on P=3, 2 layers: TFIM (two
groups, one of them unrotated) and a molecular-like 3-local operator (12
terms, four groups, every one rotated), with 512 shots per group and with a
proportional allocation, from |0...0> and from per-individual start states.

Both sides get the same per-group threefry uniforms
(``uniform(fold_in(key_p, g), S_g)``), so the indices compare draw for
draw: at least 99.5% must be equal (the JAX package's bar for two samplers
of one stream).  The Pallas kernel returns ``tables[g][index]``; with every
table ``arange(2^n)`` (exact in float32 at n=14) that is the index.  The
energies are then compared through the real tables to 1e-5 * max|table_g|
where every draw agrees.  The plain version must also equal the plain
per-group route (row 10's plain version on the extended pipeline) bit for
bit.  Each interpret call (several seconds on a CPU) runs once per module.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.exp_grouped_pallas import molecular_like as jax_molecular_like
from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.problems.spin_chains import transverse_field_ising as jax_tfim
from queasars_tpu.sim.fold_pipeline import build_fold_pipeline as jax_build
from queasars_tpu.sim.fold_pipeline import rotation_layer_factors as jax_rotation_factors
from queasars_tpu.sim.grouped_sampling import allocate_shots as jax_allocate_shots
from queasars_tpu.sim.grouped_sampling import grouped_operands as jax_grouped_operands
from queasars_tpu.sim.grouped_sampling import grouped_weights as jax_grouped_weights
from queasars_tpu.sim.pallas_fold_kernels import (
    grouped_fold_supported as jax_grouped_fold_supported,
)
from queasars_tpu.sim.pallas_fold_kernels import pallas_grouped_shot_energies_folded
from queasars_tpu.sim.statevector import simulate_circuits as jax_simulate
from queasars_tpu_torch.interop import genome_tensors_from_numpy, pauli_sum_from_numpy
from queasars_tpu_torch.sim import fold_kernels as fk
from queasars_tpu_torch.sim.fold_pipeline import (
    build_fold_pipeline,
    extend_fold_pipeline_with_rotation,
)
from queasars_tpu_torch.sim.grouped_sampling import grouped_operands
from queasars_tpu_torch.utils import prng

N = 14
POP = 3
BAR = 0.995
OPERATORS = {
    "tfim": lambda: jax_tfim(N, coupling=1.0, field=0.9),
    "molecular": lambda: jax_molecular_like(N, 12, 7),
}


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


def _case(work, kind, proportional, with_prefix):
    """Inputs of one case for both packages: the operator's grouped
    operands, the per-group shots and uniforms, the genome and start."""
    op_ref = OPERATORS[kind]()
    operands_ref = jax_grouped_operands(op_ref)
    n_groups = int(operands_ref[2].shape[0])
    shots = (jax_allocate_shots(jax_grouped_weights(op_ref), 384 * n_groups) if proportional
             else (512,) * n_groups)
    keys = prng.split(prng.PRNGKey(4), POP)
    fracs = [prng.uniform(prng.fold_in(keys, g), (s,)) for g, s in enumerate(shots)]
    gt, ctrl, ang, mask = work["genome"]
    if with_prefix:
        mask = work["suffix_mask"]
    initial = work["prefix"] if with_prefix else None
    op = pauli_sum_from_numpy(N, op_ref.z, op_ref.x, op_ref.coeffs)
    return op, operands_ref, shots, fracs, (gt, ctrl, ang, mask), initial


def _jax_indices(work, kind, proportional, with_prefix):
    """The Pallas kernel's sampled indices per group (interpret mode),
    cached."""
    key = (kind, proportional, with_prefix)
    if key not in work["cache"]:
        _, operands_ref, shots, fracs, genome, initial = _case(work, kind, proportional, with_prefix)
        rot_types, rot_angles, tables, _ = operands_ref
        rot_factors, rot_active = jax_rotation_factors(rot_types, rot_angles, N)
        index_tables = jnp.tile(jnp.arange(1 << N, dtype=jnp.float32), (len(shots), 1))
        out = pallas_grouped_shot_energies_folded(
            jax_build(*genome, N, absorb_diag=True), rot_factors, rot_active, index_tables,
            tuple(jnp.asarray(f.numpy()) for f in fracs), N, tuple(shots), interpret=True,
            initial=None if initial is None else jnp.asarray(initial),
        )
        work["cache"][key] = [np.asarray(o).astype(np.int64) for o in out]
    return work["cache"][key]


def _port_indices(work, kind, proportional, with_prefix):
    op, _, shots, fracs, genome, initial = _case(work, kind, proportional, with_prefix)
    ops = grouped_operands(op)
    pipeline = build_fold_pipeline(*genome_tensors_from_numpy(*genome), N, absorb_diag=True)
    start = None if initial is None else torch.tensor(initial)
    out = fk.grouped_shot_indices_folded(
        pipeline, ops.rot_factors, ops.rot_active, fracs, N, start, rotate=ops.rotate
    )
    assert len(out) == len(shots)
    for idx, s in zip(out, shots):
        assert idx.dtype == torch.int32 and tuple(idx.shape) == (POP, s)
    return ops, pipeline, fracs, start, [o.numpy().astype(np.int64) for o in out]


CASES = [("tfim", False, False), ("tfim", True, True), ("molecular", False, True),
         ("molecular", True, False)]


@pytest.mark.parametrize("kind, proportional, with_prefix", CASES)
def test_plain_grouped_sampler_matches_pallas_interpret(work, kind, proportional, with_prefix):
    ops, _, _, _, got = _port_indices(work, kind, proportional, with_prefix)
    want = _jax_indices(work, kind, proportional, with_prefix)
    for g, (idx, ref) in enumerate(zip(got, want)):
        assert (idx == ref).mean() >= BAR, (g, (idx == ref).mean())
        table = ops.tables[g].numpy()
        agree = (idx == ref).all(axis=1)
        e_port, e_ref = table[idx].mean(axis=1), table[ref].mean(axis=1)
        tol = 1e-5 * float(np.abs(table).max())
        np.testing.assert_allclose(e_port[agree], e_ref[agree], atol=tol, rtol=0)


@pytest.mark.parametrize("kind, proportional, with_prefix", CASES)
def test_plain_grouped_sampler_is_the_plain_per_group_route(work, kind, proportional, with_prefix):
    """Bit for bit: the plain circuit once, then per group the rotation,
    against row 10's plain version on each extended pipeline."""
    ops, pipeline, fracs, start, got = _port_indices(work, kind, proportional, with_prefix)
    for g in range(len(got)):
        extended = extend_fold_pipeline_with_rotation(
            pipeline, ops.rot_types[g], ops.rot_angles[g], N)
        per_group = fk.sampled_shot_indices_folded_plain(extended, fracs[g], N, start)
        np.testing.assert_array_equal(got[g], per_group.numpy())


def test_wrapper_runs_its_plain_version_on_the_cpu(work):
    op, _, shots, fracs, genome, _ = _case(work, "tfim", False, False)
    ops = grouped_operands(op)
    pipeline = build_fold_pipeline(*genome_tensors_from_numpy(*genome), N, absorb_diag=True)
    fk.reset_launch_counts()
    got = fk.grouped_shot_indices_folded(pipeline, ops.rot_factors, ops.rot_active, fracs, N)
    want = fk.grouped_shot_indices_folded_plain(pipeline, ops.rot_factors, ops.rot_active, fracs, N)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fk.launch_counts["grouped_shot_indices_folded"] == 0
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        fk.grouped_shot_indices_folded(pipeline, ops.rot_factors, ops.rot_active,
                                       [f.to("meta") for f in fracs], N)


def test_grouped_support_follows_the_reference():
    for n in (13, 14, 20, 21, 22):
        for groups in (1, 2, 64, 65):
            want = jax_grouped_fold_supported(n, "tpu", groups)
            assert fk.grouped_fold_supported(n, "cuda", groups) == want, (n, groups)
            assert not fk.grouped_fold_supported(n, "cpu", groups)


def test_grouped_objective_dispatches_by_route(work, monkeypatch):
    """``population_energies`` with grouped operands at n=14: the fold route
    (forced here by patching the port's own predicate, which otherwise
    needs CUDA tensors) takes the one-launch grouped sampler, or under
    ``QUEASARS_GROUPED_ONE_LAUNCH=0`` the folded sampler once per group on
    the extended pipeline; the slot route the slot sampler once per group on
    the extended genome.  The two fold branches give equal bits."""
    from queasars_tpu_torch.optim.objective import population_energies
    from queasars_tpu_torch.sim import fold_pipeline
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.grouped_sampling import append_rotation_layer

    op, _, _, _, genome, _ = _case(work, "molecular", False, False)
    ops = grouped_operands(op)
    tensors = genome_tensors_from_numpy(*genome)
    keys = prng.split(prng.PRNGKey(6), POP)
    shots = (64, 32, 48, 80)
    kwargs = dict(n_qubits=N, use_cvar=False, shots=shots, use_shots=True, use_general=True)

    def energies(use_mxu=None):
        return population_energies(*tensors, ops, None, None, 1.0, keys, use_mxu=use_mxu, **kwargs)

    slot = energies()
    expected = torch.full((POP,), ops.const)
    for g, s in enumerate(shots):
        frac = prng.uniform(prng.fold_in(keys, g), (s,))
        ext = append_rotation_layer(*tensors, ops.rot_types[g], ops.rot_angles[g])
        expected = expected + ops.tables[g][sk.sampled_shot_indices_plain(*ext, frac, N).long()].mean(-1)
    torch.testing.assert_close(slot, expected, atol=1e-6, rtol=0)
    monkeypatch.setattr(
        fk, "fold_supported",
        lambda n, device, path="exact": fold_pipeline.LANE_BITS <= n <= fk._CAPS[path],
    )
    fk.reset_launch_counts()
    one_launch = energies()
    monkeypatch.setenv("QUEASARS_GROUPED_ONE_LAUNCH", "0")
    per_group = energies()
    assert torch.equal(one_launch, per_group)
    assert torch.equal(energies(use_mxu=False), slot)
    assert fk.launch_counts["grouped_shot_indices_folded"] == 0
