"""The amplitude-sharded engine (``queasars_tpu_torch/sim/sharded_statevector.py``,
``sim/shard_kernels.py``, ``parallel/amplitude.py``) against the JAX
package's (``queasars_tpu/sim/sharded_statevector.py`` on its 8-device CPU
mesh), with the port's cells on ``["cpu"] * 8``.

- Sharded states and population probabilities equal the JAX functions'
  to 1e-5, with and without a start state, and the port's are
  bit-identical across 1x8, 2x4, 4x2 and 8x1.
- Device tables (single and batched) and ``group_general_terms`` equal the
  JAX package's exactly; so do ``blocked_shot_positions``' draws.
- The four shard kernels' plain versions: the pair combine equals the slot
  engine's plain version bit for bit on every control class, the group
  product is m such pair combines bit for bit and equals the float64
  product with its dense Kronecker matrix to 2e-6 of its largest output,
  the phase pass equals the fold
  pipeline's plain application, the running sum is XLA's CPU cumsum.
- The mesh object: constructors, refusals, the exchange's pairing and its
  autograd, the fixed-tree sum against ``torch.sum``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from queasars_tpu.genome import EVQEPopulation as JaxPopulation
from queasars_tpu.genome.packing import PackedPopulation as JaxPacked
from queasars_tpu.sim import sharded_statevector as jss
from queasars_tpu.sim.sharded_evaluator import amplitude_mesh as jax_amplitude_mesh
from queasars_tpu.sim.sharded_evaluator import pop_amp_mesh as jax_pop_amp_mesh
from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.parallel import population_mesh
from queasars_tpu_torch.parallel.amplitude import (
    AmpRow,
    amplitude_mesh,
    as_amplitude_mesh,
    as_pop_amp_mesh,
    exchange,
    pop_amp_mesh,
    tree_reduce_last,
)
from queasars_tpu_torch.sim import shard_kernels
from queasars_tpu_torch.sim import sharded_statevector as tss
from queasars_tpu_torch.sim.evaluators import packed_tensors
from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline
from queasars_tpu_torch.sim.sampling import running_sum
from queasars_tpu_torch.sim.sharded_fold import factor_entries, group_fold_dense
from queasars_tpu_torch.sim.statevector import apply_u3_pairs, u3_entries

CELLS = ["cpu"] * 8
FACTORIZATIONS = [(1, 8), (2, 4), (4, 2), (8, 1)]

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


def _genome(packed):
    return packed.gate_types, packed.controls, packed.angles, packed.layer_mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_circuit_matches_jax(seed):
    ours, theirs = _packed(6, 3, 1, seed)
    fn = jss.make_sharded_circuit_fn(jax_amplitude_mesh(8), 6)
    want = np.asarray(fn(*(a[0] for a in _genome(theirs))))
    got = tss.sharded_circuit(amplitude_mesh(devices=CELLS), 6,
                              *(a[0] for a in _genome(ours))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose((got ** 2).sum(), 1.0, atol=1e-5)


def test_population_probs_match_jax_and_every_factorization():
    n = 8
    ours, theirs = _packed(n, 3, 6, 4)
    rng = np.random.default_rng(1)
    start = rng.normal(size=(2, 1 << n)).astype(np.float32)
    start /= np.sqrt((start ** 2).sum())
    for initial in (None, start):
        results = []
        for n_pop, n_amp in FACTORIZATIONS:
            mesh = pop_amp_mesh(n_pop, n_amp, devices=CELLS)
            results.append(tss.sharded_population_probs(mesh, n, *_genome(ours),
                                                        initial=initial).numpy())
        for other in results[1:]:
            np.testing.assert_array_equal(other, results[0])
        jax_mesh = jax_pop_amp_mesh(2, 4)
        if initial is None:
            fn = jss.make_sharded_population_probs_fn(jax_mesh, n)
            want = np.asarray(fn(*(jnp.asarray(a) for a in _genome(theirs))))
        else:
            fn = jss.make_sharded_population_probs_fn(jax_mesh, n, with_initial=True)
            padded = [np.pad(a, [(0, 2)] + [(0, 0)] * (a.ndim - 1)) for a in _genome(theirs)]
            want = np.asarray(fn(*padded, start))[:6]
        np.testing.assert_allclose(results[0], want, atol=1e-5)


def test_device_tables_and_term_groups_equal_jax():
    n = 9
    rng = np.random.default_rng(5)
    coeffs = rng.normal(size=17)
    masks = rng.integers(0, 1 << n, size=17).astype(np.uint64)
    for n_amp in (1, 2, 8):
        got = tss.build_device_table(amplitude_mesh(devices=["cpu"] * n_amp), coeffs, masks, n)
        want = np.asarray(jss.build_device_table(jax_amplitude_mesh(n_amp), coeffs, masks, n))
        np.testing.assert_array_equal(got.full().numpy(), want)
    g_coeffs = rng.normal(size=(3, 5)).astype(np.float32)
    g_masks = rng.integers(0, 1 << n, size=(3, 5)).astype(np.uint32)
    got = tss.build_device_tables_batch(amplitude_mesh(devices=CELLS), g_coeffs, g_masks, n)
    want = np.asarray(jss.build_device_tables_batch(jax_amplitude_mesh(8), g_coeffs, g_masks, n))
    np.testing.assert_array_equal(got.full().numpy(), want)

    z = rng.integers(0, 1 << n, size=11).astype(np.uint64)
    x = rng.integers(0, 1 << n, size=11).astype(np.uint64)
    c_re, c_im = rng.normal(size=11), rng.normal(size=11)
    xg, terms = tss.group_general_terms(c_re, c_im, z, x, 6)
    xg_ref, terms_ref = jss.group_general_terms(c_re, c_im, z, x, 6)
    assert xg == xg_ref
    for key, value in terms_ref.items():
        np.testing.assert_array_equal(terms[key], value)
        assert terms[key].dtype == value.dtype


def _jax_positions(n_amp, probs, key, shots):
    mesh = jax_amplitude_mesh(n_amp)

    def body(local, k):
        device_id = jax.lax.axis_index(jss.AMP_AXIS)
        pos, owned = jss.blocked_shot_positions(local, k, shots, device_id, n_amp)
        return pos[None], owned[None]

    fn = shard_map(body, mesh=mesh, in_specs=(P(jss.AMP_AXIS), P()),
                   out_specs=(P(jss.AMP_AXIS), P(jss.AMP_AXIS)), check_vma=False)
    pos, owned = fn(jnp.asarray(probs), key)
    return np.asarray(pos), np.asarray(owned)


@pytest.mark.parametrize("n_qubits", [9, 13])
def test_blocked_shot_positions_equal_jax(n_qubits):
    """Equal draws at one block per amplitude (n=9) and at blocks of 2
    (n=13, over 4096 global blocks)."""
    rng = np.random.default_rng(n_qubits)
    probs = rng.random(1 << n_qubits).astype(np.float32) ** 4
    probs /= probs.sum()
    shots = 300
    from queasars_tpu_torch.utils import prng

    key_ref = jax.random.PRNGKey(9)
    key = prng.PRNGKey(9)
    for n_amp in (1, 4):
        pos_ref, owned_ref = _jax_positions(n_amp, probs, key_ref, shots)
        row = amplitude_mesh(devices=["cpu"] * n_amp).row(0, n_qubits)
        shards = row.split(torch.as_tensor(probs)[None])
        positions, owned = tss.blocked_shot_positions(row, shards, key[None], shots)
        for a in range(n_amp):
            np.testing.assert_array_equal(positions[a][0].numpy(), pos_ref[a])
            np.testing.assert_array_equal(owned[a][0].numpy(), owned_ref[a])


# ---------------------------------------------------------------------------
# the shard kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", [0, 3, 5])
def test_pair_combine_plain_equals_the_slot_engine(target):
    """Every control class (none, a control below and above the target, a
    row turned off): the in-shard partner gives the slot engine's plain
    pair update bit for bit."""
    n = 6
    rng = np.random.default_rng(target)
    state = torch.as_tensor(rng.normal(size=(4, 2, 1 << n)).astype(np.float32))
    angles = torch.as_tensor(rng.uniform(-3, 3, size=(4, 3)).astype(np.float32))
    control = torch.tensor([-1, (target + 1) % n, (target + 2) % n, -1], dtype=torch.int32)
    enabled = torch.tensor([True, True, True, False])
    want = apply_u3_pairs(state, target, u3_entries(angles), enabled, control >= 0, control, n)
    got = shard_kernels.pair_combine(state, None, tss.slot_entries(angles), control, enabled,
                                     n, target)
    assert torch.equal(got, want)


def test_pair_combine_on_a_global_target_equals_the_slot_engine():
    """Target 5 on 4 shards of 16 (global bit 1), controls none, local,
    global and a row off: the exchanged partner and the cells' side bits
    give the unsharded update bit for bit."""
    n, target = 6, 5
    rng = np.random.default_rng(7)
    state = torch.as_tensor(rng.normal(size=(4, 2, 1 << n)).astype(np.float32))
    angles = torch.as_tensor(rng.uniform(-3, 3, size=(4, 3)).astype(np.float32))
    control = torch.tensor([-1, 1, 4, 2], dtype=torch.int32)
    enabled = torch.tensor([True, True, True, False])
    want = apply_u3_pairs(state, target, u3_entries(angles), enabled, control >= 0, control, n)
    row = AmpRow(["cpu"] * 4, [0] * 4, n)
    shards = row.split(state)
    partners = row.exchange(shards, 1 << (target - row.local_bits))
    types = torch.where(control >= 0, 3, 1).to(torch.int32)
    types = torch.where(enabled, types, torch.zeros_like(types))
    full_types = torch.zeros((4, 1, n), dtype=torch.int32)
    full_types[:, 0, target] = types
    full_ctrl = torch.full((4, 1, n), -1, dtype=torch.int32)
    full_ctrl[:, 0, target] = control
    out = {}
    for a in row.cells:
        on, ctrl_bit = tss.global_slot_operands(full_types, full_ctrl, torch.ones(4, 1), 4, a)
        out[a] = shard_kernels.pair_combine(
            shards[a], partners[a], tss.slot_entries(angles), ctrl_bit[:, 0, 1], on[:, 0, 1],
            row.local_bits, -1, row.cell_bit(a, 1))
    assert torch.equal(torch.cat([out[a] for a in row.cells], dim=-1), want)


def _random_factors(rng, rows, n):
    """[rows, n, 2 (re/im), 2, 2] float32 per-qubit unitaries (QR of complex
    normal matrices), the fold pipeline's factor layout."""
    z = rng.normal(size=(rows, n, 2, 2)) + 1j * rng.normal(size=(rows, n, 2, 2))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    u = q * (d / np.abs(d))[..., None, :]
    return torch.as_tensor(np.stack([u.real, u.imag], axis=2).astype(np.float32))


def test_group_product_plain_equals_a_dense_product():
    """The factored product of random per-qubit unitaries equals the float64
    product with their dense Kronecker matrix (``group_fold_dense``) to
    2e-6 of its largest output: the two differ by float32 rounding only."""
    rng = np.random.default_rng(2)
    rows, n = 3, 10
    state = torch.as_tensor(rng.normal(size=(rows, 2, 1 << n)).astype(np.float32))
    factors = _random_factors(rng, rows, n)
    for q0, m in ((0, 7), (7, 3), (2, 4)):
        d = 1 << m
        entries = factor_entries(factors[:, q0:q0 + m]).contiguous()
        got = shard_kernels.group_product(state, entries, n, q0, m).numpy().astype(np.float64)
        re, im = group_fold_dense(factors.double(), q0, m)
        uc = re.numpy() + 1j * im.numpy()
        x = state.numpy().astype(np.float64).reshape(rows, 2, -1, d, 1 << q0)
        xc = x[:, 0] + 1j * x[:, 1]
        want = np.einsum("bkj,bhjl->bhkl", uc, xc).reshape(rows, -1)
        np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], want,
                                   atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize(("q0", "m"), [(0, 7), (7, 3), (2, 4), (7, 7)])
def test_group_product_plain_is_m_pair_combines(q0, m):
    """``group_product_plain`` is qubit q0's pair combine, then q0 + 1's and
    so on (no control, every row on), bit for bit, and shards of half the
    width and of the narrowest width that holds the group give the same
    bits on their parts.  On the CPU the wrapper is the plain version, so
    the first assertion pins that version's definition; the card tests
    hold the kernel to it."""
    rng = np.random.default_rng(q0 * 8 + m)
    rows, n = 4, 15
    state = torch.as_tensor(rng.normal(size=(rows, 2, 1 << n)).astype(np.float32))
    entries = factor_entries(_random_factors(rng, rows, m)).contiguous()
    want = state
    for j in range(m):
        want = shard_kernels.pair_combine(want, None, entries[:, j].contiguous(),
                                          torch.full((rows,), -1, dtype=torch.int32),
                                          torch.ones(rows, dtype=torch.bool), n, q0 + j)
    got = shard_kernels.group_product(state, entries, n, q0, m)
    assert torch.equal(got, want)
    halves = [shard_kernels.group_product(h.contiguous(), entries, n - 1, q0, m)
              for h in state.chunk(2, dim=2)]
    assert torch.equal(torch.cat(halves, dim=2), want)
    narrow = [shard_kernels.group_product(p.contiguous(), entries, q0 + m, q0, m)
              for p in state.chunk(1 << (n - q0 - m), dim=2)]
    assert torch.equal(torch.cat(narrow, dim=2), want)


def test_diag_phase_plain_equals_the_fold_pipeline_plain_pass():
    from queasars_tpu_torch.sim.fold_pipeline import _phase_weights

    n = 7
    ours, _ = _packed(n, 2, 4, 11)
    gt, ctrl, ang, lm = packed_tensors(ours)
    pipe = build_fold_pipeline(gt, ctrl, ang, lm, n)
    rng = np.random.default_rng(3)
    state = torch.as_tensor(rng.normal(size=(4, 2, 1 << n)).astype(np.float32))
    basis = torch.arange(1 << n)
    for k in range(pipe.diag_ctrl.shape[1]):
        got = shard_kernels.diag_phase(state.clone(), pipe.diag_ctrl[:, k].contiguous(),
                                       pipe.diag_tgt[:, k].contiguous(),
                                       pipe.diag_phase[:, k].contiguous(), n, 0)
        weights = _phase_weights(pipe.diag_ctrl[:, k], pipe.diag_tgt[:, k],
                                 pipe.diag_phase[:, k], pipe.diag_count[:, k], basis)
        want = torch.complex(state[:, 0], state[:, 1]) * weights
        np.testing.assert_allclose(torch.complex(got[:, 0], got[:, 1]).numpy(), want.numpy(),
                                   atol=1e-6)


def test_running_sum_is_xla_cumsum():
    rng = np.random.default_rng(4)
    values = rng.random((3, 4096)).astype(np.float32)
    for seg in (1, 16, 64, 1024, 4096):
        got = shard_kernels.running_sum(torch.as_tensor(values), seg).numpy()
        want = np.asarray(jnp.cumsum(jnp.asarray(values.reshape(-1, seg)), axis=-1))
        np.testing.assert_array_equal(got.reshape(-1, seg), want)
        assert torch.equal(torch.as_tensor(got.reshape(-1, seg)),
                           running_sum(torch.as_tensor(values.reshape(-1, seg))))


# ---------------------------------------------------------------------------
# the mesh object
# ---------------------------------------------------------------------------


def test_mesh_constructors_and_refusals():
    mesh = pop_amp_mesh(2, 4, devices=CELLS)
    assert (mesh.n_pop, mesh.n_amp, mesh.size) == (2, 4, 8)
    assert as_pop_amp_mesh(mesh) is mesh
    with pytest.raises(ValueError, match="conflicting"):
        as_pop_amp_mesh(mesh, amp_devices=2)
    flat = as_amplitude_mesh(mesh)
    assert (flat.n_pop, flat.n_amp) == (1, 8)
    population = population_mesh(devices=CELLS)
    assert as_pop_amp_mesh(population).n_amp == 8
    assert as_pop_amp_mesh(population, amp_devices=2).n_pop == 4
    with pytest.raises(ValueError, match="must divide"):
        as_pop_amp_mesh(population, amp_devices=3)
    with pytest.raises(ValueError, match="need 8 devices"):
        pop_amp_mesh(2, 4, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="power of two"):
        pop_amp_mesh(1, 3, devices=["cpu"] * 3).row(0, 6)
    with pytest.raises(ValueError, match="too small"):
        amplitude_mesh(devices=CELLS).row(0, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            amplitude_mesh()


def test_exchange_pairs_cells_and_its_gradient_goes_back():
    row = AmpRow(["cpu"] * 4, [0] * 4, 5)
    shards = {a: torch.full((2, 2, 8), float(a), requires_grad=True) for a in row.cells}
    partners = exchange(row, shards, 2)
    assert [int(partners[a][0, 0, 0]) for a in row.cells] == [2, 3, 0, 1]
    loss = sum((partners[a] * (a + 1)).sum() for a in row.cells)
    loss.backward()
    assert [float(shards[a].grad[0, 0, 0]) for a in row.cells] == [3.0, 4.0, 1.0, 2.0]


def test_tree_sum_is_the_jax_blocked_sum_and_the_tree_over_the_whole_axis():
    """``AmpRow.tree_sum`` equals the JAX package's blocked reduction (block
    partials in the fixed tree, then its ``AMP_BLOCKS`` partials) and the
    tree over the whole axis, for every width; ``sharded_expectation`` is
    the state's energy."""
    rng = np.random.default_rng(8)
    full = torch.as_tensor(rng.normal(size=(3, 1 << 10)).astype(np.float32))
    want = tree_reduce_last(full)
    for n_amp in (1, 2, 8):
        row = AmpRow(["cpu"] * n_amp, [0] * n_amp, 10)
        assert torch.equal(row.tree_sum(row.split(full)), want)
        total, per_shard = jss._block_counts(n_amp, 10)
        blocked = tree_reduce_last(full.reshape(3, total, -1))
        assert torch.equal(tree_reduce_last(blocked), want) and total == n_amp * per_shard
    state = rng.normal(size=(2, 1 << 10)).astype(np.float32)
    state /= np.sqrt((state ** 2).sum())
    table = rng.normal(size=1 << 10)
    sharded = tss.place_sharded(amplitude_mesh(devices=CELLS), table.astype(np.float32), 10)
    energy = tss.sharded_expectation(amplitude_mesh(devices=CELLS), state, sharded)
    assert energy == pytest.approx(float((state.astype(np.float64) ** 2).sum(0) @ table),
                                   abs=1e-5)
