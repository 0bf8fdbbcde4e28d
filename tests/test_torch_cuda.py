"""The CUDA kernels: their C binding (checked here) and, on a card, each
slot and fold kernel against its plain version.

Tests marked ``cuda`` need an NVIDIA GPU; they decide inside the test (the
``cuda_device`` fixture) and skip without one.  Run them on a card with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.  Tolerances as on
the main path: probabilities and amplitudes 1e-5, energies
1e-5 * max|table|; the folded sweep's energies likewise against its plain version.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.sim import slot_kernels as sk
from queasars_tpu_torch.sim.evaluators import packed_tensors
from queasars_tpu_torch.utils import cuda_lib


def test_ctypes_signatures_match_the_c_entry_points():
    source = "\n".join(path.read_text() for path in cuda_lib.sources())
    exported = {}
    for name, params in re.findall(r"\bint (qt_\w+)\(([^)]*)\)\s*\{", source):
        exported[name] = [p.strip() for p in params.split(",")]
    assert set(exported) == set(cuda_lib.SIGNATURES)
    for name, params in exported.items():
        kinds = ["ptr" if ("*" in p) else "int" for p in params]
        bound = ["ptr" if t is cuda_lib.ctypes.c_void_p else "int" for t in cuda_lib.SIGNATURES[name]]
        assert kinds == bound, name


def test_build_flags_target_hopper_without_fast_math():
    flags = " ".join(cuda_lib.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-shared" in flags
    assert cuda_lib.library_path().parent == cuda_lib.BUILD_DIR
    assert cuda_lib.library_path() == cuda_lib.library_path()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _genomes(n_qubits, layers, pop, seed, device):
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=layers + 1)
    packed.layer_mask[0, 1] = False
    return packed_tensors(packed, device=device)


def slot_engine_windows(n_qubits):
    """The slot engine's passes per layer (``csrc/slot_kernels.cu``) as
    (first target, end target, low bits): qubits below 13 in the low tile,
    the top qubits in windows of at most 9 bits whose tiles keep 13 - width
    low bits together."""
    tile = min(max(n_qubits, 5), 13)
    windows = [(0, min(n_qubits, 13), tile)]
    top = n_qubits - 13
    count = -(-top // 9) if top > 0 else 0
    start = 13
    for k in range(count):
        width = top // count + (k < top % count)
        windows.append((start, start + width, 13 - width))
        start += width
    return windows


def control_region(n_qubits, target, control):
    """Where the slot engine finds a CU3's control bit: (window, the round's
    first local bit, "register" / "tile" / "outside", "above" / "below")."""
    for w, (q_lo, q_hi, low) in enumerate(slot_engine_windows(n_qubits)):
        if q_lo <= target < q_hi:
            break
    tile_bits = low if w == 0 else 13
    first = 0 if w == 0 else low

    def local(q):
        if q < low:
            return q
        return low + q - q_lo if w > 0 and q_lo <= q < q_hi else None

    lo = first + (local(target) - first) // 5 * 5
    s = min(lo, tile_bits - 5)
    lc = local(control)
    region = "outside" if lc is None else "register" if s <= lc < s + 5 else "tile"
    return w, lo, region, "above" if control > target else "below"


def slot_engine_genome(n_qubits, seed, min_layers=3):
    """A numpy genome (gate_types, controls, angles, layer_mask) that puts a
    CU3 in every (window, round, control region, control above or below)
    class of ``control_region`` that n_qubits allows, in individuals 0-2,
    with U3s on a random half of the free slots.  Individual 3 has no gate;
    individual 4 has U3s on the low tile's qubits only in layer 0, on the
    top qubits only in layer 1 (n > 13) and a masked layer 2; individual 5
    is random.  Returns the genome and the classes it covers."""
    rng = np.random.default_rng(seed)
    n = n_qubits
    classes = {}
    for target in range(n):
        for control in range(n):
            if control != target:
                classes.setdefault(control_region(n, target, control), []).append(
                    (target, control))
    pairs = [pairs[rng.integers(len(pairs))] for _, pairs in sorted(classes.items())]
    used = [[] for _ in range(3)]  # per individual: the qubits of each layer
    placed = [[] for _ in range(3)]
    for i, (target, control) in enumerate(pairs):
        layers = used[i % 3]
        k = next((k for k, q in enumerate(layers) if target not in q and control not in q), None)
        if k is None:
            layers.append(set())
            k = len(layers) - 1
        layers[k] |= {target, control}
        placed[i % 3].append((k, target, control))
    n_layers = max(min_layers, *(len(u) for u in used))
    pop = 6
    gate_types = np.zeros((pop, n_layers, n), np.int32)
    controls = np.full((pop, n_layers, n), -1, np.int32)
    angles = rng.uniform(-np.pi, np.pi, (pop, n_layers, n, 3)).astype(np.float32)
    layer_mask = np.ones((pop, n_layers), bool)
    for p in range(3):
        for k, target, control in placed[p]:
            gate_types[p, k, target], controls[p, k, target] = 3, control
            gate_types[p, k, control] = 2
        free = gate_types[p] == 0
        gate_types[p][free & (rng.random(free.shape) < 0.5)] = 1
    low = np.arange(n) < 13
    gate_types[4, 0, low] = 1
    gate_types[4, 1, ~low] = 1
    gate_types[4, 2] = 1
    layer_mask[4, 2] = False
    for k in range(n_layers):
        order = rng.permutation(n)
        for a, b in zip(order[0::2], order[1::2]):
            kind = rng.integers(3)
            if kind == 2:
                gate_types[5, k, a], controls[5, k, a], gate_types[5, k, b] = 3, b, 2
            else:
                gate_types[5, k, [a, b]] = kind
    return (gate_types, controls, angles, layer_mask), set(classes)


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [7, 12])
def test_circuit_kernels_match_plain_versions(cuda_device, n_qubits):
    genome = _genomes(n_qubits, 3, 5, n_qubits, cuda_device)
    gen = torch.Generator(device="cpu").manual_seed(n_qubits)
    table = (torch.randn(1 << n_qubits, generator=gen) * 30).to(cuda_device)
    initial = sk.population_states(*genome, n_qubits)
    sk.reset_launch_counts()
    torch.testing.assert_close(
        initial, sk.population_states_plain(*genome, n_qubits), atol=1e-5, rtol=0
    )
    torch.testing.assert_close(
        sk.population_probs(*genome, n_qubits, initial),
        sk.population_probs_plain(*genome, n_qubits, initial), atol=1e-5, rtol=0,
    )
    tol = 1e-5 * float(table.abs().max())
    energies = sk.energies_exact(*genome, table, n_qubits, initial)
    torch.testing.assert_close(
        energies, sk.energies_exact_plain(*genome, table, n_qubits, initial), atol=tol, rtol=0
    )
    assert torch.equal(energies, sk.energies_exact(*genome, table, n_qubits, initial))
    torch.cuda.synchronize()
    assert sk.launch_counts["population_probs"] == 1
    assert sk.launch_counts["energies_exact"] == 2


def _first_layer_sweep(gt, ctrl, ang, n):
    """The slot sweep's arguments for each individual's first layer from
    |0...0> (prefix: no layer): layer slices and free coordinates."""
    pop = gt.shape[0]
    layer = [t[:, 0].contiguous() for t in (gt, ctrl, ang)]
    coords = torch.zeros((pop, 3 * n, 2), dtype=torch.int32)
    n_free = torch.zeros(pop, dtype=torch.int32)
    for p, types in enumerate(layer[0].cpu().tolist()):
        flat = [(q, a) for q, t in enumerate(types) if t in (1, 3) for a in range(3)]
        if flat:
            coords[p, : len(flat)] = torch.tensor(flat, dtype=torch.int32)
        n_free[p] = len(flat)
    n_free = n_free.to(gt.device)
    return (*layer, coords.to(gt.device), n_free, n_free > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [3, 7, 12, 13, 14, 15, 18, 20, 21, 22])
def test_slot_engine_tile_shapes(cuda_device, n_qubits):
    """Every tile shape of the slot circuit engine (a state smaller than one
    round at n=3, the whole state in one tile at n <= 13; 1-, 2-, 5-, 7-, 8-
    and 9-bit top windows) on a genome
    with a CU3 in every control class (``slot_engine_genome``: control in
    the same round, elsewhere in the tile or outside it, above or below the
    target), a masked layer, an individual with no gate and layers whose
    gates are all low or all high.  Whole, prefix and suffix circuits and
    none at all, from |0...0> and from per-individual start states: states
    equal to the plain version bit for bit; energies and probabilities
    equal on a repeat; at n <= 20 the sweep (BASE from the P prefix
    states) against its plain version to 1e-5 * max|table|; at
    n = 14 and 20 the sampler's draws all equal to its plain version's."""
    from queasars_tpu_torch.interop import genome_tensors_from_numpy
    from queasars_tpu_torch.optim.prefix import prefix_mask
    from queasars_tpu_torch.utils import prng

    n = n_qubits
    genome, _ = slot_engine_genome(n, seed=n)
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*genome, device=cuda_device)
    pop = gt.shape[0]
    rng = np.random.default_rng(n)
    initial = rng.normal(size=(pop, 2, 1 << n)).astype(np.float32)
    initial /= np.sqrt((initial**2).sum(axis=(1, 2), keepdims=True))
    initial = torch.from_numpy(initial).to(cuda_device)
    table = torch.from_numpy((rng.normal(size=1 << n) * 30).astype(np.float32)).to(cuda_device)
    pmask = prefix_mask(mask, mask.sum(dim=1).clamp(min=1) - 1)
    for m in (mask, pmask, mask & ~pmask, torch.zeros_like(mask)):
        for start in (None, initial):
            states = sk.population_states(gt, ctrl, ang, m, n, start)
            assert torch.equal(states, sk.population_states_plain(gt, ctrl, ang, m, n, start))
    probs = sk.population_probs(gt, ctrl, ang, mask, n, initial)
    assert torch.equal(probs, sk.population_probs(gt, ctrl, ang, mask, n, initial))
    energies = sk.energies_exact(gt, ctrl, ang, mask, table, n, initial)
    assert torch.equal(energies, sk.energies_exact(gt, ctrl, ang, mask, table, n, initial))
    if n <= 20:
        prefix = sk.population_states(gt, ctrl, ang, torch.zeros_like(mask), n, initial)
        args = (*_first_layer_sweep(gt, ctrl, ang, n), prefix, table, n, 9, 4)
        _, z = sk.nft_layer_sweep(*args)
        _, z_plain = sk.nft_layer_sweep_plain(*args)
        torch.testing.assert_close(z, z_plain, atol=1e-5 * float(table.abs().max()), rtol=0)
    if n in (14, 20):
        frac = prng.uniform(prng.split(prng.PRNGKey(n), pop), (512,)).to(cuda_device)
        for start in (None, initial):
            assert torch.equal(sk.sampled_shot_indices(gt, ctrl, ang, mask, frac, n, start),
                               sk.sampled_shot_indices_plain(gt, ctrl, ang, mask, frac, n, start))


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits,passes_per_layer", [(9, 0), (13, 0), (14, 2), (22, 2), (23, 3)])
def test_slot_engine_launches_per_layer(cuda_device, n_qubits, passes_per_layer):
    """The slot engine's launches per circuit, read from the profiler: one
    for the whole circuit at n <= 13 (0 per layer here), one per window and
    layer above: two at 14 <= n <= 22, three at n = 23 (two top windows)."""
    from torch.profiler import ProfilerActivity, profile

    from queasars_tpu_torch.interop import genome_tensors_from_numpy

    genome, _ = slot_engine_genome(n_qubits, seed=1)
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*genome, device=cuda_device)
    states = sk.population_states(gt, ctrl, ang, mask, n_qubits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = sk.population_states(gt, ctrl, ang, mask, n_qubits)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if "slot_pass" in e.key)
    assert launches == (passes_per_layer * gt.shape[1] or 1)
    assert torch.equal(states, again)
    if n_qubits == 23:  # beyond the other tests' widths: against the plain version too
        assert torch.equal(states, sk.population_states_plain(gt, ctrl, ang, mask, n_qubits))


@pytest.mark.cuda
def test_sweep_kernel_matches_plain_version(cuda_device):
    n = 9
    gt, ctrl, ang, mask = _genomes(n, 2, 4, 3, cuda_device)
    table = torch.linspace(-5.0, 7.0, 1 << n, device=cuda_device).flip(0).contiguous()
    prefix = sk.population_states(gt, ctrl, ang, torch.zeros_like(mask), n)
    layer = [t[:, 0].contiguous() for t in (gt, ctrl, ang)]
    coords = torch.zeros((4, 3 * n, 2), dtype=torch.int32)
    n_free = torch.zeros(4, dtype=torch.int32)
    for p, types in enumerate(layer[0].cpu().tolist()):
        flat = [(q, a) for q, t in enumerate(types) if t in (1, 3) for a in range(3)]
        coords[p, : len(flat)] = torch.tensor(flat, dtype=torch.int32).reshape(-1, 2)
        n_free[p] = len(flat)
    args = (*layer, coords.to(cuda_device), n_free.to(cuda_device), n_free.to(cuda_device) > 0,
            prefix, table, n, 11, 4)
    _, z = sk.nft_layer_sweep(*args)
    _, z_plain = sk.nft_layer_sweep_plain(*args)
    np.testing.assert_allclose(z.cpu().numpy(), z_plain.cpu().numpy(), atol=1e-5 * 7.0)


def _fold_sweep_args(gt, ctrl, ang, mask, n, table, maxiter, reset):
    """The folded sweep's arguments for each individual's first layer
    (prefix: nothing), as the folded launcher builds them."""
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline

    device = gt.device
    pop = gt.shape[0]
    layer = [t[:, 0].contiguous() for t in (gt, ctrl, ang)]
    meta = [torch.as_tensor(m, device=device) for m in fk.fold_sweep_metadata(
        layer[0].cpu().numpy(), layer[1].cpu().numpy(), n)]
    prefix = fk.population_states_folded(
        build_fold_pipeline(gt, ctrl, ang, torch.zeros_like(mask), n, absorb_diag=True), n)
    coords = torch.zeros((pop, 3 * n, 2), dtype=torch.int32)
    n_free = torch.zeros(pop, dtype=torch.int32)
    for p, types in enumerate(layer[0].cpu().tolist()):
        flat = [(q, a) for q, t in enumerate(types) if t in (1, 3) for a in range(3)]
        coords[p, : len(flat)] = torch.tensor(flat, dtype=torch.int32).reshape(-1, 2)
        n_free[p] = len(flat)
    n_free = n_free.to(device)
    return (layer[0], layer[2], coords.to(device), n_free, n_free > 0, prefix, table, *meta,
            n, maxiter, reset)


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [10, 14, 20])
def test_fold_kernels_match_plain_versions(cuda_device, n_qubits):
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline

    genome = _genomes(n_qubits, 3, 3, n_qubits, cuda_device)
    gen = torch.Generator(device="cpu").manual_seed(n_qubits)
    table = (torch.randn(1 << n_qubits, generator=gen) * 30).to(cuda_device)
    pipeline = build_fold_pipeline(*genome, n_qubits, absorb_diag=True)
    fk.reset_launch_counts()
    initial = fk.population_states_folded(pipeline, n_qubits)
    torch.testing.assert_close(
        initial, fk.population_states_folded_plain(pipeline, n_qubits), atol=1e-5, rtol=0
    )
    torch.testing.assert_close(
        fk.population_probs_folded(pipeline, n_qubits, initial),
        fk.population_probs_folded_plain(pipeline, n_qubits, initial), atol=1e-5, rtol=0,
    )
    tol = 1e-5 * float(table.abs().max())
    energies = fk.energies_exact_folded(pipeline, table, n_qubits, initial)
    torch.testing.assert_close(
        energies, fk.energies_exact_folded_plain(pipeline, table, n_qubits, initial),
        atol=tol, rtol=0,
    )
    assert torch.equal(energies, fk.energies_exact_folded(pipeline, table, n_qubits, initial))
    torch.testing.assert_close(  # the fold route against the slot route
        fk.energies_exact_folded(pipeline, table, n_qubits),
        sk.energies_exact(*genome, table, n_qubits), atol=tol, rtol=0,
    )
    args = _fold_sweep_args(*genome, n_qubits, table, 7, 3)
    _, z = fk.nft_layer_sweep_folded(*args)
    _, z_plain = fk.nft_layer_sweep_folded_plain(*args)
    torch.testing.assert_close(z, z_plain, atol=tol, rtol=0)
    torch.cuda.synchronize()
    assert fk.launch_counts == {"energies_exact_folded": 3, "population_states_folded": 2,
                                "nft_layer_sweep_folded": 1, "population_probs_folded": 1,
                                "sampled_shot_indices_folded": 0,
                                "grouped_shot_indices_folded": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [8, 9, 11, 12, 13, 15, 16, 19, 21, 22])
def test_fold_circuit_kernels_at_every_group_width(cuda_device, n_qubits):
    """Every axis-group width: row groups of 1-6 bits (n=8..13, the whole
    state in one tile), top groups of 1, 2, 5 and 7 bits (n=15, 16, 19,
    21: one-round and two-round top passes), and the 8-bit top group of
    n=22, applied natively by the top pass (no phase is absorbed into it at
    that size)."""
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline

    genome = _genomes(n_qubits, 2, 2, n_qubits, cuda_device)
    gen = torch.Generator(device="cpu").manual_seed(n_qubits)
    table = (torch.randn(1 << n_qubits, generator=gen) * 30).to(cuda_device)
    pipeline = build_fold_pipeline(*genome, n_qubits, absorb_diag=True)
    states = fk.population_states_folded(pipeline, n_qubits)
    torch.testing.assert_close(
        states, fk.population_states_folded_plain(pipeline, n_qubits), atol=1e-5, rtol=0
    )
    torch.testing.assert_close(
        fk.population_probs_folded(pipeline, n_qubits),
        states[:, 0] ** 2 + states[:, 1] ** 2, atol=1e-5, rtol=0,
    )
    torch.testing.assert_close(
        fk.energies_exact_folded(pipeline, table, n_qubits),
        fk.energies_exact_folded_plain(pipeline, table, n_qubits),
        atol=1e-5 * float(table.abs().max()), rtol=0,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [7, 13, 14, 15, 20, 21, 22])
def test_fold_engine_tile_shapes(cuda_device, n_qubits):
    """Every tile shape of the fold circuit engine: the whole state in one
    tile (n <= 13), 1- and 2-bit tops (n=14, 15; one round), 7-, 8- and
    9-bit tops (n=20, 21, 22; two rounds).  Whole, prefix and suffix circuits (inactive groups, passes with
    nothing to do, one individual with no gate at all, which only the last
    pass fills), from |0...0> and from per-individual start states, with
    and without absorbed phases: states to 1e-5 against the plain version
    and equal bits on a repeat.  At n <= 20 the folded sweep, whose REST
    excludes the probed qubit, against its plain version (energies to
    1e-5 * max|table|)."""
    from queasars_tpu_torch.optim.prefix import prefix_mask
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline

    gt, ctrl, ang, mask = _genomes(n_qubits, 4, 3, n_qubits + 1, cuda_device)
    mask = mask.clone()
    mask[2] = False
    last = mask.sum(dim=1).clamp(min=1) - 1
    pmask = prefix_mask(mask, last)
    initial = fk.population_states_folded_plain(
        build_fold_pipeline(*_genomes(n_qubits, 1, 3, 2, cuda_device), n_qubits), n_qubits)
    for m in (mask, pmask, mask & ~pmask):
        for absorb in (True, False):
            pipeline = build_fold_pipeline(gt, ctrl, ang, m, n_qubits, absorb_diag=absorb)
            for start in (None, initial):
                states = fk.population_states_folded(pipeline, n_qubits, start)
                torch.testing.assert_close(
                    states, fk.population_states_folded_plain(pipeline, n_qubits, start),
                    atol=1e-5, rtol=0)
                assert torch.equal(states, fk.population_states_folded(pipeline, n_qubits, start))
    if n_qubits <= 20:
        table = torch.linspace(-5.0, 7.0, 1 << n_qubits, device=cuda_device).flip(0).contiguous()
        args = _fold_sweep_args(gt, ctrl, ang, mask, n_qubits, table, 9, 4)
        _, z = fk.nft_layer_sweep_folded(*args)
        _, z_plain = fk.nft_layer_sweep_folded_plain(*args)
        torch.testing.assert_close(z, z_plain, atol=1e-5 * 7.0, rtol=0)


def _swept_layer_args(gt, ctrl, ang, mask, layer, n, initial):
    """Both sweeps' arguments for layer ``layer`` of every individual from
    the states of the layers before it (started at ``initial``): the layer
    slices (a masked layer swept as gateless), free coordinates three per
    gated qubit, individual 1 inactive; returns (slot args, fold args,
    prefix, energies at given layer angles)."""
    from queasars_tpu_torch.sim import fold_kernels as fk

    device, pop = gt.device, gt.shape[0]
    before = torch.zeros_like(mask)
    before[:, :layer] = mask[:, :layer]
    prefix = sk.population_states(gt, ctrl, ang, before, n, initial)
    g1 = torch.where(mask[:, layer, None], gt[:, layer], torch.zeros_like(gt[:, layer]))
    g1 = g1.contiguous()
    c1, a1 = ctrl[:, layer].contiguous(), ang[:, layer].contiguous()
    coords = torch.zeros((pop, 3 * n, 2), dtype=torch.int32)
    n_free = torch.zeros(pop, dtype=torch.int32)
    for p, types in enumerate(g1.cpu().tolist()):
        flat = [(q, a) for q, t in enumerate(types) if t in (1, 3) for a in range(3)]
        if flat:
            coords[p, : len(flat)] = torch.tensor(flat, dtype=torch.int32)
        n_free[p] = len(flat)
    coords, n_free = coords.to(device), n_free.to(device)
    active = n_free > 0
    active[1] = False
    meta = [torch.as_tensor(m, device=device) for m in fk.fold_sweep_metadata(
        g1.cpu().numpy(), c1.cpu().numpy(), n)]
    one = torch.ones((pop, 1), dtype=torch.bool, device=device)

    def energies(layer_angles, table):
        return sk.energies_exact_plain(g1[:, None], c1[:, None], layer_angles[:, None], one,
                                       table, n, prefix)

    slot = (g1, c1, a1, coords, n_free, active, prefix)
    fold = (g1, a1, coords, n_free, active, prefix)
    return slot, fold, meta, energies


def _check_sweeps(slot, fold, meta, energies, table, n, maxiter, reset):
    """Rows 3 and 8 against their plain versions through plain energies, the
    recycled z against the energies at its angles, the inactive individual
    unmoved, equal bits on a repeat."""
    from queasars_tpu_torch.sim import fold_kernels as fk

    tol = 1e-5 * float(table.abs().max())
    runs = {
        "slot": (lambda: sk.nft_layer_sweep(*slot, table, n, maxiter, reset),
                 lambda: sk.nft_layer_sweep_plain(*slot, table, n, maxiter, reset)),
        "fold": (lambda: fk.nft_layer_sweep_folded(*fold, table, *meta, n, maxiter, reset),
                 lambda: fk.nft_layer_sweep_folded_plain(*fold, table, *meta, n, maxiter, reset)),
    }
    for name, (kernel, plain) in runs.items():
        a_k, z_k = kernel()
        a_p, _ = plain()
        e_k = energies(a_k, table)
        torch.testing.assert_close(z_k, e_k, atol=tol, rtol=0, msg=f"{name}: recycled z")
        torch.testing.assert_close(e_k, energies(a_p, table), atol=tol, rtol=0, msg=name)
        assert torch.equal(a_k[1], slot[2][1]), f"{name}: the inactive individual moved"
        a_again, z_again = kernel()
        assert torch.equal(a_k, a_again) and torch.equal(z_k, z_again), f"{name}: repeat"


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [9, 13, 14, 20])
def test_sweeps_match_plain_versions_on_every_control_class(cuda_device, n_qubits):
    """Rows 3 and 8 on every layer of ``slot_engine_genome`` (a CU3 in every
    control class: control among a pass's lane bits, its register bits or
    its unit bits, and every tile region of the engines' rebuilds, above
    and below the target), from per-individual start states, maxiter 13
    with reset_interval 5 (rebuilds at 0, 5 and 10, transitions between):
    energies at the returned angles to 1e-5 * max|table| of the plain
    versions', the recycled z likewise of the energies at its angles, the
    inactive individual unmoved and equal bits on a repeat."""
    from queasars_tpu_torch.interop import genome_tensors_from_numpy

    n = n_qubits
    genome, _ = slot_engine_genome(n, seed=n + 100)
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*genome, device=cuda_device)
    rng = np.random.default_rng(n)
    initial = rng.normal(size=(gt.shape[0], 2, 1 << n)).astype(np.float32)
    initial /= np.sqrt((initial**2).sum(axis=(1, 2), keepdims=True))
    initial = torch.from_numpy(initial).to(cuda_device)
    table = torch.from_numpy((rng.normal(size=1 << n) * 30).astype(np.float32)).to(cuda_device)
    for layer in range(gt.shape[1]):
        slot, fold, meta, energies = _swept_layer_args(gt, ctrl, ang, mask, layer, n, initial)
        _check_sweeps(slot, fold, meta, energies, table, n, 13, 5)


@pytest.mark.cuda
def test_sweeps_hold_the_drift_over_three_rebuild_intervals(cuda_device):
    """Rows 3 and 8 at n=20, maxiter 96 and reset_interval 32: BASE goes
    through 31 steps of transitions (undo and redo in float32) before each
    rebuild; energies and the recycled z as in the other sweep tests."""
    from queasars_tpu_torch.interop import genome_tensors_from_numpy

    n = 20
    genome, _ = slot_engine_genome(n, seed=7)
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*genome, device=cuda_device)
    rng = np.random.default_rng(n)
    table = torch.from_numpy((rng.normal(size=1 << n) * 30).astype(np.float32)).to(cuda_device)
    layer = int(((gt == 1) | (gt == 3)).sum(dim=(0, 2)).argmax())
    slot, fold, meta, energies = _swept_layer_args(gt, ctrl, ang, mask, layer, n, None)
    _check_sweeps(slot, fold, meta, energies, table, n, 96, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits,slot_passes,fold_passes", [(9, 1, 1), (20, 2, 4)])
def test_sweep_passes_follow_the_design_rule(cuda_device, n_qubits, slot_passes, fold_passes):
    """The profiler's count of passes over the state per sweep: on each
    rebuild step (k % reset_interval == 0) the route's engine builds BASE
    (the slot engine: one launch at n <= 13, two at n=20; the fold engine:
    one at n <= 13, two per kron layer above) and one sweep_pass sums it;
    then one sweep_pass per step with a transition and none on any other
    step."""
    from queasars_tpu_torch.interop import genome_tensors_from_numpy
    from queasars_tpu_torch.sim import fold_kernels as fk

    n, maxiter, reset = n_qubits, 30, 8
    genome, _ = slot_engine_genome(n, seed=3)
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*genome, device=cuda_device)
    table = torch.linspace(-5.0, 7.0, 1 << n, device=cuda_device).contiguous()
    slot, fold, meta, _ = _swept_layer_args(gt, ctrl, ang, mask, 0, n, None)
    flags = sk.sweep_transitions(*slot[3:6], n, maxiter)
    rebuilds = len(range(0, maxiter, reset))
    transitions = sum(int(flags[k]) for k in range(maxiter) if k % reset)
    assert transitions > 0
    runs = {
        ("slot_pass", slot_passes): lambda: sk.nft_layer_sweep(*slot, table, n, maxiter, reset),
        ("fold_pass", fold_passes): lambda: fk.nft_layer_sweep_folded(
            *fold, table, *meta, n, maxiter, reset),
    }
    for (engine, per_rebuild), run in runs.items():
        counts = _kernel_counts(run)
        launched, recorded = counts.get("cudaLaunchKernel", 0), _recorded(counts)
        assert launched > 0 and recorded == launched, (engine, launched, recorded)
        engine_launches = sum(c for k, c in counts.items() if engine in k)
        sweep_launches = sum(c for k, c in counts.items() if "sweep_pass" in k)
        assert engine_launches == per_rebuild * rebuilds, (engine, counts)
        assert sweep_launches == rebuilds + transitions, (engine, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [14, 15, 20, 21])
def test_grouped_rotations_equal_the_folded_sampler(cuda_device, n_qubits):
    """Row 11 against row 10 per group, bit for bit, for rotation layers on
    every qubit (H), on the lane group only, on the row group only, on the
    top group only (n > 14: the rotation's first pass with work is the top
    one, reading the circuit's planes out of place) and on none, from
    |0...0> and from per-individual start states."""
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim.fold_pipeline import (
        build_fold_pipeline,
        extend_fold_pipeline_with_rotation,
        rotation_layer_factors,
    )
    from queasars_tpu_torch.sim.statevector import GATE_ROT
    from queasars_tpu_torch.utils import prng

    genome = _genomes(n_qubits, 3, 3, n_qubits, cuda_device)
    pipeline = build_fold_pipeline(*genome, n_qubits, absorb_diag=True)
    initial = sk.population_states(*_genomes(n_qubits, 1, 3, 1, cuda_device), n_qubits)
    tops = [range(14, n_qubits)] if n_qubits > 14 else []
    spans = [range(n_qubits), range(7), range(7, 14), *tops, range(0)]
    rng = np.random.default_rng(n_qubits)
    rot_types = np.zeros((len(spans), n_qubits), np.int32)
    rot_angles = np.zeros((len(spans), n_qubits, 3), np.float32)
    rot_angles[0, :, 0], rot_angles[0, :, 2] = np.pi / 2, np.pi  # H on every qubit
    for g, span in enumerate(spans):
        rot_types[g, list(span)] = GATE_ROT
        if g > 0:
            rot_angles[g, list(span)] = rng.uniform(-np.pi, np.pi, (len(span), 3))
    rot_types = torch.from_numpy(rot_types).to(cuda_device)
    rot_angles = torch.from_numpy(rot_angles).to(cuda_device)
    factors, activity = rotation_layer_factors(rot_types, rot_angles, n_qubits)
    rotate = [len(span) > 0 for span in spans]
    assert activity.bool().any(dim=1).tolist() == rotate
    keys = prng.split(prng.PRNGKey(n_qubits + 1), 3)
    fracs = [prng.uniform(prng.fold_in(keys, g), (300,)).to(cuda_device) for g in range(len(spans))]
    for start in (None, initial):
        got = fk.grouped_shot_indices_folded(pipeline, factors, activity, fracs, n_qubits, start,
                                             rotate=rotate)
        for g in range(len(spans)):
            extended = extend_fold_pipeline_with_rotation(
                pipeline, rot_types[g], rot_angles[g], n_qubits)
            assert torch.equal(
                got[g], fk.sampled_shot_indices_folded(extended, fracs[g], n_qubits, start)), g


@pytest.mark.cuda
def test_threefry_on_the_card_matches_the_cpu(cuda_device):
    from queasars_tpu_torch.utils import prng

    for seed in (0, 7, 2**31 - 1):
        key = prng.PRNGKey(seed)
        keys = prng.split(prng.fold_in(key, 0x5EED), 16)
        on_card = prng.split(prng.fold_in(key.to(cuda_device), 0x5EED), 16)
        assert torch.equal(on_card.cpu(), keys)
        assert torch.equal(prng.uniform(on_card, (512,)).cpu(), prng.uniform(keys, (512,)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [14, 16, 21])
def test_sampler_epilogue_matches_its_plain_version_bit_for_bit(cuda_device, n_qubits):
    """On equal planes the CUDA epilogue and its plain version sum in one
    order, so every draw agrees exactly; repeats give equal bits."""
    from queasars_tpu_torch.utils import prng

    gen = torch.Generator(device="cpu").manual_seed(n_qubits)
    planes = torch.randn((3, 2, 1 << n_qubits), generator=gen) ** 3
    planes[1, :, : 1 << (n_qubits - 2)] = 0.0  # a quarter of the mass at zero
    planes /= planes.square().sum(dim=(1, 2), keepdim=True).sqrt()
    planes = planes.to(cuda_device)
    frac = prng.uniform(prng.split(prng.PRNGKey(n_qubits), 3), (700,)).to(cuda_device)
    sk.reset_launch_counts()
    idx = sk.sample_planes(planes, frac, n_qubits)
    assert torch.equal(idx, sk.sample_planes_plain(planes, frac, n_qubits))
    assert torch.equal(idx, sk.sample_planes(planes, frac, n_qubits))
    torch.cuda.synchronize()
    assert sk.launch_counts["sample_planes"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [14, 18])
def test_sampled_kernels_match_plain_versions(cuda_device, n_qubits):
    """Both sampled kernels against their plain versions and each other,
    from |0...0> and from per-individual start states: at least 99% of
    draws equal, every other draw a boundary draw (tolerance 1e-5 of the
    total mass), equal bits on a repeat."""
    import chip_smoke
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline
    from queasars_tpu_torch.utils import prng

    genome = _genomes(n_qubits, 3, 4, n_qubits, cuda_device)
    pipeline = build_fold_pipeline(*genome, n_qubits, absorb_diag=True)
    frac = prng.uniform(prng.split(prng.PRNGKey(5), 4), (512,)).to(cuda_device)
    initial = sk.population_states(*_genomes(n_qubits, 1, 4, 1, cuda_device), n_qubits)
    sk.reset_launch_counts()
    fk.reset_launch_counts()
    for start in (None, initial):
        probs = sk.population_probs_plain(*genome, n_qubits, start)
        slot = sk.sampled_shot_indices(*genome, frac, n_qubits, start)
        fold = fk.sampled_shot_indices_folded(pipeline, frac, n_qubits, start)
        assert torch.equal(slot, sk.sampled_shot_indices(*genome, frac, n_qubits, start))
        assert torch.equal(fold, fk.sampled_shot_indices_folded(pipeline, frac, n_qubits, start))
        for got, want in (
            (slot, sk.sampled_shot_indices_plain(*genome, frac, n_qubits, start)),
            (fold, fk.sampled_shot_indices_folded_plain(pipeline, frac, n_qubits, start)),
            (fold, slot),
        ):
            share, not_boundary = chip_smoke.draw_agreement(probs, frac, got, want)
            assert share >= 0.99 and not_boundary == 0, (share, not_boundary)
    torch.cuda.synchronize()
    assert sk.launch_counts["sampled_shot_indices"] == 4
    assert fk.launch_counts["sampled_shot_indices_folded"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [14, 18, 21])
def test_grouped_kernel_matches_plain_version_and_per_group_route(cuda_device, n_qubits):
    """The one-launch grouped sampler on TFIM (two groups, one of them
    unrotated) and the molecular-like operator, with equal and with
    proportional shots, from |0...0> and from per-individual start states:
    equal bits to the folded sampler once per group on the extended
    pipeline and on a repeat; against its plain version every differing
    draw a boundary draw, and at least 97.5% of draws equal up to n=20
    (95% at n=21, where a bin holds half the mass: 96.5% measured there
    on an H100); a single unrotated group equals the
    folded sampler itself."""
    import chip_smoke
    from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim.fold_pipeline import (
        build_fold_pipeline,
        extend_fold_pipeline_with_rotation,
    )
    from queasars_tpu_torch.sim.grouped_sampling import (
        allocate_shots,
        append_rotation_layer,
        grouped_operands,
        grouped_weights,
    )
    from queasars_tpu_torch.utils import prng

    genome = _genomes(n_qubits, 3, 3, n_qubits, cuda_device)
    pipeline = build_fold_pipeline(*genome, n_qubits, absorb_diag=True)
    initial = sk.population_states(*_genomes(n_qubits, 1, 3, 1, cuda_device), n_qubits)
    keys = prng.split(prng.PRNGKey(n_qubits), 3)
    bar = 0.975 if n_qubits <= 20 else 0.95
    operators = (transverse_field_ising(n_qubits, 1.0, 0.9),
                 chip_smoke.molecular_like(n_qubits, 24, 7))
    fk.reset_launch_counts()
    calls = 0
    for op, proportional in zip(operators, (False, True)):
        ops = grouped_operands(op, cuda_device)
        n_groups = ops.tables.shape[0]
        shots = allocate_shots(grouped_weights(op), 300 * n_groups) if proportional else (256,) * n_groups
        fracs = [prng.uniform(prng.fold_in(keys, g), (s,)).to(cuda_device)
                 for g, s in enumerate(shots)]
        for start in (None, initial):
            args = (pipeline, ops.rot_factors, ops.rot_active, fracs, n_qubits, start)
            got = fk.grouped_shot_indices_folded(*args, rotate=ops.rotate)
            again = fk.grouped_shot_indices_folded(*args)
            calls += 2
            plain = fk.grouped_shot_indices_folded_plain(*args)
            for g in range(n_groups):
                assert tuple(got[g].shape) == (3, shots[g])
                assert torch.equal(got[g], again[g])
                extended = extend_fold_pipeline_with_rotation(
                    pipeline, ops.rot_types[g], ops.rot_angles[g], n_qubits)
                assert torch.equal(
                    got[g], fk.sampled_shot_indices_folded(extended, fracs[g], n_qubits, start))
                ext = append_rotation_layer(*genome, ops.rot_types[g], ops.rot_angles[g])
                probs = sk.population_probs_plain(*ext, n_qubits, start)
                share, not_boundary = chip_smoke.draw_agreement(probs, fracs[g], got[g], plain[g])
                assert share >= bar and not_boundary == 0, (g, share, not_boundary)
    # one unrotated group: the folded sampler on the circuit itself
    ops = grouped_operands(operators[0], cuda_device)
    g = ops.rotate.index(False)
    frac = prng.uniform(keys, (200,)).to(cuda_device)
    single = fk.grouped_shot_indices_folded(
        pipeline, ops.rot_factors[g:g + 1].contiguous(), ops.rot_active[g:g + 1].contiguous(),
        [frac], n_qubits, initial)
    calls += 1
    assert torch.equal(single[0], fk.sampled_shot_indices_folded(pipeline, frac, n_qubits, initial))
    torch.cuda.synchronize()
    assert fk.launch_counts["grouped_shot_indices_folded"] == calls


#: every tile shape of the slot circuit engine (test_slot_engine_tile_shapes)
ENGINE_TILE_SHAPES = [3, 7, 12, 13, 14, 15, 18, 20, 21, 22]


def _compact_genomes(n_qubits, device):
    """Rows 12-13's genomes: a random packed one (a masked layer) and
    ``slot_engine_genome`` (a CU3 in every control class, a masked layer, an
    individual with no gate, all-low and all-high layers)."""
    from queasars_tpu_torch.interop import genome_tensors_from_numpy

    engine, _ = slot_engine_genome(n_qubits, seed=n_qubits)
    return (_genomes(n_qubits, 3, 4, n_qubits, device),
            genome_tensors_from_numpy(*engine, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", ENGINE_TILE_SHAPES)
def test_compact_kernels_match_plain_versions_and_the_slot_kernels(cuda_device, n_qubits):
    """Rows 12-13 at every tile shape of the engine they share with rows
    1-5: against their plain versions, and bit for bit equal to the slot
    kernels (rows 1 and 4) on the same genome and on a repeat."""
    from queasars_tpu_torch.sim import compact_kernels as ck

    gen = torch.Generator(device="cpu").manual_seed(n_qubits)
    table = (torch.randn(1 << n_qubits, generator=gen) * 30).to(cuda_device)
    for gt, ctrl, ang, mask in _compact_genomes(n_qubits, cuda_device):
        compact = ck.compact_gates(gt, ctrl, mask, n_qubits, device=cuda_device)
        assert compact.qubits.device.type == "cuda"
        ck.reset_launch_counts()
        probs = ck.compact_probs(compact, ang)
        energies = ck.compact_energies_exact(compact, ang, table)
        torch.cuda.synchronize()
        assert ck.launch_counts == {"compact_energies_exact": 1, "compact_probs": 1}
        plain_probs = ck.compact_probs_plain(compact, ang)
        # 1e-5 of the largest probability: the mean one is 2^-n
        torch.testing.assert_close(probs, plain_probs, atol=1e-5 * float(plain_probs.max()),
                                   rtol=0)
        tol = 1e-5 * float(table.abs().max())
        torch.testing.assert_close(
            energies, ck.compact_energies_exact_plain(compact, ang, table), atol=tol, rtol=0)
        assert torch.equal(probs, sk.population_probs(gt, ctrl, ang, mask, n_qubits))
        assert torch.equal(energies, sk.energies_exact(gt, ctrl, ang, mask, table, n_qubits))
        assert torch.equal(probs, ck.compact_probs(compact, ang))
        assert torch.equal(energies, ck.compact_energies_exact(compact, ang, table))


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [13, 20])
def test_compact_kernels_never_read_the_padding(cuda_device, n_qubits):
    """Entries past each individual's count, poisoned two ways -- made to
    look like real gates (an in-range qubit and control, the angle triple of
    the individual's first gate), and out of range (qubit, control and angle
    index past their ends) -- leave rows 12-13's bits unchanged."""
    from queasars_tpu_torch.sim import compact_kernels as ck

    n = n_qubits
    table = torch.linspace(-5.0, 7.0, 1 << n, device=cuda_device)
    for gt, ctrl, ang, mask in _compact_genomes(n, cuda_device):
        compact = ck.compact_gates(gt, ctrl, mask, n, bucket=32, device=cuda_device)
        counts = compact.boundaries[:, -1]
        pad = torch.arange(compact.max_gates, device=cuda_device)[None, :] >= counts[:, None]
        assert bool(pad.any())
        probs = ck.compact_probs(compact, ang)
        energies = ck.compact_energies_exact(compact, ang, table)
        first = compact.angle_index[:, :1]
        for qubit, control, index in ((3, 5, first), (n + 3, n + 5, 1 << 30)):
            poisoned = ck.CompactGates(
                torch.where(pad, qubit, compact.qubits), torch.where(pad, control, compact.controls),
                torch.where(pad, index, compact.angle_index), compact.boundaries, n,
                compact.n_layers, compact.max_count)
            assert torch.equal(ck.compact_probs(poisoned, ang), probs)
            assert torch.equal(ck.compact_energies_exact(poisoned, ang, table), energies)


def _kernel_counts(run):
    """Counts by name over one call of ``run``, from the profiler:
    ``cudaLaunchKernel`` (every launch, from the runtime API) and one entry
    per kernel name (its records).  The profiler has been seen to drop
    kernel records on this card, several traces in a row: the trace is
    taken up to three times, and the first complete one (one record per
    launch; every kernel in the window is the port's) is returned, else the
    last."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()}
        if 0 < counts.get("cudaLaunchKernel", 0) == _recorded(counts):
            break
    return counts


def _recorded(counts):
    return sum(c for k, c in counts.items() if "(anonymous namespace)::" in k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits,passes_per_layer", [(9, 0), (13, 0), (14, 2), (22, 2), (23, 3)])
def test_compact_kernels_launch_the_engine_per_layer_and_window(cuda_device, n_qubits,
                                                                passes_per_layer):
    """Rows 12-13's launches per call, read from the profiler: the slot
    engine's pass once for the whole circuit at n <= 13, once per layer and
    window above (two windows at n <= 22, three at n = 23), then the
    epilogue's kernels, and no other kernel (no per-gate pass)."""
    from queasars_tpu_torch.interop import genome_tensors_from_numpy
    from queasars_tpu_torch.sim import compact_kernels as ck

    n = n_qubits
    genome, _ = slot_engine_genome(n, seed=1)
    gt, ctrl, ang, mask = genome_tensors_from_numpy(*genome, device=cuda_device)
    compact = ck.compact_gates(gt, ctrl, mask, n, device=cuda_device)
    table = torch.linspace(-5.0, 7.0, 1 << n, device=cuda_device)
    engine = passes_per_layer * compact.n_layers or 1
    runs = {
        "probs": (lambda: ck.compact_probs(compact, ang), {"probabilities": 1}),
        "energies": (lambda: ck.compact_energies_exact(compact, ang, table),
                     {"energy_partials": 1, "energy_finish": 1}),
    }
    for label, (run, epilogue) in runs.items():
        counts = _kernel_counts(run)
        # the launches come from the runtime API, which drops nothing; the
        # kernel records (which may lose some) name what was launched
        assert counts["cudaLaunchKernel"] == engine + sum(epilogue.values()), (label, counts)
        kernels = {k: c for k, c in counts.items() if "(anonymous namespace)::" in k}
        wants = {"slot_pass<(anonymous namespace)::ListSource>": engine}
        wants.update({f"::{name}(": want for name, want in epilogue.items()})
        for key, count in kernels.items():
            matched = [part for part in wants if part in key]
            assert len(matched) == 1 and count <= wants[matched[0]], (label, kernels)
        if _recorded(counts) == counts["cudaLaunchKernel"]:  # a complete trace
            for part, want in wants.items():
                assert sum(c for k, c in kernels.items() if part in k) == want, (label, kernels)
    if n == 23:  # beyond the other tests' widths: against the slot kernel too
        assert torch.equal(ck.compact_probs(compact, ang), sk.population_probs(gt, ctrl, ang, mask, n))


def _diagonal_operator(n_qubits, terms, seed):
    from queasars_tpu_torch.paulis import PauliSum

    rng = np.random.default_rng(seed)
    labels = []
    for _ in range(terms):
        z = int(rng.integers(1, 1 << n_qubits))
        labels.append("".join("Z" if (z >> q) & 1 else "I" for q in range(n_qubits))[::-1])
    return PauliSum.sum([PauliSum.from_label(l, float(rng.normal())) for l in labels])


def _spsa_problem(n_qubits=14, pop=6, layers=3, seed=4):
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    return PackedPopulation.pack(list(population.individuals), min_layers=layers + 1)


def _recorded_directions(monkeypatch):
    from queasars_tpu_torch.optim import spsa

    recorded = []
    direction = spsa._Search.direction

    def spy(self, k):
        recorded.append(direction(self, k).cpu())
        return recorded[-1].to(self.coord_mask.device)

    monkeypatch.setattr(spsa._Search, "direction", spy)
    return recorded


def _spsa_run(device, path, monkeypatch):
    """One SPSA search of :func:`test_spsa_on_the_card_matches_the_cpu` on
    ``device``: (its result, the directions it drew, the calibration
    magnitudes of the first slot's coordinates, its evaluator)."""
    from queasars_tpu_torch.optim import BatchedSPSA, SPSAConfig
    from queasars_tpu_torch.optim.objective import objective_operands
    from queasars_tpu_torch.optim.spsa import _Search
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
    from queasars_tpu_torch.utils import prng

    packed = _spsa_problem()
    pop = packed.n_individuals
    real = packed.layer_mask.sum(axis=1)
    slots = 2
    coords = np.zeros((pop, slots, 3 * packed.n_qubits, 3), np.int32)
    n_free = np.zeros((pop, slots), np.int32)
    slot_layers = np.full((pop, slots), packed.max_layers, np.int32)
    for i in range(pop):
        for s in range(min(slots, real[i])):
            layer = real[i] - 1 - s
            c = packed.layer_param_coordinates(i, layer)
            coords[i, s, : len(c)], n_free[i, s], slot_layers[i, s] = c, len(c), layer
    recorded = _recorded_directions(monkeypatch)
    evaluator = StatevectorExpectationEvaluator(_diagonal_operator(14, 12, seed=5), device=device)
    spsa = BatchedSPSA(SPSAConfig(maxiter=6, learning_rate=0.1))
    if path == "slots":
        out = spsa.minimize_slots(evaluator, packed, coords, n_free, n_free > 0, slot_layers,
                                  seeds=np.array([3, 4]))
    else:
        last = (real - 1).astype(np.int32) if path == "prefix" else None
        out = spsa.minimize(evaluator, packed, coords[:, 0], n_free[:, 0], n_free[:, 0] > 0,
                            seed=3, last_layer=last)
    gt, ctrl, ang, lm = packed_tensors(packed, device=device)
    mask = torch.as_tensor(np.arange(coords.shape[2])[None, :] < n_free[:, 0, None],
                           dtype=torch.float32, device=device)
    search = _Search(objective_operands(evaluator), packed.n_qubits, (gt, ctrl, lm), None,
                     ang.shape, torch.as_tensor(coords[:, 0], dtype=torch.long, device=device),
                     mask, prng.split(prng.PRNGKey(3), pop))
    magnitude = search.calibrate(ang, SPSAConfig(calibration_steps=4)).cpu().numpy()
    monkeypatch.undo()
    return out, torch.stack(recorded), magnitude, evaluator, packed


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["full", "prefix", "slots"])
def test_spsa_on_the_card_matches_the_cpu(cuda_device, monkeypatch, path):
    """SPSA at n=14 on the card against the same search on the CPU (plain
    versions): the same directions, energies to 1e-5 * max|table|, and the
    calibration magnitudes to 1e-5 relative.  A fixed learning rate keeps
    the steps near 0.1 rad, where rounding differences do not grow."""
    card, card_dirs, card_mag, _, _ = _spsa_run("cuda", path, monkeypatch)
    cpu, cpu_dirs, cpu_mag, cpu_eval, packed = _spsa_run("cpu", path, monkeypatch)
    tol = 1e-5 * float(cpu_eval._table.abs().max())
    assert torch.equal(card_dirs, cpu_dirs) and card[2] == cpu[2]
    np.testing.assert_allclose(card_mag, cpu_mag, rtol=1e-5)
    np.testing.assert_allclose(card[1], cpu[1], atol=tol, rtol=0)
    np.testing.assert_allclose(cpu_eval.evaluate_packed(packed, angles=card[0]),
                               cpu_eval.evaluate_packed(packed, angles=cpu[0]), atol=tol, rtol=0)


@pytest.mark.cuda
def test_slot_loop_on_the_card_matches_the_cpu(cuda_device):
    """EVQEParameterSearch on a 12-qubit TFIM's exact objective (no fused
    route: the per-slot loop, five-point NFT) on the card against the CPU,
    as energies to 1e-4 * sum|c|, with equal evaluation counts."""
    from queasars_tpu_torch.evolve import EVQEParameterSearch
    from queasars_tpu_torch.evolve.base import OperatorContext
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    op = transverse_field_ising(12, coupling=1.0, field=0.9)
    results = []
    for device in ("cuda", "cpu"):
        counts = []
        evaluator = StatevectorExpectationEvaluator(op, device=device)
        context = OperatorContext(circuit_evaluator=evaluator, result_callback=lambda _: None,
                                  circuit_evaluation_count_callback=counts.append)
        population = EVQEPopulation.random_population(12, 3, 8, True, random_seed=6)
        search = EVQEParameterSearch(1.0, BatchedNFT(NFTConfig(maxiter=6, five_point=True)), None,
                                     random_seed=2)
        out = search.apply_operator(population, context)
        results.append((out, counts))
    cpu_eval = StatevectorExpectationEvaluator(op, device="cpu")
    (card, card_counts), (cpu, cpu_counts) = results
    assert card_counts == cpu_counts and card_counts[0] > 0
    np.testing.assert_allclose(
        cpu_eval.evaluate_individuals(list(card.individuals)),
        cpu_eval.evaluate_individuals(list(cpu.individuals)),
        atol=1e-4 * float(np.abs(op.coeffs).sum()), rtol=0,
    )


def _gradient_run(device, path):
    """One gradient search at n=14 (P=6) on ``device``: full circuits,
    the last-layer prefix path or the fused slot search; returns (result,
    evaluator, packed)."""
    from queasars_tpu_torch.optim import BatchedGradientDescent, GradientDescentConfig
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    packed = _spsa_problem()
    pop = packed.n_individuals
    real = packed.layer_mask.sum(axis=1)
    slots = 2
    coords = np.zeros((pop, slots, 3 * packed.n_qubits, 3), np.int32)
    n_free = np.zeros((pop, slots), np.int32)
    slot_layers = np.full((pop, slots), packed.max_layers, np.int32)
    for i in range(pop):
        for s in range(min(slots, real[i])):
            layer = real[i] - 1 - s
            c = packed.layer_param_coordinates(i, layer)
            coords[i, s, : len(c)], n_free[i, s], slot_layers[i, s] = c, len(c), layer
    evaluator = StatevectorExpectationEvaluator(_diagonal_operator(14, 12, seed=5), device=device)
    optimizer = BatchedGradientDescent(GradientDescentConfig(
        maxiter=6, learning_rate=0.05, cache_prefix=path != "full"))
    if path == "slots":
        out = optimizer.minimize_slots(evaluator, packed, coords, n_free, n_free > 0, slot_layers)
    else:
        last = (real - 1).astype(np.int32) if path == "prefix" else None
        out = optimizer.minimize(evaluator, packed, coords[:, 0], n_free[:, 0], n_free[:, 0] > 0,
                                 last_layer=last)
    return out, evaluator, packed


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["full", "prefix", "slots"])
def test_gradient_descent_on_the_card_matches_the_cpu(cuda_device, path):
    """The autograd objective on the card against the same search on the
    CPU at n=14: energies to 1e-5 * max|table|, also re-evaluated at both
    angle sets, equal evaluation counts."""
    card, _, packed = _gradient_run("cuda", path)
    cpu, cpu_eval, _ = _gradient_run("cpu", path)
    tol = 1e-5 * float(cpu_eval._table.abs().max())
    assert card[2] == cpu[2] == 12
    np.testing.assert_allclose(card[1], cpu[1], atol=tol, rtol=0)
    np.testing.assert_allclose(cpu_eval.evaluate_packed(packed, angles=card[0]),
                               cpu_eval.evaluate_packed(packed, angles=cpu[0]), atol=tol, rtol=0)


@pytest.mark.cuda
def test_qaoa_on_the_card_matches_the_cpu(cuda_device):
    """A 15-step QAOA solve at n=14 on the card against the CPU: the
    schedules to 1e-5, the energies to 1e-5 * max|table|, the same best
    bitstring."""
    from queasars_tpu_torch.solver import QAOAConfiguration, QAOAMinimumEigensolver

    op = _diagonal_operator(14, 12, seed=5)
    card, cpu = (QAOAMinimumEigensolver(QAOAConfiguration(
        n_starts=4, maxiter=15, device=device)).compute_minimum_eigenvalue(op)
        for device in ("cuda", "cpu"))
    scale = float(np.abs(op.coeffs).sum())
    np.testing.assert_allclose(card.start_energies, cpu.start_energies, atol=1e-5 * scale)
    np.testing.assert_allclose(card.optimal_gammas, cpu.optimal_gammas, rtol=1e-5)
    np.testing.assert_allclose(card.optimal_betas, cpu.optimal_betas, atol=1e-5)
    assert card.best_bitstring == cpu.best_bitstring
    np.testing.assert_allclose(card.optimal_state, cpu.optimal_state, atol=1e-5)


@pytest.mark.cuda
def test_adapt_vqe_on_the_card_matches_the_cpu(cuda_device):
    """ADAPT-VQE on a 12-qubit Pauli sum with random coefficients (so no
    two candidates tie, as a symmetric chain's would; linear pool, depth 3,
    20 steps) on the card against the CPU: the same picks, gradients to
    1e-5 relative, energies to 1e-5 * sum|c|."""
    from queasars_tpu_torch.paulis import PauliSum
    from queasars_tpu_torch.solver import AdaptVQEConfiguration, AdaptVQEMinimumEigensolver

    rng = np.random.default_rng(12)
    op = PauliSum.sum([PauliSum.from_label("".join(rng.choice(list("IXYZ"), 12)), float(c))
                       for c in rng.normal(size=20)])
    card, cpu = (AdaptVQEMinimumEigensolver(AdaptVQEConfiguration(
        max_depth=3, optimizer_maxiter=20, pool="linear", device=device)
    ).compute_minimum_eigenvalue(op) for device in ("cuda", "cpu"))
    tol = 1e-5 * float(np.abs(op.coeffs).sum())
    assert [r.candidate for r in card.iterations] == [r.candidate for r in cpu.iterations]
    for mine, theirs in zip(card.iterations, cpu.iterations):
        assert abs(mine.gradient - theirs.gradient) <= 1e-5 * abs(theirs.gradient)
        assert abs(mine.energy - theirs.energy) <= tol
    assert card.n_circuit_evaluations == cpu.n_circuit_evaluations


@pytest.mark.cuda
def test_autograd_gradients_on_the_card_match_float64(cuda_device):
    """At n=18 (P=8, a table of JSSP-like magnitude) both differentiable
    engines' float32 gradients lie within 1e-6 * max|table| of the slot
    engine's float64 gradient on the card; a fold applier whose factor
    gradients come from complex matmuls missed this by 300x at n=20."""
    from queasars_tpu_torch.sim.fold_pipeline import simulate_circuits_folded
    from queasars_tpu_torch.sim.statevector import _apply_slot, simulate_circuits

    n, pop = 18, 8
    packed = _spsa_problem(n_qubits=n, pop=pop)
    gt, ctrl, ang, lm = packed_tensors(packed, device="cuda")
    table = torch.as_tensor(np.random.default_rng(3).normal(size=1 << n) * 1e4,
                            dtype=torch.float32, device="cuda")

    def gradient(simulate, dtype):
        leaf = ang.to(dtype).clone().requires_grad_(True)
        if dtype == torch.float64:
            init = torch.zeros((pop, 2, 1 << n), dtype=dtype, device="cuda")
            init[:, 0, 0] = 1.0
            state = init
            for layer in range(packed.max_layers):
                for q in range(n):
                    state = _apply_slot(state, q, gt[:, layer, q], ctrl[:, layer, q],
                                        leaf[:, layer, q], lm[:, layer], n)
        else:
            state = simulate(gt, ctrl, leaf, lm, n)
        ((state[:, 0] ** 2 + state[:, 1] ** 2) * table.to(dtype)).sum().backward()
        return leaf.grad.double()

    exact = gradient(None, torch.float64)
    scale = float(table.abs().max())
    for simulate in (simulate_circuits, simulate_circuits_folded):
        assert float((gradient(simulate, torch.float32) - exact).abs().max()) <= 1e-6 * scale


def _resume_config(generations, **kwargs):
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import EVQEMinimumEigensolverConfiguration

    settings = dict(
        configured_estimator=None, configured_sampler=None, optimizer_n_circuit_evaluations=None,
        max_circuit_evaluations=None, termination_criterion=None, random_seed=1,
        population_size=8, speciation_genetic_distance_threshold=2, selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1, parameter_search_probability=0.3,
        topological_search_probability=0.4, layer_removal_probability=0.05,
        use_tournament_selection=True, tournament_size=2, pack_min_layers=4, device="cuda",
    )
    settings.update(kwargs)
    return EVQEMinimumEigensolverConfiguration(
        optimizer=BatchedNFT(NFTConfig(maxiter=6)), max_generations=generations, **settings)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["slot", "fold"])
@pytest.mark.parametrize("path", ["exact", "sampler"])
def test_resume_on_the_card_is_bit_identical(cuda_device, monkeypatch, tmp_path, route, path):
    """At n=14 (P=8, NFT maxiter 6) a solve checkpointed after generation 2
    and resumed to 3 equals the uninterrupted solve bit for bit on the
    card, on each route, exact and with a 128-shot sampler (the shot-key
    counter resumes the stream)."""
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        ConfiguredSampler,
        EVQEMinimumEigensolver,
    )

    if route == "slot":
        monkeypatch.setenv("QUEASARS_MXU", "0")
    else:
        monkeypatch.delenv("QUEASARS_MXU", raising=False)
    op = _diagonal_operator(14, 24, 5)
    kwargs = (dict(configured_estimator=ConfiguredEstimator()) if path == "exact" else
              dict(configured_sampler=ConfiguredSampler(shots=128, seed=3),
                   distribution_alpha_tail=0.5))
    checkpoint = str(tmp_path / "state.json")
    EVQEMinimumEigensolver(_resume_config(3, checkpoint_path=checkpoint, **kwargs)
                           ).compute_minimum_eigenvalue(op)
    resumed = EVQEMinimumEigensolver(_resume_config(
        4, resume_from_checkpoint=checkpoint, **kwargs)).compute_minimum_eigenvalue(op)
    again = EVQEMinimumEigensolver(_resume_config(4, **kwargs)).compute_minimum_eigenvalue(op)
    assert resumed.generations == again.generations == 4
    trajectory = [(g.expectation_values, g.best_expectation_value)
                  for g in resumed.population_evaluation_results]
    assert trajectory == [(g.expectation_values, g.best_expectation_value)
                          for g in again.population_evaluation_results]
    assert resumed.circuit_evaluations == again.circuit_evaluations
    assert resumed.eigenvalue == again.eigenvalue and resumed.eigenstate == again.eigenstate


@pytest.mark.cuda
def test_callback_energies_equal_the_internal_evaluator_on_the_card(cuda_device):
    """A callback that rebinds each circuit and returns the internal
    evaluator's energies on the card gives ``evaluate_packed``'s energies
    (n=14, P=8, 4 layers) to 1e-6 * max|table|."""
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
    from queasars_tpu_torch.sim.external import CallbackCircuitEvaluator

    op = _diagonal_operator(14, 24, 6)
    internal = StatevectorExpectationEvaluator(op, device="cuda")
    external = CallbackCircuitEvaluator(internal.evaluate_circuits, 14)
    population = EVQEPopulation.random_population(14, 4, 8, True, random_seed=4)
    packed = PackedPopulation.pack(list(population.individuals))
    want = internal.evaluate_packed(packed)
    got = external.evaluate_packed(packed)
    assert np.abs(got - want).max() <= 1e-6 * float(internal._table.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_bitstring_evaluator_on_the_card_equals_the_cpu(cuda_device, monkeypatch, alpha):
    """On the slot route the probabilities kernel's states equal the plain
    version's bits, but its squared magnitudes round differently (4.7e-10
    apart at n=20), so a draw on a bin boundary may flip: over successive
    calls (n=14, P=8, 256 shots, equal keys) at least 99% of the card's
    draws equal the CPU's, every other one a boundary draw; an individual
    whose draws all agree has the CPU's value exactly, another one within
    2 max|f| / (alpha shots) per flipped draw."""
    import chip_smoke
    from queasars_tpu_torch.sim.evaluators import BitstringFunctionEvaluator
    from queasars_tpu_torch.sim.sampling import sample_indices
    from queasars_tpu_torch.utils import BitstringEvaluator, prng

    monkeypatch.setenv("QUEASARS_MXU", "0")
    values = np.random.default_rng(8).normal(size=1 << 14)
    function = BitstringEvaluator(14, lambda bits: float(values[int(bits, 2)]))
    population = EVQEPopulation.random_population(14, 4, 8, True, random_seed=6)
    packed = PackedPopulation.pack(list(population.individuals))
    card, cpu = (BitstringFunctionEvaluator(function, 256, alpha, seed=2, device=device)
                 for device in ("cuda", "cpu"))
    probs, plain = card.probabilities(packed), cpu.probabilities(packed)
    for call in (1, 2, 3):
        keys = prng.split(prng.fold_in(prng.PRNGKey(2), call), packed.n_individuals)
        drawn, drawn_plain = (sample_indices(keys, p, 256).cpu() for p in (probs, plain))
        share, not_boundary = chip_smoke.draw_agreement(
            plain, prng.uniform(keys, (256,)), drawn, drawn_plain)
        assert share >= 0.99 and not_boundary == 0, (share, not_boundary)
        flips = (drawn != drawn_plain).sum(dim=1).numpy()
        got, want = card.evaluate_packed(packed), cpu.evaluate_packed(packed)
        assert card._counter == cpu._counter == call
        assert np.all(np.abs(got - want) <= flips * 2 * np.abs(values).max() / (alpha * 256))


def _mesh_solver(blocks, device, operator_kind):
    """An EVQE solve of 14 qubits over ``blocks`` blocks of the card, for
    the kinds of objective whose plain torch reductions a mesh runs."""
    from queasars_tpu_torch.optim import (
        BatchedGradientDescent,
        BatchedNFT,
        GradientDescentConfig,
        NFTConfig,
    )
    from queasars_tpu_torch.parallel import population_mesh
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    optimizer = {
        "general exact": BatchedNFT(NFTConfig(maxiter=6, five_point=True)),
        "grouped sampler": BatchedNFT(NFTConfig(maxiter=6, five_point=True)),
        "gradient": BatchedGradientDescent(GradientDescentConfig(maxiter=4)),
    }[operator_kind]
    sampler = operator_kind == "grouped sampler"
    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=None if sampler else ConfiguredEstimator(),
        configured_sampler=ConfiguredSampler(shots=256, seed=1) if sampler else None,
        optimizer=optimizer, optimizer_n_circuit_evaluations=None, max_generations=2,
        max_circuit_evaluations=None, termination_criterion=None, random_seed=4,
        population_size=10, speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
        parameter_search_probability=0.5, topological_search_probability=0.5,
        layer_removal_probability=0.1, use_tournament_selection=True, tournament_size=2,
        device=device, mesh=population_mesh(devices=[device] * blocks),
    ))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["general exact", "grouped sampler", "gradient"])
def test_mesh_solves_on_the_card_are_bit_identical_across_block_counts(cuda_device, kind):
    """The mesh's contract on the card where plain torch reductions carry
    the energies (the term scan, grouped shot means, autograd): 1 and 4
    blocks of one card give the same trajectory bit for bit (n=14)."""
    from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
    from queasars_tpu_torch.problems.spin_chains import transverse_field_ising

    n = 14
    if kind == "gradient":
        operator = PauliSum.sum([pauli_z_string(q, n) * float(q + 1) for q in range(n)])
    else:
        operator = transverse_field_ising(n, coupling=1.0, field=0.9)
    results = [_mesh_solver(blocks, f"{cuda_device.type}:0", kind)
               .compute_minimum_eigenvalue(operator) for blocks in (1, 4)]
    one, four = ([list(g.expectation_values) for g in r.population_evaluation_results]
                 for r in results)
    assert one == four
    assert results[0].eigenvalue == results[1].eigenvalue
    assert results[0].best_individual == results[1].best_individual


@pytest.mark.cuda
def test_exact_cvar_on_the_card_is_bit_identical_across_block_counts(cuda_device):
    from queasars_tpu_torch.parallel import population_mesh
    from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    n = 14
    operator = PauliSum.sum([pauli_z_string(q, n) * float(q % 3 + 1) for q in range(n)])
    population = EVQEPopulation.random_population(n, 3, 12, True, random_seed=5)
    packed = PackedPopulation.pack(list(population.individuals))
    got = []
    for blocks in (1, 4):
        evaluator = StatevectorExpectationEvaluator(operator, alpha=0.5, device=cuda_device)
        evaluator.set_mesh(population_mesh(devices=["cuda:0"] * blocks))
        got.append(evaluator.evaluate_packed(packed))
    np.testing.assert_array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# amplitude sharding (csrc/shard_kernels.cu)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [14, 21, 22])
def test_shard_pair_combine_equals_its_plain_version(cuda_device, n_qubits):
    """The pair kernel (row S1) on a 1x4 shard of an n-qubit state, local
    targets (low, high, with a local control) and a global target, against
    its plain version on the same card inputs: equal bits."""
    from queasars_tpu_torch.sim import shard_kernels as shk
    from queasars_tpu_torch.sim.sharded_statevector import slot_entries

    gen = torch.Generator().manual_seed(n_qubits)
    rows, lb = 6, n_qubits - 2
    state = torch.randn((rows, 2, 1 << lb), generator=gen).to(cuda_device)
    partner = torch.randn((rows, 2, 1 << lb), generator=gen).to(cuda_device)
    entries = slot_entries(torch.rand((rows, 3), generator=gen).to(cuda_device) * 6)
    ctrl = torch.tensor([-1, 0, 3, lb - 1, -1, 2], dtype=torch.int32, device=cuda_device)
    enabled = torch.tensor([True] * 5 + [False], device=cuda_device)
    for target, other in ((1, None), (lb - 1, None), (-1, partner)):
        control = torch.where(ctrl == target, torch.full_like(ctrl, -1), ctrl)
        for side in ((0, 1) if target < 0 else (0,)):
            got = shk.pair_combine(state, other, entries, control, enabled, lb, target, side)
            want = shk.pair_combine_plain(state, other, entries, control, enabled, lb, target,
                                          side)
            assert torch.equal(got, want), (target, side)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fold", "per-gate"])
def test_shard_energies_on_the_card_are_bit_identical_across_amp_widths(cuda_device, route):
    """Exact energies at n=14 on 1, 2 and 4 amplitude cells of one card and
    on 2 x 2: equal bits (the group products of the fold route included),
    and within 1e-5 * max|table| of row 1 unsharded."""
    from queasars_tpu_torch.parallel.amplitude import pop_amp_mesh
    from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
    from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator

    n = 14
    operator = PauliSum.sum([pauli_z_string(q, n) @ pauli_z_string((q + 3) % n, n)
                             * float(q % 4 - 1.5) for q in range(n)])
    population = EVQEPopulation.random_population(n, 4, 10, True, random_seed=2)
    packed = PackedPopulation.pack(list(population.individuals))
    got = {}
    for shape in ((1, 1), (1, 2), (1, 4), (2, 2)):
        evaluator = AmplitudeShardedExpectationEvaluator(
            operator, pop_amp_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1])),
            use_fold=route == "fold")
        got[shape] = evaluator.evaluate_packed(packed)
    for value in got.values():
        np.testing.assert_array_equal(value, got[(1, 1)])
    table = evaluator._table.full().to(cuda_device)
    want = sk.energies_exact(*packed_tensors(packed, device=cuda_device), table, n)
    np.testing.assert_allclose(got[(1, 1)], want.cpu().numpy(),
                               atol=1e-5 * float(table.abs().max()))


@pytest.mark.cuda
def test_sharded_solve_on_the_card_is_bit_identical_on_1x4_and_2x2(cuda_device):
    """A seeded EVQE solve (n=14, exact, fold route, NFT last-layer and slot
    sweeps) on four cells of one card: 1 x 4 and 2 x 2 give the same
    trajectory bit for bit."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.parallel import population_mesh
    from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    n = 14
    operator = PauliSum.sum([pauli_z_string(q, n) * float(q + 1) for q in range(n)])
    runs = []
    for amp in (4, 2):
        result = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
            configured_estimator=ConfiguredEstimator(), configured_sampler=None,
            optimizer=BatchedNFT(NFTConfig(maxiter=6)), optimizer_n_circuit_evaluations=None,
            max_generations=2, max_circuit_evaluations=None, termination_criterion=None,
            random_seed=4, population_size=8, speciation_genetic_distance_threshold=2,
            selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
            parameter_search_probability=0.5, topological_search_probability=0.5,
            layer_removal_probability=0.1, use_tournament_selection=True, tournament_size=2,
            device=cuda_device, mesh=population_mesh(devices=["cuda:0"] * 4),
            shard_amplitudes=True, amp_devices=amp,
        )).compute_minimum_eigenvalue(operator)
        runs.append(([list(g.expectation_values) for g in result.population_evaluation_results],
                     result.eigenvalue, repr(result.best_individual)))
    assert runs[0] == runs[1]


def _matmul_group_product(state, dense, local_bits, q0, m):
    """S2's function by one complex ``torch.matmul`` per shard with the dense
    Kronecker matrix (``dense`` [B, 2, d, d]; the group vectors as the
    columns of [B, d, instances]), in S2's layout."""
    rows, d = state.shape[0], 1 << m
    x = torch.complex(state[:, 0], state[:, 1]).reshape(
        rows, (1 << local_bits) >> (q0 + m), d, 1 << q0)
    columns = x.transpose(1, 2).reshape(rows, d, -1)
    out = torch.matmul(torch.complex(dense[:, 0], dense[:, 1]), columns)
    out = out.reshape(rows, d, -1, 1 << q0).transpose(1, 2)
    return torch.stack([out.real, out.imag], dim=1).reshape(state.shape)


def _unitary_factors(gen, rows, n):
    """[rows, n, 2 (re/im), 2, 2] float32 per-qubit unitaries (QR of complex
    normal matrices)."""
    z = torch.complex(torch.randn((rows, n, 2, 2), generator=gen, dtype=torch.float64),
                      torch.randn((rows, n, 2, 2), generator=gen, dtype=torch.float64))
    q, r = torch.linalg.qr(z)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    u = q * (d / d.abs())[..., None, :]
    return torch.stack([u.real, u.imag], dim=2).float()


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [14, 22])
def test_shard_group_product_bits_across_shard_widths(cuda_device, n_qubits):
    """The fold route's group product (m = 7, random per-qubit unitaries) on
    P=8 n-qubit states cut as the 1x1, 1x2, 1x4 and 2x2 meshes cut them:
    S2's bits never change and equal its plain version's.  ``torch.matmul``
    (complex64, TF32 off) with the dense Kronecker matrix of the same
    factors lies within 1e-5 of S2 and, on the H100 with PyTorch 2.11 /
    CUDA 12.8, keeps its bits too; this test is where a change of that
    shows."""
    from queasars_tpu_torch.sim import shard_kernels as shk
    from queasars_tpu_torch.sim.sharded_fold import factor_entries, group_fold_dense

    gen = torch.Generator().manual_seed(n_qubits)
    rows, q0, m = 8, min(7, n_qubits - 9), 7
    state = torch.randn((rows, 2, 1 << n_qubits), generator=gen).to(cuda_device)
    factors = _unitary_factors(gen, rows, q0 + m).to(cuda_device)
    entries = factor_entries(factors[:, q0:]).contiguous()
    dense = torch.stack(group_fold_dense(factors, q0, m), dim=1)
    tf32, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    results = {}
    try:
        for n_pop, n_amp in ((1, 1), (1, 2), (1, 4), (2, 2)):
            lb = n_qubits - n_amp.bit_length() + 1
            for label, product, operand in (("S2", shk.group_product, entries),
                                            ("matmul", _matmul_group_product, dense)):
                results[(label, n_pop, n_amp)] = torch.cat([
                    torch.cat([product(s.contiguous(), u, lb, q0, m)
                               for s in block.chunk(n_amp, dim=2)], dim=2)
                    for block, u in zip(state.chunk(n_pop), operand.chunk(n_pop))])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
    gaps = {key: float((value - results[(key[0], 1, 1)]).abs().max())
            for key, value in results.items()}
    print(f"n={n_qubits}: largest gap from 1x1 {gaps}")
    assert torch.equal(results[("S2", 1, 1)],
                       shk.group_product_plain(state, entries, n_qubits, q0, m))
    assert all(gap == 0.0 for (label, *_), gap in gaps.items() if label == "S2")
    assert float((results[("matmul", 1, 1)] - results[("S2", 1, 1)]).abs().max()) <= 1e-5
    assert all(gap == 0.0 for (label, *_), gap in gaps.items() if label == "matmul")


@pytest.mark.cuda
@pytest.mark.parametrize("local_bits", [5, 6, 7, 8, 13, 14])
def test_shard_group_product_equals_its_plain_version_at_every_tile_width(cuda_device,
                                                                          local_bits):
    """S2 on shards of 2^local_bits amplitudes against its plain version (m
    pair combines) on the same card inputs, for every group that fits: equal
    bits.  Below 2^10 a tile has fewer threads than a group of 7 has qubits;
    at 2^14 a group above bit 6 leaves the contiguous tile."""
    from queasars_tpu_torch.sim import shard_kernels as shk
    from queasars_tpu_torch.sim.sharded_fold import factor_entries

    gen = torch.Generator().manual_seed(local_bits)
    rows = 6
    state = torch.randn((rows, 2, 1 << local_bits), generator=gen).to(cuda_device)
    factors = _unitary_factors(gen, rows, local_bits).to(cuda_device)
    groups = [(0, 7), (7, 7), (7, 3), (5, 7), (0, 5), (2, 4), (0, 1), (local_bits - 1, 1)]
    checked = 0
    for q0, m in groups:
        if q0 + m > local_bits:
            continue
        entries = factor_entries(factors[:, q0:q0 + m]).contiguous()
        got = shk.group_product(state, entries, local_bits, q0, m)
        assert torch.equal(got, shk.group_product_plain(state, entries, local_bits, q0, m)), (
            q0, m)
        checked += 1
    assert checked >= 3


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "shapes"), [(9, ((1, 4),)), (10, ((1, 8), (2, 4))),
                                           (12, ((1, 8),))])
def test_fold_energies_on_small_shards_of_the_card_equal_the_whole_state(cuda_device, n,
                                                                         shapes):
    """The fold route's exact energies on narrow shards of one card (2^7 to
    2^9 amplitudes, where S2's tiles have 4 to 16 threads) equal the 1 x 1
    mesh's bit for bit and lie within 1e-5 * max|table| of row 1
    unsharded."""
    from queasars_tpu_torch.parallel.amplitude import pop_amp_mesh
    from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
    from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator

    operator = PauliSum.sum([pauli_z_string(q, n) @ pauli_z_string((q + 3) % n, n)
                             * float(q % 4 - 1.5) for q in range(n)])
    population = EVQEPopulation.random_population(n, 4, 8, True, random_seed=n)
    packed = PackedPopulation.pack(list(population.individuals))
    got = {}
    for shape in ((1, 1),) + shapes:
        evaluator = AmplitudeShardedExpectationEvaluator(
            operator, pop_amp_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1])),
            use_fold=True)
        got[shape] = evaluator.evaluate_packed(packed)
    for shape, value in got.items():
        np.testing.assert_array_equal(value, got[(1, 1)], err_msg=str(shape))
    table = evaluator._table.full().to(cuda_device)
    want = sk.energies_exact(*packed_tensors(packed, device=cuda_device), table, n)
    np.testing.assert_allclose(got[(1, 1)], want.cpu().numpy(),
                               atol=1e-5 * float(table.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("seg_len", [1, 16, 64, 1024, 4096])
def test_shard_running_sum_equals_its_plain_version(cuda_device, seg_len):
    """The running-sum kernel (row S4) on 3 x 4096 probabilities cut into
    segments of seg_len, then on each row's segment totals (the blocked
    sampler's gathered block masses), against its plain version (XLA's CPU
    order) on the card: equal bits."""
    from queasars_tpu_torch.sim import shard_kernels as shk
    from queasars_tpu_torch.sim.sampling import running_sum

    gen = torch.Generator().manual_seed(seg_len)
    values = (torch.randn((3, 4096), generator=gen) ** 2).to(cuda_device)
    got = shk.running_sum(values, seg_len)
    assert torch.equal(got, running_sum(values.reshape(-1, seg_len)).reshape(values.shape))
    masses = got.reshape(3, -1, seg_len)[..., -1].contiguous()
    assert torch.equal(shk.running_sum(masses, masses.shape[-1]), running_sum(masses))


@pytest.mark.cuda
def test_traced_solve_starts_each_slot_kernel_after_an_evaluator_span(
    cuda_device, tmp_path, monkeypatch
):
    """``utils/profiling.trace`` around a 14-qubit slot-route EVQE solve
    writes the port's spans and the card's kernels on one clock, with no
    host operator events: every slot kernel starts after the start of some
    ``evaluator.*`` span and before the solve span ends (its last wait
    drains the card), and the kernels of the slot engine all appear."""
    import glob
    import json
    import os

    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
    from queasars_tpu_torch.problems.jssp.random_instances import (
        random_job_shop_scheduling_instance,
    )
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )
    from queasars_tpu_torch.utils.profiling import trace

    monkeypatch.setenv("QUEASARS_MXU", "0")
    instance = random_job_shop_scheduling_instance(
        "t14", n_jobs=3, n_machines=2, relative_op_amount=0.5, op_duration={1: 0.5, 2: 0.5},
        random_seed=0,
    )
    hamiltonian = JSSPDomainWallHamiltonianEncoder(
        instance, makespan_limit=6).get_problem_hamiltonian()
    assert hamiltonian.n_qubits == 14

    def solve():
        return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
            configured_estimator=ConfiguredEstimator(), configured_sampler=None,
            optimizer=BatchedNFT(NFTConfig(maxiter=8)), optimizer_n_circuit_evaluations=None,
            max_generations=2, max_circuit_evaluations=None, termination_criterion=None,
            random_seed=3, population_size=8, speciation_genetic_distance_threshold=2,
            selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
            parameter_search_probability=0.5, topological_search_probability=0.5,
            layer_removal_probability=0.1, pack_min_layers=4,
        )).compute_minimum_eigenvalue(hamiltonian)

    solve()
    with trace(str(tmp_path), label="t14"):
        solve()
    (path,) = glob.glob(os.path.join(str(tmp_path), "t14.*.pt.trace.json"))
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "program"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and any(k in e["name"] for k in ("slot_pass", "energy_partials", "sweep_pass"))]
    assert {e.get("cat") for e in events} <= {"program", "kernel", "gpu_memcpy", "gpu_memset"}
    solve_span, = [e for e in spans if e["name"] == "solve"]
    starts = sorted(e["ts"] for e in spans if e["name"].startswith("evaluator."))
    names = {e["name"] for e in spans}
    assert {"evaluator.population_energies", "evaluator.nft_layer_sweep_launch",
            "wait.sweep_transitions", "nft.step", "eigenstate"} <= names
    assert {k for k in ("slot_pass", "energy_partials", "sweep_pass")
            if any(k in e["name"] for e in kernels)} == {"slot_pass", "energy_partials",
                                                          "sweep_pass"}
    for kernel in kernels:
        assert starts[0] <= kernel["ts"] <= solve_span["ts"] + solve_span["dur"], kernel["name"]


def _nft_step_problem():
    """n=14, P=6, two slots (the last two real layers): individual 0 sits
    out (inactive), individual 1 is active with no free coordinate in slot
    0, and some free counts do not divide 40."""
    packed = _spsa_problem()
    pop = packed.n_individuals
    real = packed.layer_mask.sum(axis=1)
    slots = 2
    coords = np.zeros((pop, slots, 3 * packed.n_qubits, 3), np.int32)
    n_free = np.zeros((pop, slots), np.int32)
    slot_layers = np.full((pop, slots), packed.max_layers, np.int32)
    for i in range(pop):
        for s in range(min(slots, real[i])):
            layer = real[i] - 1 - s
            c = packed.layer_param_coordinates(i, layer)
            coords[i, s, : len(c)], n_free[i, s], slot_layers[i, s] = c, len(c), layer
    n_free[1, 0] = 0
    active = np.ones((pop, slots), bool)
    active[0] = False
    assert any(40 % f for f in n_free[2:, 0])
    return packed, coords, n_free, active, slot_layers, real


def _nft_search(path):
    """One NFT search (maxiter 40, reset at 32) on the card on the slot
    route: ``minimize_slots``, ``minimize`` with ``last_layer`` (the prefix
    transform's steps) or without it (full circuits)."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    packed, coords, n_free, active, slot_layers, real = _nft_step_problem()
    evaluator = StatevectorExpectationEvaluator(_diagonal_operator(14, 12, seed=5), device="cuda")
    optimizer = BatchedNFT(NFTConfig(maxiter=40, reset_interval=32, in_kernel_sweep=False))
    if path == "slots":
        return optimizer.minimize_slots(evaluator, packed, coords, n_free, active, slot_layers)
    last = (real - 1).astype(np.int32) if path == "prefix" else None
    return optimizer.minimize(evaluator, packed, coords[:, 0], n_free[:, 0], active[:, 0],
                              last_layer=last)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["slots", "prefix", "full"])
def test_nft_searches_on_the_card_take_the_step_kernel_with_the_loops_bits(
    cuda_device, path, monkeypatch
):
    """Each caller of ``_nft_steps`` on the card launches the step kernel
    maxiter + 1 times a call, and its angles and energies equal those of
    the PyTorch step loop run on the card, bit for bit."""
    from queasars_tpu_torch.optim import nft

    monkeypatch.setenv("QUEASARS_MXU", "0")
    sk.reset_launch_counts()
    kernel = _nft_search(path)
    calls = 2 if path == "slots" else 1
    assert sk.launch_counts["nft_step"] == calls * 41
    monkeypatch.setattr(nft, "_nft_steps", nft._nft_steps_torch)
    sk.reset_launch_counts()
    loop = _nft_search(path)
    assert sk.launch_counts["nft_step"] == 0
    packed = _nft_step_problem()[0]
    assert np.array_equal(kernel[0], loop[0]) and np.array_equal(kernel[1], loop[1])
    assert kernel[2] == loop[2]
    assert np.array_equal(kernel[0][0], packed.angles[0])
    assert not np.array_equal(kernel[0][2:], packed.angles[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["slot", "fold"])
@pytest.mark.parametrize("maxiter, reset", [(40, 32), (7, 3), (1, 1)])
def test_nft_step_kernel_equals_the_pytorch_loop_bit_for_bit(
    cuda_device, route, maxiter, reset, monkeypatch
):
    """``_nft_steps`` on the card (the step kernel) against
    ``_nft_steps_torch`` on the card over full-circuit energies at n=14:
    equal angles and z0, maxiter + 1 launches, the inactive individual and
    the one without a free coordinate unmoved."""
    from queasars_tpu_torch.optim import BatchedNFT, nft
    from queasars_tpu_torch.optim.objective import objective_operands
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    monkeypatch.setenv("QUEASARS_MXU", "0" if route == "slot" else "1")
    packed, coords, n_free, active, _, _ = _nft_step_problem()
    evaluator = StatevectorExpectationEvaluator(_diagonal_operator(14, 12, seed=5), device="cuda")
    gt, ctrl, ang, lm = packed_tensors(packed, device="cuda")
    objective = BatchedNFT()._objective(objective_operands(evaluator), 14, gt, ctrl, lm, None)
    args = (torch.as_tensor(coords[:, 0], dtype=torch.long, device="cuda"),
            torch.as_tensor(n_free[:, 0], device="cuda"),
            torch.as_tensor(active[:, 0], device="cuda"), maxiter, reset)
    sk.reset_launch_counts()
    angles, z0 = nft._nft_steps(objective, ang, *args)
    assert sk.launch_counts["nft_step"] == maxiter + 1
    ref_angles, ref_z0 = nft._nft_steps_torch(objective, ang, *args)
    assert torch.equal(angles, ref_angles) and torch.equal(z0, ref_z0)
    assert torch.equal(angles[:2], ang[:2]) and not torch.equal(angles[2:], ang[2:])


@pytest.mark.cuda
def test_nft_step_kernel_runs_on_the_angles_card_whichever_card_is_current(cuda_device):
    """Angles on the last card while the first is current (the same card on
    a one-card machine): the step kernel launches on the angles' card and
    stream, after the objective's work there, and keeps the PyTorch loop's
    bits."""
    from queasars_tpu_torch.optim import nft

    card = torch.device("cuda", torch.cuda.device_count() - 1)
    packed, coords, n_free, active, _, _ = _nft_step_problem()
    ang = torch.as_tensor(packed.angles, device=card)
    weights = torch.linspace(0.5, 1.5, ang[0].numel(), device=card).reshape(ang.shape[1:])

    def objective(a, keys):
        return (torch.cos(a) * weights).sum(dim=(1, 2, 3)) + torch.sin(2 * a).mean(dim=(1, 2, 3))

    args = (torch.as_tensor(coords[:, 0], dtype=torch.long, device=card),
            torch.as_tensor(n_free[:, 0], device=card),
            torch.as_tensor(active[:, 0], device=card), 40, 32)
    with torch.cuda.device(0):
        sk.reset_launch_counts()
        angles, z0 = nft._nft_steps(objective, ang, *args)
        assert sk.launch_counts["nft_step"] == 41
        ref_angles, ref_z0 = nft._nft_steps_torch(objective, ang, *args)
    assert angles.device == card and z0.device == card
    assert torch.equal(angles, ref_angles) and torch.equal(z0, ref_z0)
    assert torch.equal(angles[:2], ang[:2]) and not torch.equal(angles[2:], ang[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["slots", "full"])
def test_sharded_nft_search_over_the_cards_equals_one_card(cuda_device, path):
    """The sharded evaluator's NFT searches (``nft_minimize_slots`` and
    ``nft_minimize``' full-circuit steps) on a 2 x 2 mesh over the machine's
    cards, where row 1's home is not the current card, equal the same
    mesh's on one card bit for bit."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.parallel.amplitude import pop_amp_mesh
    from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator

    packed, coords, n_free, active, slot_layers, _ = _nft_step_problem()
    operator = _diagonal_operator(14, 12, seed=5)
    optimizer = BatchedNFT(NFTConfig(maxiter=40, reset_interval=32))
    cards = torch.cuda.device_count()
    results = []
    for devices in (["cuda:0"] * 4, [f"cuda:{i % cards}" for i in range(4)]):
        evaluator = AmplitudeShardedExpectationEvaluator(operator, pop_amp_mesh(2, 2, devices))
        sk.reset_launch_counts()
        if path == "slots":
            results.append(optimizer.minimize_slots(evaluator, packed, coords, n_free, active,
                                                    slot_layers))
        else:
            results.append(optimizer.minimize(evaluator, packed, coords[:, 0], n_free[:, 0],
                                              active[:, 0]))
        assert sk.launch_counts["nft_step"] == (2 if path == "slots" else 1) * 2 * 41
    one, spread = results
    assert np.array_equal(one[0], spread[0]) and np.array_equal(one[1], spread[1])
    assert one[2] == spread[2]
