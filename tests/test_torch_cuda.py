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
                                "nft_layer_sweep_folded": 1, "population_probs_folded": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits", [8, 9, 11, 12, 13, 15, 16, 19, 21, 22])
def test_fold_circuit_kernels_at_every_group_width(cuda_device, n_qubits):
    """Every group width the group kernel is built for: row groups of 1-6
    bits (n=8..13), top groups of 1, 2, 5 and 7 bits (n=15, 16, 19, 21),
    and the 8-bit top group of n=22, applied as two 4-bit sub-kron factors
    (no phase is absorbed into it at that size)."""
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
