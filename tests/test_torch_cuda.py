"""The CUDA kernels: their C binding (checked here) and, on a card, each
kernel against its plain version.

Tests marked ``cuda`` need an NVIDIA GPU; they decide inside the test (the
``cuda_device`` fixture) and skip without one.  Run them on a card with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.  Tolerances as on
the main path: probabilities and amplitudes 1e-5, energies
1e-5 * max|table|.
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
