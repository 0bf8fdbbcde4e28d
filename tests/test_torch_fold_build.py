"""The fold pipeline's build kernel (``csrc/fold_build.cu``) and the dispatch
in ``build_fold_pipeline`` that picks it.

CPU tests: which builds take the kernel (card tensors that want no gradient)
and how they are counted, the wrapper's refusals, and that the fold kernels'
launch rows leave the build out.  Tests marked ``cuda`` hold the kernel
against ``build_fold_pipeline_plain`` on the card: integer fields equal,
float fields within 2 float32 ulps (both compute each operation rounded on
its own with the same functions, so the aim is equal bits).  Run them on a
card with ``python -m pytest --noconftest tests/test_torch_fold_build.py -m
cuda``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from queasars_tpu_torch.sim import fold_kernels
from queasars_tpu_torch.sim import fold_pipeline as fp
from queasars_tpu_torch.sim.statevector import GATE_CROT, GATE_CTRL, GATE_ID, GATE_ROT
from queasars_tpu_torch.utils import profiling
from queasars_tpu_torch.utils.profiling import recording

INTEGER_FIELDS = ("diag_ctrl", "diag_tgt", "diag_count", "group_active", "abs_ctrl", "abs_tgt",
                  "abs_count")
FLOAT_FIELDS = ("factors", "diag_phase", "abs_phase")


def genome(n_qubits, layers, pop, seed, device="cpu"):
    """Seeded [P, L, n] genomes: in layer 0 of individual 0 every axis group
    of six qubits or more holds an identity, a ROT at zero angles, a CU3 at zero angles (as freshly
    grown) with its control in the group, and a random CU3; elsewhere random
    CU3s (control in any group), ROTs and identities, a fifth of the angles
    zero, and a fifth of the layers masked off."""
    rng = np.random.default_rng(seed)
    gate_types = np.zeros((pop, layers, n_qubits), np.int32)
    controls = np.full((pop, layers, n_qubits), -1, np.int32)
    angles = rng.uniform(-np.pi, np.pi, (pop, layers, n_qubits, 3)).astype(np.float32)

    def crot(p, layer, control, target, zero):
        gate_types[p, layer, target], gate_types[p, layer, control] = GATE_CROT, GATE_CTRL
        controls[p, layer, target] = control
        if zero:
            angles[p, layer, target] = 0.0

    for p in range(pop):
        for layer in range(layers):
            order = rng.permutation(n_qubits)
            if p == 0 and layer == 0:
                lows = [lo for lo, m in fp.group_bounds(n_qubits) if m >= 6]
                for lo in lows:
                    gate_types[0, 0, lo + 1] = GATE_ROT
                    angles[0, 0, lo + 1] = 0.0
                    crot(0, 0, lo + 2, lo + 3, zero=True)
                    crot(0, 0, lo + 5, lo + 4, zero=False)
                free = [q for q in order if gate_types[0, 0, q] == GATE_ID and
                        all(q not in (lo, lo + 1, lo + 2, lo + 3, lo + 4, lo + 5) for lo in lows)]
            else:
                pairs = int(rng.integers(0, n_qubits // 2 + 1))
                for i in range(pairs):
                    crot(p, layer, order[2 * i], order[2 * i + 1], zero=rng.random() < 0.2)
                free = order[2 * pairs:]
            for q in free:
                gate_types[p, layer, q] = rng.choice([GATE_ID, GATE_ROT])
                if rng.random() < 0.2:
                    angles[p, layer, q] = 0.0
    mask = rng.random((pop, layers)) >= 0.2
    mask[0, 0] = True
    return tuple(torch.from_numpy(x).to(device) for x in (gate_types, controls, angles, mask))


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 units in the last place between ``a`` and ``b`` (+0 = -0)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)

    return (ordered(a) - ordered(b)).abs()


def assert_same_pipeline(got, want):
    for name in INTEGER_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape, name
        assert torch.equal(a, b), name
    for name in FLOAT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, name
        assert a.numel() == 0 or int(ulps(a, b).max()) <= 2, name
    for t in got:
        assert t.is_contiguous()


# ---------------------------------------------------------------------------
# the dispatch (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("absorb", [False, True])
def test_cpu_builds_take_the_pytorch_form_and_are_not_kernel_builds(monkeypatch, absorb):
    monkeypatch.setattr(fp, "build_counts", {"builds": 0, "host_ns": 0, "kernel": 0})
    tensors = genome(9, 3, 4, seed=5)
    got = fp.build_fold_pipeline(*tensors, 9, absorb_diag=absorb)
    want = fp.build_fold_pipeline_plain(*tensors, 9, absorb_diag=absorb)
    for name in fp.FoldPipeline._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert fp.build_counts == {"builds": 1, "host_ns": fp.build_counts["host_ns"], "kernel": 0}


@pytest.mark.parametrize("is_cuda, requires_grad, grad_mode, takes", [
    (True, False, True, True),
    (True, False, False, True),
    (True, True, False, True),
    (True, True, True, False),
    (False, False, False, False),
    (False, True, True, False),
])
def test_the_kernel_takes_card_angles_that_want_no_gradient(is_cuda, requires_grad, grad_mode,
                                                            takes):
    angles = SimpleNamespace(is_cuda=is_cuda, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_mode):
        assert fp._takes_kernel(angles) is takes


def test_kernel_builds_count_in_builds_and_kernel_under_one_span_each(monkeypatch):
    # the dict of a test that predates the kernel row, as test_torch_tracing's
    monkeypatch.setattr(fp, "build_counts", {"builds": 0, "host_ns": 0})
    launched = []

    def stand_in(*args):
        launched.append(args[-1])
        return fp.build_fold_pipeline_plain(*args)

    monkeypatch.setattr(fp, "_takes_kernel", lambda angles: True)
    monkeypatch.setattr(fp, "_build_on_card", stand_in)
    tensors = genome(8, 2, 3, seed=2)
    with recording() as recorded:
        for absorb in (False, True):
            fp.build_fold_pipeline(*tensors, 8, absorb_diag=absorb)
    assert launched == [False, True]
    assert fp.build_counts["builds"] == fp.build_counts["kernel"] == 2
    assert fp.build_counts["host_ns"] > 0
    assert [s[0] for s in recorded.spans] == ["fold.build", "fold.build"]


def test_fold_launch_rows_leave_the_build_out(monkeypatch):
    monkeypatch.setattr(fp, "build_counts", {"builds": 0, "host_ns": 0, "kernel": 0})
    monkeypatch.setattr(fp, "_takes_kernel", lambda angles: True)
    monkeypatch.setattr(fp, "_build_on_card", fp.build_fold_pipeline_plain)
    before = profiling.counters()
    fp.build_fold_pipeline(*genome(8, 2, 3, seed=1), 8, absorb_diag=True)
    after = profiling.counters()
    rows = [row for row in after if row.startswith("fold_kernels.")]
    assert rows and all(after[row] == before[row] for row in rows)
    assert set(rows) == {f"fold_kernels.{name}" for name in fold_kernels.launch_counts}
    assert after["fold_pipeline.kernel"] == after["fold_pipeline.builds"] == 1


@pytest.mark.parametrize("layers", [1, 6, 9])
@pytest.mark.parametrize("n_qubits", [7, 13, 20, 22])
def test_the_kernel_outputs_tile_two_allocations_in_the_fold_kernels_layouts(n_qubits, layers):
    pipeline = fp._outputs(16, layers, n_qubits, "cpu")
    assert fold_kernels._check_pipeline(pipeline, n_qubits) == (16, layers + 1,
                                                                max(n_qubits // 2, 1))
    for dtype in (torch.float32, torch.int32):
        parts = sorted((t.storage_offset(), t.numel()) for t in pipeline if t.dtype == dtype)
        storages = {t.untyped_storage().data_ptr() for t in pipeline if t.dtype == dtype}
        assert len(storages) == 1
        ends = [offset + size for offset, size in parts]
        assert [offset for offset, _ in parts] == [0, *ends[:-1]]  # no gap, no overlap
        storage = next(t for t in pipeline if t.dtype == dtype).untyped_storage()
        assert storage.nbytes() == ends[-1] * 4


@pytest.mark.parametrize("n_qubits, message", [(33, "n_qubits <= 32"), (0, "n_qubits <= 32"),
                                               (8, "runs on the card")])
def test_the_kernel_wrapper_refuses_sizes_and_devices_it_cannot_take(n_qubits, message):
    tensors = genome(8, 2, 2, seed=0)
    with pytest.raises(ValueError, match=message):
        fp._build_on_card(*tensors, n_qubits, True)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("layers", [1, 6, 9])
@pytest.mark.parametrize("pop", [1, 16])
@pytest.mark.parametrize("n_qubits", [7, 13, 14, 20, 21, 22])
def test_fold_build_kernel_equals_the_pytorch_build(cuda_device, n_qubits, pop, layers, absorb):
    tensors = genome(n_qubits, layers, pop, seed=1000 * n_qubits + 10 * layers + pop,
                     device=cuda_device)
    before = fp.build_counts["kernel"]
    with torch.no_grad():
        got = fp.build_fold_pipeline(*tensors, n_qubits, absorb_diag=absorb)
    assert fp.build_counts["kernel"] == before + 1
    want = fp.build_fold_pipeline_plain(*tensors, n_qubits, absorb_diag=absorb)
    assert_same_pipeline(got, want)
    assert int(want.diag_count.sum() + want.abs_count.sum()) > 0
    assert (int(want.abs_count.sum()) > 0) == absorb


@pytest.mark.cuda
def test_fold_build_kernel_energies_equal_the_pytorch_builds(cuda_device):
    n, pop, layers = 20, 16, 6
    tensors = genome(n, layers, pop, seed=20, device=cuda_device)
    table = torch.from_numpy(
        np.random.default_rng(7).normal(size=1 << n).astype(np.float32)).to(cuda_device)
    kernel = fp.build_fold_pipeline(*tensors, n, absorb_diag=True)
    plain = fp.build_fold_pipeline_plain(*tensors, n, absorb_diag=True)
    got = fold_kernels.energies_exact_folded(kernel, table, n)
    want = fold_kernels.energies_exact_folded(plain, table, n)
    gap = float((got - want).abs().max()) / float(table.abs().max())
    assert gap <= 1e-5, gap  # jssp20-exact-fold's population_energy_gap limit


@pytest.mark.cuda
def test_card_builds_that_want_a_gradient_take_the_pytorch_form(cuda_device):
    gate_types, controls, angles, mask = genome(14, 3, 4, seed=3, device=cuda_device)
    angles = angles.clone().requires_grad_(True)
    before = fp.build_counts["kernel"]
    differentiable = fp.build_fold_pipeline(gate_types, controls, angles, mask, 14)
    assert fp.build_counts["kernel"] == before
    assert differentiable.factors.requires_grad
    with torch.no_grad():
        kernel = fp.build_fold_pipeline(gate_types, controls, angles, mask, 14)
    assert fp.build_counts["kernel"] == before + 1
    assert_same_pipeline(kernel, fp.FoldPipeline(*(t.detach() for t in differentiable)))


@pytest.mark.cuda
def test_fold_build_kernel_refuses_more_than_32_qubits(cuda_device):
    before = fp.build_counts["kernel"]
    with pytest.raises(ValueError, match="n_qubits <= 32"):
        fp.build_fold_pipeline(*genome(33, 2, 2, seed=0, device=cuda_device), 33)
    assert fp.build_counts["kernel"] == before
