"""The port reaches neither JAX nor the JAX package: in a fresh process with
``jax``, ``queasars_tpu`` and ``matplotlib`` blocked, every module of
``queasars_tpu_torch`` (the optimizers, the gradient optimizer, MoG-VQE,
QAOA, ADAPT-VQE, QNEAT, the QUBO encoders, the exact JSSP oracle, the
command line ``__main__``, the external evaluators, the JSON and QASM
codecs, checkpoints, profiling, the population mesh and its multi-process
runtime (``parallel``), amplitude sharding, and the two plotting modules, which import
matplotlib only when they draw, among them) and ``chip_smoke`` (not run)
import, and ``chip_smoke`` refuses to run without a CUDA device."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "queasars_tpu", "matplotlib"):
    sys.modules[name] = None
import queasars_tpu_torch
names = [m.name for m in pkgutil.walk_packages(queasars_tpu_torch.__path__, "queasars_tpu_torch.")]
required = ["queasars_tpu_torch." + m for m in (
    "optim.spsa", "optim.spsa_termination", "optim.cobyla", "evolve.multiobjective",
    "solver.mog_vqe", "optim.gradient", "sim.qaoa", "solver.qaoa", "solver.adapt_vqe",
    "genome.qneat", "evolve.qneat", "solver.qneat", "problems.qubo",
    "problems.jssp.exact_solver", "utils.bitstring_evaluation", "__main__", "sim.external",
    "genome.serialization", "genome.qasm", "problems.jssp.serialization", "solver.serialization",
    "solver.checkpoint", "utils.profiling", "solver.visualization",
    "problems.jssp.visualization", "parallel", "parallel.mesh", "parallel.multihost",
    "utils.batch_invariant", "parallel.amplitude", "sim.shard_kernels",
    "sim.sharded_statevector", "sim.sharded_fold", "sim.sharded_evaluator")]
assert set(required) <= set(names), sorted(set(required) - set(names))
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "queasars_tpu", "matplotlib")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("imported", len(names))
"""


def _run(code, **kwargs):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": REPO}, **kwargs,
    )


def test_port_and_chip_smoke_import_without_jax():
    proc = _run(BLOCKED_IMPORT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 30


def test_kernel_library_is_not_built_at_import():
    proc = _run(
        BLOCKED_IMPORT
        + "\nfrom queasars_tpu_torch.utils import cuda_lib\nassert cuda_lib._library is None\n"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_chip_smoke_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=240
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    import torch

    from queasars_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
