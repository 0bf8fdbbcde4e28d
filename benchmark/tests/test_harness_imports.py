"""Nothing the benchmark runs brings JAX or the JAX package into
``sys.modules`` (top-level names compared whole: ``queasars_tpu_torch``
begins with ``queasars_tpu``), and the reference brings in no part of the
port."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.small import ROOT

BENCH = ROOT / "benchmark"
MODULES = sorted(
    "benchmark." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
    for p in BENCH.rglob("*.py")
    if "tests" not in p.relative_to(BENCH).parts and p.parent.name != "metrics"
    and p.name != "__init__.py")


def loaded_after(statement: str) -> set[str]:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {statement}; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", MODULES)
def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package(module):
    top = loaded_after(f"import {module}")
    assert not top & {"jax", "jaxlib", "flax", "queasars_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    top = loaded_after("import benchmark.reference.encoding, benchmark.reference.statevector, "
                       "benchmark.check")
    assert "queasars_tpu_torch" not in top
    assert not top & {"jax", "jaxlib", "flax", "queasars_tpu"}


def test_metric_readers_load_nothing_of_the_port():
    readers = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))
    top = loaded_after("from benchmark import harness; "
                       + "; ".join(f"harness.load_reader({r!r})" for r in readers))
    assert not top & {"jax", "jaxlib", "flax", "queasars_tpu"}


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "jssp20-exact.seeds",
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout.strip() == ""
