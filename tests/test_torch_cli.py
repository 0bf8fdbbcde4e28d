"""The port's command line (``python -m queasars_tpu_torch solve``) against
the JAX package's.

In the process, the port's ``main`` (``--device cpu``) and the JAX
package's ``main`` (``--use-pallas`` with ``QUEASARS_MXU=0``, the
slot-kernel route the port follows on the CPU) solve the JAX CLI tests'
2x2 JSSP instance and 2-variable QUBO: the summaries have the same keys,
generations, evaluation ledger, likeliest state and decoded schedule or
bits.  Then checkpoint and resume through the CLI (the resumed run prints
the uninterrupted run's summary), ``--algorithm qneat``, ``--n-devices``
over CPU blocks, the refused mesh flags, and one subprocess run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from queasars_tpu.__main__ import main as jax_main
from queasars_tpu.problems.jssp import random_job_shop_scheduling_instance as jax_instance
from queasars_tpu.problems.jssp.serialization import JSSPJSONEncoder as JaxJSSPEncoder
from queasars_tpu.solver.serialization import (
    EvolvingAnsatzMinimumEigensolverResultJSONDecoder as JaxResultDecoder,
)
from queasars_tpu_torch.__main__ import main
from queasars_tpu_torch.problems.jssp import random_job_shop_scheduling_instance
from queasars_tpu_torch.problems.jssp.serialization import JSSPJSONEncoder
from queasars_tpu_torch.solver.serialization import (
    EvolvingAnsatzMinimumEigensolverResultJSONDecoder,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCE = dict(n_jobs=2, n_machines=2, relative_op_amount=1.0, op_duration=1, random_seed=0)
COMPARED = ("generations", "circuit_evaluations", "likeliest_state", "decoded")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The instance JSON (written by the port's encoder, equal to the JAX
    package's text) and the QUBO JSON."""
    root = tmp_path_factory.mktemp("cli")
    instance_path = str(root / "instance.json")
    text = json.dumps(random_job_shop_scheduling_instance("cli", **INSTANCE), cls=JSSPJSONEncoder)
    assert text == json.dumps(jax_instance("cli", **INSTANCE), cls=JaxJSSPEncoder)
    with open(instance_path, "w") as fh:
        fh.write(text)
    qubo_path = str(root / "qubo.json")
    with open(qubo_path, "w") as fh:
        json.dump({"quadratic": [[1.0, 0.0], [0.0, -1.0]]}, fh)
    return instance_path, qubo_path


def _summary(run, args, capsys):
    assert run(args) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port(args, capsys):
    return _summary(main, [*args, "--device", "cpu"], capsys)


def _jax(args, capsys, monkeypatch):
    monkeypatch.setenv("QUEASARS_MXU", "0")
    return _summary(jax_main, [*args, "--use-pallas"], capsys)


def _jssp_args(inputs, *extra):
    return ["solve", "--jssp", inputs[0], "--makespan-limit", "3", "--population", "6",
            "--nft-maxiter", "8", *extra]


@pytest.mark.parametrize("source", ["jssp", "qubo"])
def test_cli_summary_matches_the_jax_package(inputs, source, capsys, monkeypatch):
    if source == "jssp":
        args = _jssp_args(inputs, "--generations", "2")
    else:
        args = ["solve", "--qubo", inputs[1], "--generations", "2", "--population", "6",
                "--nft-maxiter", "8"]
    ours = _port(args, capsys)
    theirs = _jax(args, capsys, monkeypatch)
    assert set(ours) == set(theirs)
    for key in COMPARED:
        assert ours[key] == theirs[key], key
    assert len(ours["best_per_generation"]) == ours["generations"] == 2
    if source == "qubo":
        assert ours["decoded"]["bits"] == [0, 1]


def test_cli_checkpoint_resume_and_output(inputs, tmp_path, capsys):
    checkpoint = str(tmp_path / "state.json")
    output = str(tmp_path / "result.json")
    full = _port(_jssp_args(inputs, "--generations", "3"), capsys)
    first = _port(_jssp_args(inputs, "--generations", "2", "--checkpoint", checkpoint,
                             "--output", output), capsys)
    assert first["generations"] == 2 and first["result_file"] == output
    assert os.path.exists(checkpoint)
    resumed = _port(_jssp_args(inputs, "--generations", "3", "--checkpoint", checkpoint,
                               "--resume"), capsys)
    assert resumed == full
    with open(output) as fh:
        ours = json.load(fh, cls=EvolvingAnsatzMinimumEigensolverResultJSONDecoder)
    with open(output) as fh:
        theirs = json.load(fh, cls=JaxResultDecoder)
    assert ours.generations == theirs.generations == 2
    assert ours.circuit_evaluations == theirs.circuit_evaluations == first["circuit_evaluations"]
    assert ours.eigenvalue == theirs.eigenvalue == first["eigenvalue"]


def test_cli_qneat_and_its_resume(inputs, tmp_path, capsys):
    checkpoint = str(tmp_path / "qneat.json")
    args = ["solve", "--qubo", inputs[1], "--algorithm", "qneat", "--population", "8",
            "--nft-maxiter", "6"]
    full = _port([*args, "--generations", "4"], capsys)
    assert full["generations"] == 4 and full["decoded"]["bits"] == [0, 1]
    _port([*args, "--generations", "2", "--checkpoint", checkpoint], capsys)
    resumed = _port([*args, "--generations", "4", "--checkpoint", checkpoint, "--resume"], capsys)
    assert resumed == full


@pytest.mark.parametrize("flag", [["--n-devices", "2"], ["--shard-amplitudes"]])
def test_cli_refuses_the_mesh_flags(inputs, flag, capsys):
    """Both mesh flags are EVQE-only, as in the JAX CLI.  An EVQE solve runs
    ``--n-devices`` (:func:`test_cli_n_devices_splits_the_population`) and
    ``--shard-amplitudes``: with ``--n-devices 2`` and ``1`` (amplitude
    meshes factored 2x1 and 1x1) it prints the same summary bit for bit,
    and without a mesh it solves unsharded, as the JAX CLI does."""
    with pytest.raises(SystemExit, match="EVQE-only"):
        main([*_jssp_args(inputs, "--generations", "1"), *flag, "--algorithm", "qneat",
              "--device", "cpu"])
    if flag == ["--shard-amplitudes"]:
        args = [*_jssp_args(inputs, "--generations", "1"), *flag]
        two = _port([*args, "--n-devices", "2"], capsys)
        assert two == _port([*args, "--n-devices", "1"], capsys)
        assert _port(args, capsys)["generations"] == 1
    with pytest.raises(SystemExit, match="requires --checkpoint"):
        main([*_jssp_args(inputs, "--generations", "1"), "--resume", "--device", "cpu"])


def test_cli_n_devices_splits_the_population(inputs, capsys, monkeypatch):
    """``--n-devices N`` with ``--device cpu`` splits the solve over N CPU
    blocks: 1 and 4 blocks print the same summary bit for bit, and it equals
    the JAX CLI's ``--n-devices 4`` (on its 8-device CPU mesh) in the
    compared keys."""
    args = _jssp_args(inputs, "--generations", "2")
    one = _port([*args, "--n-devices", "1"], capsys)
    four = _port([*args, "--n-devices", "4"], capsys)
    assert one == four
    theirs = _jax([*args, "--n-devices", "4"], capsys, monkeypatch)
    for key in COMPARED:
        assert four[key] == theirs[key], key


def test_cli_runs_as_a_module(inputs):
    proc = subprocess.run(
        [sys.executable, "-m", "queasars_tpu_torch", *_jssp_args(inputs, "--generations", "1"),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["generations"] == 1
    assert set(summary) == {"eigenvalue", "generations", "circuit_evaluations",
                            "best_per_generation", "likeliest_state", "decoded"}
