"""The port's multi-process runtime: two real processes joined by
``torch.distributed`` on gloo, after the JAX package's
``tests/test_multihost.py``.

(1) A global sum over both processes, joined by arguments and by the
``torchrun`` environment, with ``is_multihost`` and ``process_info`` and the
two-process mesh (each process's devices in rank order).  (2) A whole EVQE
solve across two processes (one CPU block each): both print the trajectory
of a one-process two-block solve, bit for bit.  Each process has its own
timeout.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180

SUM_WORKER = """
import sys
import torch
import torch.distributed as dist

from queasars_tpu_torch.parallel import (
    initialize_multihost, is_multihost, population_mesh, process_info)

address, rank, how = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert not is_multihost() and process_info() == (0, 1)
if how == "arguments":
    initialize_multihost(coordinator_address=address, num_processes=2, process_id=rank)
else:  # the torchrun environment
    import os
    host, port = address.split(":")
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank))
    initialize_multihost()
assert is_multihost() and process_info() == (rank, 2)
mesh = population_mesh(devices=["cpu"])
assert mesh.size == 2 and mesh.ranks == (0, 1) and mesh.local_blocks() == [rank]
total = torch.tensor([float(rank + 1)])
dist.all_reduce(total)
assert float(total) == 3.0, float(total)
dist.destroy_process_group()
print(f"RANK{rank}_OK", flush=True)
"""

SOLVE = """
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
from queasars_tpu_torch.solver import (
    ConfiguredEstimator, ConfiguredSampler, EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration)


def solve(mesh, sampler):
    hamiltonian = PauliSum.sum([pauli_z_string(q, 4) * float(q + 1) for q in range(4)])
    config = EVQEMinimumEigensolverConfiguration(
        configured_estimator=None if sampler else ConfiguredEstimator(),
        configured_sampler=ConfiguredSampler(shots=128, seed=3) if sampler else None,
        optimizer=BatchedNFT(NFTConfig(maxiter=4)), optimizer_n_circuit_evaluations=None,
        max_generations=2, max_circuit_evaluations=None, termination_criterion=None,
        random_seed=6, population_size=4, speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
        parameter_search_probability=0.5, topological_search_probability=0.5,
        layer_removal_probability=0.1, use_tournament_selection=True, tournament_size=2,
        mesh=mesh, device="cpu",
    )
    result = EVQEMinimumEigensolver(config).compute_minimum_eigenvalue(hamiltonian)
    return {"eigenvalue": result.eigenvalue,
            "trajectory": [list(g.expectation_values) for g in result.population_evaluation_results],
            "evaluations": list(result.circuit_evaluations),
            "eigenstate": sorted(result.eigenstate.items())}
"""

SOLVE_WORKER = SOLVE + """
import json, sys
import torch.distributed as dist
from queasars_tpu_torch.parallel import initialize_multihost, population_mesh

address, rank, sampler = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "sampler"
initialize_multihost(coordinator_address=address, num_processes=2, process_id=rank)
payload = solve(population_mesh(devices=["cpu"]), sampler)
dist.destroy_process_group()
print("RESULT" + json.dumps({"rank": rank, **payload}), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_pair(code, *extra):
    """Both ranks' (returncode, stdout, stderr), each process under its own
    timeout; every process is gone on return."""
    address = f"localhost:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [
        subprocess.Popen([sys.executable, "-c", code, address, str(rank), *extra], cwd=REPO,
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    outputs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            outputs.append((proc.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail("a multihost worker process timed out")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outputs


@pytest.mark.parametrize("how", ["arguments", "environment"])
def test_two_process_global_sum(how):
    for rank, (code, out, err) in enumerate(_run_pair(SUM_WORKER, how)):
        assert code == 0, f"rank {rank} failed:\n{err[-2000:]}"
        assert f"RANK{rank}_OK" in out


@pytest.mark.parametrize("path", ["estimator", "sampler"])
def test_two_process_evqe_solve_matches_one_process_two_blocks(path):
    payloads = {}
    for rank, (code, out, err) in enumerate(_run_pair(SOLVE_WORKER, path)):
        assert code == 0, f"rank {rank} failed:\n{err[-3000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                payloads[rank] = json.loads(line[len("RESULT"):])
    assert set(payloads) == {0, 1}
    assert payloads[0] == {**payloads[1], "rank": 0}

    from queasars_tpu_torch.parallel import population_mesh

    namespace: dict = {}
    exec(SOLVE, namespace)
    local = json.loads(json.dumps(
        namespace["solve"](population_mesh(devices=["cpu"] * 2), path == "sampler")))
    assert {k: v for k, v in payloads[0].items() if k != "rank"} == local
