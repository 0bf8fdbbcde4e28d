"""Amplitude sharding across two processes joined by ``torch.distributed``
on gloo, after the JAX package's ``tests/test_multihost.py:232``: one
statevector split over both processes (one CPU cell each, shards
exchanged through host tensors).  Exact energies, the device NFT sweep
and a general operator's grouped shots equal the one-process two-cell
mesh's bit for bit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180

WORK = """
import numpy as np

from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
from queasars_tpu_torch.paulis import PauliSum, pauli_z_string
from queasars_tpu_torch.problems.spin_chains import transverse_field_ising
from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator


def work(mesh):
    n = 5
    population = EVQEPopulation.random_population(n, 2, 3, True, random_seed=9)
    packed = PackedPopulation.pack(list(population.individuals))
    operator = PauliSum.sum([pauli_z_string(q, n) * float(q + 1) for q in range(n)])
    evaluator = AmplitudeShardedExpectationEvaluator(operator, mesh)
    energies = evaluator.evaluate_packed(packed)
    width = int(packed.n_params.max())
    coords = np.stack([np.pad(packed.param_coordinates(i),
                              ((0, width - packed.n_params[i]), (0, 0)))
                       for i in range(packed.n_individuals)])
    active = np.ones(packed.n_individuals, bool)
    _, opt_energies, _ = BatchedNFT(NFTConfig(maxiter=4)).minimize(
        evaluator, packed, coords, packed.n_params, active, seed=0)
    grouped = AmplitudeShardedExpectationEvaluator(
        transverse_field_ising(n, coupling=1.0, field=0.9), mesh, shots=256, seed=7)
    return {"energies": [float(v) for v in energies],
            "opt_energies": [float(v) for v in opt_energies],
            "grouped_energies": [float(v) for v in grouped.evaluate_packed(packed)]}
"""

WORKER = WORK + """
import json
import sys

import torch

from queasars_tpu_torch.parallel import initialize_multihost
from queasars_tpu_torch.parallel.amplitude import amplitude_mesh

initialize_multihost(coordinator_address=sys.argv[1], num_processes=2,
                     process_id=int(sys.argv[2]))
mesh = amplitude_mesh(devices=["cpu"])
assert mesh.n_amp == 2 and mesh.ranks == ((0, 1),)
out = work(mesh)
torch.distributed.destroy_process_group()
print("RESULT" + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_two_process_amplitude_sharded_evaluation():
    address = f"localhost:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, address, str(rank)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    payloads = {}
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, f"rank {rank} failed:\n{err[-3000:]}"
            for line in out.splitlines():
                if line.startswith("RESULT"):
                    payloads[rank] = json.loads(line[len("RESULT"):])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert set(payloads) == {0, 1} and payloads[0] == payloads[1]

    from queasars_tpu_torch.parallel.amplitude import amplitude_mesh

    namespace: dict = {}
    exec(WORK, namespace)
    local = namespace["work"](amplitude_mesh(devices=["cpu"] * 2))
    for key, values in local.items():
        np.testing.assert_array_equal(np.float32(payloads[0][key]), np.float32(values))
