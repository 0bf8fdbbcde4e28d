#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one flushed progress line with elapsed seconds:

1. device: the card's name and power limit, TF32 matmuls off;
2. build: the CUDA kernels (``queasars_tpu_torch/csrc/*.cu``) with one nvcc
   call, printing its command, seconds and ``-Xptxas -v`` lines;
3. kernels at full width (n=20): every slot kernel against its plain
   PyTorch version on the same inputs on the card, timed with CUDA events;
4. solve: the 20-qubit 3x3 JSSP instance under the repository's config 4
   (population 16, NFT maxiter 30, 4 generations, ``pack_min_layers=6``,
   seed 0) through ``EVQEMinimumEigensolver.compute_minimum_eigenvalue``,
   with every kernel's launch count over that solve, then two checks of its
   result.

The line before the last is a JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.  Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import importlib
import json
import subprocess
import sys
import time

T0 = time.perf_counter()
#: wall-time budget: past it the run dumps its stacks and exits non-zero
BUDGET_S = 1100
N_QUBITS = 20
DEVICE = "cuda"
#: the repository's config 4 (experiments/exp_baseline_configs.py)
SOLVE = dict(population=16, maxiter=30, generations=4, pack_min_layers=6, seed=0)
#: bench.py's workload for population energies
BENCH = dict(population=32, layers=5, terms=512)
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside
#: the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
FLOPS_PER_PAIR = 28  # one complex 2x2 matvec on an amplitude pair
FLOPS_PER_AMPLITUDE_ENERGY = 5  # (re^2 + im^2) * table, accumulated
FLOPS_PER_AMPLITUDE_PROB = 3
SOURCE = "queasars_tpu_torch/csrc/slot_kernels.cu"
REPLACES = {
    "energies_exact": "queasars_tpu/sim/pallas_kernels.py:367",
    "population_states": "queasars_tpu/sim/pallas_kernels.py:326",
    "nft_layer_sweep": "queasars_tpu/sim/pallas_kernels.py:837",
    "population_probs": "queasars_tpu/sim/pallas_kernels.py:267",
}


def say(message: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {message}", flush=True)


class Failure(Exception):
    pass


def require(condition: bool, message: str) -> None:
    if not condition:
        raise Failure(message)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


def jssp_with_qubits(n_jobs, n_machines, makespan_limit, want_qubits, op_duration):
    """The first seeded random JSSP instance whose Hamiltonian has
    ``want_qubits`` qubits (experiments/exp_baseline_configs.py:48-58)."""
    from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
    from queasars_tpu_torch.problems.jssp.random_instances import (
        random_job_shop_scheduling_instance,
    )

    for seed in range(200):
        instance = random_job_shop_scheduling_instance(
            instance_name=f"bl-{seed}", n_jobs=n_jobs, n_machines=n_machines,
            relative_op_amount=0.5, op_duration=op_duration, random_seed=seed,
        )
        encoder = JSSPDomainWallHamiltonianEncoder(instance, makespan_limit=makespan_limit)
        hamiltonian = encoder.get_problem_hamiltonian()
        if hamiltonian.n_qubits == want_qubits:
            return seed, encoder, hamiltonian
    raise Failure(f"no {want_qubits}-qubit JSSP instance found")


def random_genomes(n_qubits, layers, population, seed):
    """Seeded random genomes of ``layers`` real layers on the device."""
    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    pop = EVQEPopulation.random_population(n_qubits, layers, population, True, random_seed=seed)
    packed = PackedPopulation.pack(list(pop.individuals), min_layers=layers)
    return packed_tensors(packed, device=DEVICE)


def synthetic_table(n_qubits, terms):
    """bench.py's synthetic 512-term diagonal table (numpy seed 0)."""
    import numpy as np
    import torch

    from queasars_tpu_torch.paulis import PauliSum, diagonal_energy_table

    rng = np.random.default_rng(0)
    z_masks = rng.integers(0, 1 << n_qubits, size=terms, dtype=np.uint64)
    coeffs = rng.normal(size=terms)
    op = PauliSum(
        n_qubits, coeffs.astype(np.complex128), z_masks[:, None],
        np.zeros((terms, 1), dtype=np.uint64),
    )
    return diagonal_energy_table(op, dtype=torch.float32, device=DEVICE)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------


def circuit_flops(gate_types, layer_mask, n_qubits) -> float:
    """FLOPs this genome's active slots need: a U3 slot touches every
    amplitude pair, a CU3 slot the half whose control bit is set."""
    on = layer_mask[:, :, None]
    rot = ((gate_types == 1) & on).sum().item()
    crot = ((gate_types == 3) & on).sum().item()
    pairs = 1 << (n_qubits - 1)
    return FLOPS_PER_PAIR * (rot * pairs + crot * pairs / 2)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def genome_bytes(gate_types, layer_mask) -> int:
    return gate_types.numel() * (4 + 4 + 12) + layer_mask.numel()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must stay off")
    say(f"phase device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")
    return card, name


def phase_build():
    from queasars_tpu_torch.utils import cuda_lib

    info = cuda_lib.build()
    say(f"phase build: {info.seconds:.2f} s: {' '.join(info.command)}")
    for line in info.ptxas:
        print(f"    ptxas: {line}", flush=True)
    cuda_lib.load()
    return info


def check_close(name, got, want, tol, records, key=None):
    err = float((got.double() - want.double()).abs().max().item())
    say(f"  {name}: max |kernel - plain| = {err:.3e} (tolerance {tol:.3e})")
    require(err <= tol, f"{name} disagrees with its plain version: {err:.3e} > {tol:.3e}")
    if key is not None:
        records[key]["max_abs_err"] = max(records[key].get("max_abs_err", 0.0), err)
    return err


def phase_kernels(table):
    """Every kernel against its plain version at n=20 on the main path's
    shapes; returns per-kernel records (times, errors, bounds)."""
    import torch

    from queasars_tpu_torch.optim.prefix import prefix_mask
    from queasars_tpu_torch.sim import slot_kernels as sk

    n, dim, dev = N_QUBITS, 1 << N_QUBITS, DEVICE
    records = {name: {} for name in REPLACES}
    table_tol = 1e-5 * float(table.abs().max().item())

    # the solve's shape: P=16, L=6, the last layer of every third
    # individual masked off
    gt, ctrl, ang, mask = random_genomes(n, SOLVE["pack_min_layers"], SOLVE["population"], 1)
    mask[::3, -1] = False
    pop = gt.shape[0]
    last = mask.sum(dim=1) - 1
    pmask = prefix_mask(mask, last)
    rows = torch.arange(pop, device=dev)

    # states kernel: the prefix states of a last-layer search
    prefix = sk.population_states(gt, ctrl, ang, pmask, n)
    check_close(f"population_states [{pop},2,2^{n}]", prefix,
                sk.population_states_plain(gt, ctrl, ang, pmask, n), 1e-5, records,
                "population_states")
    flops = circuit_flops(gt, pmask, n)
    records["population_states"].update(
        ms=time_ms(lambda: sk.population_states(gt, ctrl, ang, pmask, n), 5),
        plain_ms=time_ms(lambda: sk.population_states_plain(gt, ctrl, ang, pmask, n), 2),
        bound=bound(genome_bytes(gt, mask) + 8 * dim * pop, flops),
    )

    # energies kernel: the fused parameter search (suffix from the prefix
    # states) and bench.py's population energies
    smask = mask & ~pmask
    e_kernel = sk.energies_exact(gt, ctrl, ang, smask, table, n, prefix)
    e_again = sk.energies_exact(gt, ctrl, ang, smask, table, n, prefix)
    require(torch.equal(e_kernel, e_again), "energies kernel is not deterministic")
    check_close(f"energies_exact from prefix [{pop}]", e_kernel,
                sk.energies_exact_plain(gt, ctrl, ang, smask, table, n, prefix), table_tol,
                records, "energies_exact")
    e_full = sk.energies_exact(gt, ctrl, ang, mask, table, n)
    check_close(f"energies_exact from |0> [{pop}]", e_full,
                sk.energies_exact_plain(gt, ctrl, ang, mask, table, n), table_tol, records,
                "energies_exact")
    bgt, bctrl, bang, bmask = random_genomes(n, BENCH["layers"], BENCH["population"], 0)
    btable = synthetic_table(n, BENCH["terms"])
    check_close(f"energies_exact bench [{bgt.shape[0]}]",
                sk.energies_exact(bgt, bctrl, bang, bmask, btable, n),
                sk.energies_exact_plain(bgt, bctrl, bang, bmask, btable, n),
                1e-5 * float(btable.abs().max().item()), records, "energies_exact")
    bench_ms = time_ms(lambda: sk.energies_exact(bgt, bctrl, bang, bmask, btable, n), 5)
    bench_bound = bound(genome_bytes(bgt, bmask) + 4 * dim + 4 * bgt.shape[0],
                        circuit_flops(bgt, bmask, n)
                        + FLOPS_PER_AMPLITUDE_ENERGY * dim * bgt.shape[0])
    say(f"  energies_exact bench [{bgt.shape[0]}, L={bgt.shape[1]}]: {bench_ms:.3f} ms "
        f"(bound {bench_bound[0]:.3f} ms, {bench_bound[1]})")
    records["energies_exact"].update(
        ms=time_ms(lambda: sk.energies_exact(gt, ctrl, ang, smask, table, n, prefix), 5),
        plain_ms=time_ms(
            lambda: sk.energies_exact_plain(gt, ctrl, ang, smask, table, n, prefix), 2),
        bound=bound(genome_bytes(gt, mask) + 4 * dim + 8 * dim * pop + 4 * pop,
                    circuit_flops(gt, smask, n) + FLOPS_PER_AMPLITUDE_ENERGY * dim * pop),
        bench_ms=bench_ms,
    )

    # probabilities kernel: exact CVaR / the final measurement
    check_close(f"population_probs [{pop},2^{n}]", sk.population_probs(gt, ctrl, ang, mask, n),
                sk.population_probs_plain(gt, ctrl, ang, mask, n), 1e-5, records,
                "population_probs")
    records["population_probs"].update(
        ms=time_ms(lambda: sk.population_probs(gt, ctrl, ang, mask, n), 5),
        plain_ms=time_ms(lambda: sk.population_probs_plain(gt, ctrl, ang, mask, n), 2),
        bound=bound(genome_bytes(gt, mask) + 4 * dim * pop,
                    circuit_flops(gt, mask, n) + FLOPS_PER_AMPLITUDE_PROB * dim * pop),
    )

    # sweep kernel: the last-layer search, maxiter 30, compared through
    # energies of the full circuits at the final angles
    gt1, ctrl1, ang1 = (t[rows, last].contiguous() for t in (gt, ctrl, ang))
    k_max = 3 * n
    coords = torch.zeros((pop, k_max, 2), dtype=torch.int32)
    n_free = torch.zeros(pop, dtype=torch.int32)
    for p, types in enumerate(gt1.cpu().tolist()):
        flat = [(q, a) for q, t in enumerate(types) if t in (1, 3) for a in range(3)]
        coords[p, : len(flat)] = torch.tensor(flat, dtype=torch.int32).reshape(-1, 2)
        n_free[p] = len(flat)
    coords, n_free = coords.to(dev), n_free.to(dev)
    active = n_free > 0
    active[0] = False
    args = (gt1, ctrl1, ang1, coords, n_free, active, prefix, table, n, SOLVE["maxiter"], 32)
    a_k, z_k = sk.nft_layer_sweep(*args)
    a_p, z_p = sk.nft_layer_sweep_plain(*args)

    def full_energies(layer_angles):
        full = ang.clone()
        full[rows, last] = layer_angles
        return sk.energies_exact_plain(gt, ctrl, full, mask, table, n)

    e_k, e_p = full_energies(a_k), full_energies(a_p)
    check_close("nft_layer_sweep recycled z vs plain energies at its angles", z_k, e_k,
                table_tol, records, "nft_layer_sweep")
    check_close("nft_layer_sweep vs plain sweep (plain energies)", e_k, e_p, table_tol,
                records, "nft_layer_sweep")
    require(torch.equal(a_k[0], ang1[0]), "the sweep moved an inactive individual")
    layer_flops = circuit_flops(gt1[:, None], torch.ones((pop, 1), dtype=torch.bool, device=dev), n)
    evals = 2 * SOLVE["maxiter"] + 1 + (SOLVE["maxiter"] - 1) // 32
    records["nft_layer_sweep"].update(
        ms=time_ms(lambda: sk.nft_layer_sweep(*args), 3),
        plain_ms=time_ms(lambda: sk.nft_layer_sweep_plain(*args), 1),
        bound=bound(8 * dim * pop + 4 * dim + pop * (k_max * 8 + 2 * n * 12 + 9),
                    evals * (layer_flops + FLOPS_PER_AMPLITUDE_ENERGY * dim * pop)),
    )
    say(f"  nft_layer_sweep: mean energy {float(e_k.mean()):.4f} from "
        f"{float(full_energies(ang1).mean()):.4f}")
    for name, rec in records.items():
        say(f"  {name}: {rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f} ms, bound "
            f"{rec['bound'][0]:.4f} ms by {rec['bound'][1]})")
    return records


class _GenerationClock:
    """A termination criterion that never terminates and records when each
    generation's evaluation finished."""

    def __init__(self):
        self.stamps = []

    def reset_state(self):
        self.stamps = [time.perf_counter()]

    def check_termination(self, population_evaluation, best_individual, best_expectation_value):
        self.stamps.append(time.perf_counter())
        say(f"  generation {len(self.stamps) - 1}: best {best_expectation_value:.6f}, "
            f"{self.stamps[-1] - self.stamps[-2]:.2f} s")
        return False


def config4_solver(clock=None):
    """The EVQE solver of the repository's config 4
    (experiments/exp_baseline_configs.py:64-83, 143-151) on the card;
    ``clock`` is its termination criterion."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        configured_sampler=None,
        optimizer=BatchedNFT(NFTConfig(maxiter=SOLVE["maxiter"])),
        optimizer_n_circuit_evaluations=None,
        max_generations=SOLVE["generations"],
        max_circuit_evaluations=None,
        termination_criterion=clock,
        random_seed=SOLVE["seed"],
        population_size=SOLVE["population"],
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1,
        parameter_search_probability=0.25,
        topological_search_probability=0.4,
        layer_removal_probability=0.05,
        pack_min_layers=SOLVE["pack_min_layers"],
        device=DEVICE,
    ))


def phase_solve(seed, encoder, hamiltonian, table):
    import numpy as np

    from queasars_tpu_torch.genome import PackedPopulation
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    solver = config4_solver(_GenerationClock())
    sk.reset_launch_counts()
    start = time.perf_counter()
    result = solver.compute_minimum_eigenvalue(hamiltonian)
    seconds = time.perf_counter() - start
    launches = dict(sk.launch_counts)
    evals = int(sum(result.circuit_evaluations))
    best_state = max(result.eigenstate, key=result.eigenstate.get)
    bits = format(best_state, f"0{hamiltonian.n_qubits}b")
    say(f"phase solve: instance seed {seed}, {result.generations} generations in {seconds:.2f} s, "
        f"{evals} evaluations ({evals / seconds:.1f}/s), eigenvalue {result.eigenvalue:.6f}, "
        f"best bitstring {bits} (p={result.eigenstate[best_state]:.4f})")
    say(f"  launches over the solve: {launches}")
    require(result.generations == SOLVE["generations"], "the solve stopped early")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # check 1: the best bitstring's table energy is the Hamiltonian's value
    # at that basis state, computed on the host in float64
    coeffs = hamiltonian.coeffs.real
    parity = np.array([bin(int(z) & best_state).count("1") & 1 for z in hamiltonian.z_masks_lo64()])
    host_value = float(np.sum(coeffs * (1.0 - 2.0 * parity)))
    table_value = float(table[best_state])
    tol = 1e-5 * float(table.abs().max().item())
    schedule = encoder.translate_result_state(best_state)
    say(f"  check bitstring: table {table_value:.6f} vs host {host_value:.6f}; schedule "
        f"valid={schedule.is_valid} makespan={schedule.makespan}")
    require(abs(table_value - host_value) <= tol, "table energy disagrees with the Hamiltonian")

    # check 2: the best individual's energy through the plain version
    packed = PackedPopulation.pack([result.best_individual])
    tensors = packed_tensors(packed, device=DEVICE)
    plain = float(sk.energies_exact_plain(*tensors, table, hamiltonian.n_qubits)[0])
    say(f"  check eigenvalue: solver {result.eigenvalue:.6f} vs plain {plain:.6f}")
    require(abs(plain - result.eigenvalue) <= tol, "eigenvalue disagrees with the plain version")
    require(np.isfinite(result.eigenvalue), "eigenvalue is not finite")
    return launches


def main() -> int:
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        importlib.import_module("queasars_tpu_torch")
    except ImportError:
        print("chip_smoke: run from the repository root (queasars_tpu_torch missing)",
              file=sys.stderr)
        return 2

    try:
        card, name = phase_device()
        phase_build()
        seed, encoder, hamiltonian = jssp_with_qubits(3, 3, 6, N_QUBITS, {1: 0.5, 2: 0.5})
        require(hamiltonian.n_qubits == N_QUBITS, "the instance is not 20 qubits")
        from queasars_tpu_torch.paulis import diagonal_energy_table

        table = diagonal_energy_table(hamiltonian, dtype=torch.float32, device=DEVICE)
        say(f"instance: seed {seed}, {hamiltonian.n_qubits} qubits, {hamiltonian.n_terms} terms, "
            f"max |table| {float(table.abs().max()):.3f}")
        records = phase_kernels(table)
        say("phase kernels: all four kernels agree with their plain versions")
        launches = phase_solve(seed, encoder, hamiltonian, table)
    except Failure as failure:
        say(f"FAILED: {failure}")
        return 1

    kernels = [
        {
            "name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
            "launches": launches[k], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
            "bound_by": rec["bound"][1], "library_ms": None,
        }
        for k, rec in records.items()
    ]
    say(f"done in {time.perf_counter() - T0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
