#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one flushed progress line with elapsed seconds:

1. device: the card's name and power limit, TF32 matmuls off;
2. build: the CUDA kernels (``queasars_tpu_torch/csrc/*.cu``: slot and fold
   kernels) with one nvcc call, printing its command, seconds and
   ``-Xptxas -v`` lines;
3. slot kernels at full width (n=20): every slot kernel against its plain
   PyTorch version on the same inputs on the card, timed with CUDA events;
4. fold kernels at the same shapes: every fold kernel against its plain
   version, the fold energies against the slot energies (the two routes
   compute one function), equal bits from equal inputs, timings;
5. solve, slot route (``QUEASARS_MXU=0``): the 20-qubit 3x3 JSSP instance
   under the repository's config 4 (population 16, NFT maxiter 30, 4
   generations, ``pack_min_layers=6``, seed 0) through
   ``EVQEMinimumEigensolver.compute_minimum_eigenvalue``, with every
   kernel's launch count over that solve, then two checks of its result;
6. solve, fold route (``QUEASARS_MXU`` unset, the JAX package's default):
   the same solve and checks; the fold kernels must carry it.

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
SLOT_SOURCE = "queasars_tpu_torch/csrc/slot_kernels.cu"
FOLD_SOURCE = "queasars_tpu_torch/csrc/fold_kernels.cu"
#: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "energies_exact": (SLOT_SOURCE, "queasars_tpu/sim/pallas_kernels.py:367"),
    "population_states": (SLOT_SOURCE, "queasars_tpu/sim/pallas_kernels.py:326"),
    "nft_layer_sweep": (SLOT_SOURCE, "queasars_tpu/sim/pallas_kernels.py:837"),
    "population_probs": (SLOT_SOURCE, "queasars_tpu/sim/pallas_kernels.py:267"),
    "energies_exact_folded": (FOLD_SOURCE, "queasars_tpu/sim/pallas_fold_kernels.py:743"),
    "population_states_folded": (FOLD_SOURCE, "queasars_tpu/sim/pallas_fold_kernels.py:1195"),
    "nft_layer_sweep_folded": (FOLD_SOURCE, "queasars_tpu/sim/pallas_fold_kernels.py:1623"),
    "population_probs_folded": (FOLD_SOURCE, "queasars_tpu/sim/pallas_fold_kernels.py:699"),
}
#: the kernels each solve route must launch (the folded probabilities
#: kernel carries the fold route's final measurement distribution)
ROUTE_KERNELS = {
    "slot": ("energies_exact", "population_states", "nft_layer_sweep", "population_probs"),
    "fold": ("energies_exact_folded", "population_states_folded", "nft_layer_sweep_folded",
             "population_probs_folded"),
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


def fold_flops(pipeline, n_qubits) -> float:
    """FLOPs of the fold kernels' own group products for a pipeline: 8 per
    complex multiply-add, 2^n * S of them per active group and individual
    (for information; the bounds count the slot route's work)."""
    from queasars_tpu_torch.sim.fold_pipeline import group_bounds

    sizes = [1 << m for _, m in group_bounds(n_qubits)]
    active = pipeline.group_active.sum(dim=(0, 1)).tolist()
    return 8.0 * (1 << n_qubits) * sum(a * size for a, size in zip(active, sizes))


class Workload:
    """The main path's kernel inputs at n=20: population 16 in 6 layers,
    the last layer of every third individual masked off; prefix masks of a
    last-layer search and the suffix masks of a parameter search; the
    sweep's layer slices and free coordinates."""

    def __init__(self, table):
        import torch

        from queasars_tpu_torch.optim.prefix import prefix_mask

        n, dev = N_QUBITS, DEVICE
        self.table = table
        self.gt, self.ctrl, self.ang, self.mask = random_genomes(
            n, SOLVE["pack_min_layers"], SOLVE["population"], 1)
        self.mask[::3, -1] = False
        self.pop = self.gt.shape[0]
        self.last = self.mask.sum(dim=1) - 1
        self.pmask = prefix_mask(self.mask, self.last)
        self.smask = self.mask & ~self.pmask
        self.rows = torch.arange(self.pop, device=dev)
        self.gt1, self.ctrl1, self.ang1 = (
            t[self.rows, self.last].contiguous() for t in (self.gt, self.ctrl, self.ang))
        self.k_max = 3 * n
        coords = torch.zeros((self.pop, self.k_max, 2), dtype=torch.int32)
        n_free = torch.zeros(self.pop, dtype=torch.int32)
        for p, types in enumerate(self.gt1.cpu().tolist()):
            flat = [(q, a) for q, t in enumerate(types) if t in (1, 3) for a in range(3)]
            coords[p, : len(flat)] = torch.tensor(flat, dtype=torch.int32).reshape(-1, 2)
            n_free[p] = len(flat)
        self.coords, self.n_free = coords.to(dev), n_free.to(dev)
        self.active = self.n_free > 0
        self.active[0] = False
        self.bench = random_genomes(n, BENCH["layers"], BENCH["population"], 0)
        self.bench_table = synthetic_table(n, BENCH["terms"])

    def full_energies(self, layer_angles):
        """Plain slot-engine energies of the whole circuits with the swept
        layer at ``layer_angles``."""
        from queasars_tpu_torch.sim import slot_kernels as sk

        full = self.ang.clone()
        full[self.rows, self.last] = layer_angles
        return sk.energies_exact_plain(self.gt, self.ctrl, full, self.mask, self.table, N_QUBITS)

    def bounds(self):
        """The least time of each function at these shapes: each input read
        once, each output written once, against the slot route's FLOPs.
        A slot kernel and its fold counterpart share one bound."""
        import torch

        dim, pop, n = 1 << N_QUBITS, self.pop, N_QUBITS
        gt, mask = self.gt, self.mask
        one = torch.ones((pop, 1), dtype=torch.bool, device=DEVICE)
        layer_flops = circuit_flops(self.gt1[:, None], one, n)
        evals = 2 * SOLVE["maxiter"] + 1 + (SOLVE["maxiter"] - 1) // 32
        states = bound(genome_bytes(gt, mask) + 8 * dim * pop, circuit_flops(gt, self.pmask, n))
        energies = bound(genome_bytes(gt, mask) + 4 * dim + 8 * dim * pop + 4 * pop,
                         circuit_flops(gt, self.smask, n) + FLOPS_PER_AMPLITUDE_ENERGY * dim * pop)
        probs = bound(genome_bytes(gt, mask) + 4 * dim * pop,
                      circuit_flops(gt, mask, n) + FLOPS_PER_AMPLITUDE_PROB * dim * pop)
        sweep = bound(8 * dim * pop + 4 * dim + pop * (self.k_max * 8 + 2 * n * 12 + 9),
                      evals * (layer_flops + FLOPS_PER_AMPLITUDE_ENERGY * dim * pop))
        bgt, _, _, bmask = self.bench
        bench = bound(genome_bytes(bgt, bmask) + 4 * dim + 4 * bgt.shape[0],
                      circuit_flops(bgt, bmask, n) + FLOPS_PER_AMPLITUDE_ENERGY * dim * bgt.shape[0])
        out = {"population_states": states, "energies_exact": energies,
               "population_probs": probs, "nft_layer_sweep": sweep, "bench": bench}
        out.update({f"{k}_folded": v for k, v in list(out.items()) if k != "bench"})
        return out


def phase_kernels(w):
    """Every slot kernel against its plain version at n=20 on the main
    path's shapes; returns per-kernel records (times, errors, bounds)."""
    import torch

    from queasars_tpu_torch.sim import slot_kernels as sk

    n, table = N_QUBITS, w.table
    records = {name: {} for name in ROUTE_KERNELS["slot"]}
    bounds = w.bounds()
    table_tol = 1e-5 * float(table.abs().max().item())
    gt, ctrl, ang, mask, pmask, smask = w.gt, w.ctrl, w.ang, w.mask, w.pmask, w.smask

    # states kernel: the prefix states of a last-layer search
    prefix = sk.population_states(gt, ctrl, ang, pmask, n)
    check_close(f"population_states [{w.pop},2,2^{n}]", prefix,
                sk.population_states_plain(gt, ctrl, ang, pmask, n), 1e-5, records,
                "population_states")
    records["population_states"].update(
        ms=time_ms(lambda: sk.population_states(gt, ctrl, ang, pmask, n), 5),
        plain_ms=time_ms(lambda: sk.population_states_plain(gt, ctrl, ang, pmask, n), 2),
    )

    # energies kernel: the fused parameter search (suffix from the prefix
    # states) and bench.py's population energies
    e_kernel = sk.energies_exact(gt, ctrl, ang, smask, table, n, prefix)
    e_again = sk.energies_exact(gt, ctrl, ang, smask, table, n, prefix)
    require(torch.equal(e_kernel, e_again), "energies kernel is not deterministic")
    check_close(f"energies_exact from prefix [{w.pop}]", e_kernel,
                sk.energies_exact_plain(gt, ctrl, ang, smask, table, n, prefix), table_tol,
                records, "energies_exact")
    e_full = sk.energies_exact(gt, ctrl, ang, mask, table, n)
    check_close(f"energies_exact from |0> [{w.pop}]", e_full,
                sk.energies_exact_plain(gt, ctrl, ang, mask, table, n), table_tol, records,
                "energies_exact")
    bgt, bctrl, bang, bmask = w.bench
    btable = w.bench_table
    check_close(f"energies_exact bench [{bgt.shape[0]}]",
                sk.energies_exact(bgt, bctrl, bang, bmask, btable, n),
                sk.energies_exact_plain(bgt, bctrl, bang, bmask, btable, n),
                1e-5 * float(btable.abs().max().item()), records, "energies_exact")
    bench_ms = time_ms(lambda: sk.energies_exact(bgt, bctrl, bang, bmask, btable, n), 5)
    say(f"  energies_exact bench [{bgt.shape[0]}, L={bgt.shape[1]}]: {bench_ms:.3f} ms "
        f"(bound {bounds['bench'][0]:.3f} ms, {bounds['bench'][1]})")
    records["energies_exact"].update(
        ms=time_ms(lambda: sk.energies_exact(gt, ctrl, ang, smask, table, n, prefix), 5),
        plain_ms=time_ms(
            lambda: sk.energies_exact_plain(gt, ctrl, ang, smask, table, n, prefix), 2),
        bench_ms=bench_ms,
    )

    # probabilities kernel: exact CVaR / the final measurement
    check_close(f"population_probs [{w.pop},2^{n}]", sk.population_probs(gt, ctrl, ang, mask, n),
                sk.population_probs_plain(gt, ctrl, ang, mask, n), 1e-5, records,
                "population_probs")
    records["population_probs"].update(
        ms=time_ms(lambda: sk.population_probs(gt, ctrl, ang, mask, n), 5),
        plain_ms=time_ms(lambda: sk.population_probs_plain(gt, ctrl, ang, mask, n), 2),
    )

    # sweep kernel: the last-layer search, maxiter 30, compared through
    # energies of the full circuits at the final angles
    args = (w.gt1, w.ctrl1, w.ang1, w.coords, w.n_free, w.active, prefix, table, n,
            SOLVE["maxiter"], 32)
    a_k, z_k = sk.nft_layer_sweep(*args)
    a_p, _ = sk.nft_layer_sweep_plain(*args)
    e_k, e_p = w.full_energies(a_k), w.full_energies(a_p)
    check_close("nft_layer_sweep recycled z vs plain energies at its angles", z_k, e_k,
                table_tol, records, "nft_layer_sweep")
    check_close("nft_layer_sweep vs plain sweep (plain energies)", e_k, e_p, table_tol,
                records, "nft_layer_sweep")
    require(torch.equal(a_k[0], w.ang1[0]), "the sweep moved an inactive individual")
    records["nft_layer_sweep"].update(
        ms=time_ms(lambda: sk.nft_layer_sweep(*args), 3),
        plain_ms=time_ms(lambda: sk.nft_layer_sweep_plain(*args), 1),
    )
    say(f"  nft_layer_sweep: mean energy {float(e_k.mean()):.4f} from "
        f"{float(w.full_energies(w.ang1).mean()):.4f}")
    return finish_records(records, bounds)


def finish_records(records, bounds):
    for name, rec in records.items():
        rec["bound"] = bounds[name]
        say(f"  {name}: {rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f} ms, bound "
            f"{rec['bound'][0]:.4f} ms by {rec['bound'][1]})")
    return records


def phase_fold_kernels(w):
    """Every fold kernel against its plain version on the slot phase's
    inputs, and the fold energies against the slot energies."""
    import torch

    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline

    n, table = N_QUBITS, w.table
    records = {name: {} for name in ROUTE_KERNELS["fold"]}
    bounds = w.bounds()
    table_tol = 1e-5 * float(table.abs().max().item())
    gt, ctrl, ang, mask, pmask, smask = w.gt, w.ctrl, w.ang, w.mask, w.pmask, w.smask

    def pipeline(m, genome=(gt, ctrl, ang)):
        return build_fold_pipeline(*genome, m, n, absorb_diag=True)

    pre_pipe, suf_pipe, full_pipe = pipeline(pmask), pipeline(smask), pipeline(mask)
    say(f"  fold pipelines: absorbed phases {int(full_pipe.abs_count.sum())}, diagonal-pass "
        f"phases {int(full_pipe.diag_count.sum())}; group FLOPs per call: prefix "
        f"{fold_flops(pre_pipe, n):.3e}, suffix {fold_flops(suf_pipe, n):.3e}, full "
        f"{fold_flops(full_pipe, n):.3e}")

    # states: the prefix states of a last-layer search
    prefix = fk.population_states_folded(pre_pipe, n)
    check_close(f"population_states_folded [{w.pop},2,2^{n}]", prefix,
                fk.population_states_folded_plain(pre_pipe, n), 1e-5, records,
                "population_states_folded")
    check_close("population_states_folded vs slot population_states", prefix,
                sk.population_states(gt, ctrl, ang, pmask, n), 1e-5, records)
    records["population_states_folded"].update(
        ms=time_ms(lambda: fk.population_states_folded(pre_pipe, n), 5),
        plain_ms=time_ms(lambda: fk.population_states_folded_plain(pre_pipe, n), 2),
    )

    # energies: the fused parameter search's suffix from the prefix states,
    # from |0>, and bench.py's shape; each also against the slot kernel
    e_kernel = fk.energies_exact_folded(suf_pipe, table, n, prefix)
    require(torch.equal(e_kernel, fk.energies_exact_folded(suf_pipe, table, n, prefix)),
            "fold energies kernel gives other bits for equal inputs")
    check_close(f"energies_exact_folded from prefix [{w.pop}]", e_kernel,
                fk.energies_exact_folded_plain(suf_pipe, table, n, prefix), table_tol, records,
                "energies_exact_folded")
    check_close("energies_exact_folded vs slot energies_exact (from prefix)", e_kernel,
                sk.energies_exact(gt, ctrl, ang, smask, table, n, prefix), table_tol, records)
    e_full = fk.energies_exact_folded(full_pipe, table, n)
    check_close(f"energies_exact_folded from |0> [{w.pop}]", e_full,
                fk.energies_exact_folded_plain(full_pipe, table, n), table_tol, records,
                "energies_exact_folded")
    check_close("energies_exact_folded vs slot energies_exact (from |0>)", e_full,
                sk.energies_exact(gt, ctrl, ang, mask, table, n), table_tol, records)
    bgt, bctrl, bang, bmask = w.bench
    btable = w.bench_table
    bench_pipe = pipeline(bmask, (bgt, bctrl, bang))
    b_fold = fk.energies_exact_folded(bench_pipe, btable, n)
    btol = 1e-5 * float(btable.abs().max().item())
    check_close(f"energies_exact_folded bench [{bgt.shape[0]}]", b_fold,
                fk.energies_exact_folded_plain(bench_pipe, btable, n), btol, records,
                "energies_exact_folded")
    check_close("energies_exact_folded bench vs slot energies_exact", b_fold,
                sk.energies_exact(bgt, bctrl, bang, bmask, btable, n), btol, records)
    bench_ms = time_ms(lambda: fk.energies_exact_folded(bench_pipe, btable, n), 5)
    say(f"  energies_exact_folded bench [{bgt.shape[0]}, L={bgt.shape[1]}]: {bench_ms:.3f} ms "
        f"(bound {bounds['bench'][0]:.3f} ms, {bounds['bench'][1]}; group FLOPs "
        f"{fold_flops(bench_pipe, n):.3e})")
    records["energies_exact_folded"].update(
        ms=time_ms(lambda: fk.energies_exact_folded(suf_pipe, table, n, prefix), 5),
        plain_ms=time_ms(lambda: fk.energies_exact_folded_plain(suf_pipe, table, n, prefix), 2),
        bench_ms=bench_ms,
    )

    # probabilities: the whole circuits (CVaR / the final measurement)
    probs = fk.population_probs_folded(full_pipe, n)
    check_close(f"population_probs_folded [{w.pop},2^{n}]", probs,
                fk.population_probs_folded_plain(full_pipe, n), 1e-5, records,
                "population_probs_folded")
    check_close("population_probs_folded vs slot population_probs", probs,
                sk.population_probs(gt, ctrl, ang, mask, n), 1e-5, records)
    records["population_probs_folded"].update(
        ms=time_ms(lambda: fk.population_probs_folded(full_pipe, n), 5),
        plain_ms=time_ms(lambda: fk.population_probs_folded_plain(full_pipe, n), 2),
    )

    # folded sweep: the last-layer search from the folded prefix, compared
    # through plain energies of the full circuits at its final angles
    meta = [torch.as_tensor(m, device=DEVICE) for m in fk.fold_sweep_metadata(
        w.gt1.cpu().numpy(), w.ctrl1.cpu().numpy(), n)]
    args = (w.gt1, w.ang1, w.coords, w.n_free, w.active, prefix, table, *meta, n,
            SOLVE["maxiter"], 32)
    a_k, z_k = fk.nft_layer_sweep_folded(*args)
    a_p, _ = fk.nft_layer_sweep_folded_plain(*args)
    e_k, e_p = w.full_energies(a_k), w.full_energies(a_p)
    check_close("nft_layer_sweep_folded recycled z vs plain energies at its angles", z_k, e_k,
                table_tol, records, "nft_layer_sweep_folded")
    check_close("nft_layer_sweep_folded vs plain folded sweep (plain energies)", e_k, e_p,
                table_tol, records, "nft_layer_sweep_folded")
    require(torch.equal(a_k[0], w.ang1[0]), "the folded sweep moved an inactive individual")
    records["nft_layer_sweep_folded"].update(
        ms=time_ms(lambda: fk.nft_layer_sweep_folded(*args), 3),
        plain_ms=time_ms(lambda: fk.nft_layer_sweep_folded_plain(*args), 1),
    )
    say(f"  nft_layer_sweep_folded: mean energy {float(e_k.mean()):.4f} from "
        f"{float(w.full_energies(w.ang1).mean()):.4f}")
    return finish_records(records, bounds)


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


def reset_launch_counts():
    from queasars_tpu_torch.sim import fold_kernels, slot_kernels

    slot_kernels.reset_launch_counts()
    fold_kernels.reset_launch_counts()


def launch_counts() -> dict:
    from queasars_tpu_torch.sim import fold_kernels, slot_kernels

    return {**slot_kernels.launch_counts, **fold_kernels.launch_counts}


def use_route(route: str) -> None:
    """Select a solve route as a user would: ``QUEASARS_MXU=0`` for the slot
    route, unset (the default) for the fold route."""
    import os

    if route == "slot":
        os.environ["QUEASARS_MXU"] = "0"
    else:
        os.environ.pop("QUEASARS_MXU", None)


def phase_solve(route, seed, encoder, hamiltonian, table):
    """Config 4 on one route; returns that run's launch counts."""
    import numpy as np

    from queasars_tpu_torch.genome import PackedPopulation
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    use_route(route)
    solver = config4_solver(_GenerationClock())
    reset_launch_counts()
    start = time.perf_counter()
    result = solver.compute_minimum_eigenvalue(hamiltonian)
    seconds = time.perf_counter() - start
    launches = launch_counts()
    evals = int(sum(result.circuit_evaluations))
    best_state = max(result.eigenstate, key=result.eigenstate.get)
    bits = format(best_state, f"0{hamiltonian.n_qubits}b")
    say(f"phase solve ({route} route): instance seed {seed}, {result.generations} generations "
        f"in {seconds:.2f} s, {evals} evaluations ({evals / seconds:.1f}/s), eigenvalue "
        f"{result.eigenvalue:.6f}, best bitstring {bits} (p={result.eigenstate[best_state]:.4f})")
    say(f"  launches over the solve: {launches}")
    require(result.generations == SOLVE["generations"], "the solve stopped early")
    for name in ROUTE_KERNELS[route]:
        require(launches[name] > 0, f"kernel {name} was not launched on the {route} route")
    if route == "fold":
        require(launches["nft_layer_sweep"] == 0, "the slot sweep ran on the fold route")
    else:
        require(not any(launches[name] for name in ROUTE_KERNELS["fold"]),
                "a fold kernel ran on the slot route")

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
        workload = Workload(table)
        records = phase_kernels(workload)
        say("phase kernels: all four slot kernels agree with their plain versions")
        records.update(phase_fold_kernels(workload))
        say("phase fold kernels: all four fold kernels agree with their plain versions "
            "and the slot route")
        launches = {}
        for route in ROUTE_KERNELS:
            counts = phase_solve(route, seed, encoder, hamiltonian, table)
            launches.update({name: counts[name] for name in ROUTE_KERNELS[route]})
    except Failure as failure:
        say(f"FAILED: {failure}")
        return 1

    kernels = [
        {
            "name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
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
