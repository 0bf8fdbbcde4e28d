#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in the order they run, each printing one flushed progress line
with elapsed seconds:

1. device: the card's name and power limit, TF32 matmuls off;
2. build: the CUDA kernels (``queasars_tpu_torch/csrc/*.cu``: slot, fold
   and compacted-gate kernels), one nvcc process per source started
   together and one link, printing the commands, seconds and
   ``-Xptxas -v`` lines;
3. slot kernels at full width (n=20): every slot kernel against its plain
   PyTorch version on the same inputs on the card, timed with CUDA events,
   with the slot engine's plane bytes per call and GB/s (rows 1, 2, 5)
   and the sweep's bytes by its design's rule and GB/s (row 3); then the
   NFT step kernel's steps against the PyTorch step loop on the card, bit
   for bit, and the time of a step's bookkeeping on each;
4. fold kernels at the same shapes: every fold kernel against its plain
   version, the fold energies against the slot energies (the two routes
   compute one function), equal bits from equal inputs, timings, the
   folded sweep's design bytes and GB/s (row 8); then the fold pipeline's
   build kernel (row F0) against the PyTorch build on the card (integer
   fields equal, float fields within 2 ulps), and the host microseconds
   to issue a build and the device microseconds of a launch of each;
5. sampled kernels at the same shapes with 512 shots (threefry uniforms,
   ``queasars_tpu_torch/utils/prng.py``), from |0...0> and from prefix
   states: each against its plain version and the fold sampler against the
   slot sampler (equal draws, every other draw a boundary draw), equal bits
   on a repeat, the mean shot energy against the exact energy; the
   epilogue alone beside ``torch.cumsum`` + ``torch.searchsorted``; then
   ``bench.py``'s sampler shape (P=32, 5 layers, 512 terms, CVaR 0.5)
   through the objective on each route;
6. grouped kernel at the sampled phase's shapes: the 20-qubit transverse-
   field Ising chain of config 2's constants (2 QWC groups) and the JAX
   package's molecular-like operator (40 random 3-local terms, seed 7), from
   |0...0> and from prefix states: the one-launch grouped sampler against
   its plain version (equal draws, every other one a boundary draw), against
   the folded sampler once per group on the extended pipeline (equal bits),
   equal bits on a repeat, every group's mean shot energy against its exact
   energy, the grouped exact energies against the term scan; times of the
   kernel, the per-group route and the plain version;
7. compacted-gate kernels: first their main path, ``tools/port_compact.py``'s,
   once at ``bench.py``'s shape (P=32, 5 real layers in the 6-layer bucket,
   512-term table): the compaction's statistics and host time, equal bits
   to the slot energies and probabilities kernels, sustained evaluations/s
   of the compact and slot energies kernels over 40 angle perturbations x 3
   repeats; its launches are the two kernels' counts.  Then at the bench
   shape and at the slot phase's (P=16, L=6, JSSP table): both kernels
   against their plain versions, equal bits on a repeat and (slot phase
   shape) to the slot kernels, times in turns with the slot kernels, and
   their design bytes (the slot engine's rule, counted from the lists) and
   GB/s beside a bound of those bytes;
8. solve, slot route (``QUEASARS_MXU=0``): the 20-qubit 3x3 JSSP instance
   under the repository's config 4 (population 16, NFT maxiter 30, 4
   generations, ``pack_min_layers=6``, seed 0) through
   ``EVQEMinimumEigensolver.compute_minimum_eigenvalue``, with every
   kernel's launch count over that solve, then two checks of its result;
9. solve, fold route (``QUEASARS_MXU`` unset, the JAX package's default):
   the same solve and checks; the fold kernels must carry it;
10. config 3 per route (slot, then fold): the 18-qubit 3x3 JSSP instance
   with a 512-shot sampler (seed 0), CVaR 0.5, tournament selection of size
   2 (experiments/exp_baseline_configs.py:128-141); the route's sampled
   kernel must carry it, its best bitstring's table energy must be the
   Hamiltonian's, its final distribution must hold 512 shots and its
   eigenvalue lie within 5 sigma / sqrt(alpha * shots) of the best
   individual's exact CVaR;
11. the TFIM-20 sampler solve per route (slot, then fold): config 2's
   operator family and optimizer (five-point NFT, maxiter 20, population
   20, 3 generations) under config 3's 512-shot sampler, tournament
   selection of size 2; the fold route must run on the grouped kernel and
   the slot route on the slot sampler, the eigenvalue must be negative and
   lie within 5 sqrt(sum_g w_g^2 / S_g) of the best individual's exact
   energy (term scan), and the final distribution must hold 512 shots;
12. config 2 (experiments/exp_baseline_configs.py:116-126, uncut): the
   exact-estimator 12-qubit TFIM solve, five-point NFT, population 20, 3
   generations; its parameter search runs the per-slot loop over the
   states kernel (row 2), and no row 1, 5, 6 or 10 kernel may launch; the
   eigenvalue lies at or above the dense ground energy and below 0, and
   equals the best individual's energy by the plain version to
   1e-5 * sum|c|;
13. config 5 (:154-169, uncut): MoG-VQE on a 6-qubit Heisenberg chain;
   the eigenvalue at or above the ground energy - 1e-3, the Pareto front
   printed, non-empty, mutually non-dominated and holding the generation's
   best energy;
14. SPSA on config 4's 20-qubit instance per route (generations 4 -> 3,
   30 steps, 10 calibration pairs, printed as ``reduced``): rows 1 and 2
   on the slot route and not row 6, row 6 on the fold route; the
   eigenvalue at or above the table's minimum and equal to the best
   individual's plain energy to 1e-5 * max|table|; then one host-stepped
   ``BatchedSPSA.minimize`` call at n=20 with a termination checker per
   individual (each stops at its maxfev: nfev is the checkers' and a
   stopped individual's angles stay as they were at its stop);
15. COBYLA on config 1's 8-qubit instance (:104-113; 2 generations of 5,
   30 iterations): row 1 launches, the eigenvalue finite and at or above
   the table's minimum;
16. SPSA's routes from the same keys: the solves' first-generation gap and
   a calibrated last-layer call's gap after 1-8 steps printed (calibrated
   SPSA amplifies rounding 3-10x per step), and the same call at a fixed
   rate over 8 steps held to 1e-5 * max|table|;
17. a gradient EVQE solve of config 4's instance on the default route
   (``BatchedGradientDescent``, maxiter 10, learning rate 0.1; generations
   4 -> 2, printed as ``reduced``): row 1 (selection), row 2 (prefix
   states) and row 9 once (the final distribution) launch, no sweep or
   sampler row does, the generation best does not rise, the eigenvalue
   equals the plain version's energy of the best individual;
18. one last-layer gradient ``minimize`` call at n=20 (P=16): its energies
   against row 6 at the returned angles, the autograd gradient along a
   seeded direction against row 1's central difference at eps = 1e-2, the
   angles off the free coordinates bit-equal; then ``use_fold`` on and off
   (maxiter 5): finite results, the fold applier's gradient against the
   slot engine's to 5e-5 * max|table| and both against the slot engine's
   float64 gradient to 1e-6 * max|table|, both times;
19. QAOA on config 4's table with ``QAOAConfiguration``'s defaults, exact
   and with 512 shots: the start energies and gradients against the CPU's,
   a normalised state, the best bitstring's energy equal to the table's
   (and the Hamiltonian's in float64), an eigenvalue at or below the best
   start energy (the starts that rose are printed), no kernel;
20. ADAPT-VQE on config 2's TFIM-12 (full pool, depth 8, 100 steps) and on
   config 4's 20-qubit table (linear pool, depth 4, 50 steps): the first
   screen against the CPU's, the first pick the screen's maximum, energies
   that do not rise, no kernel;
21. QNEAT on config 4's instance (population 16, 3 generations), pure and
   with an NFT polish: row 1 in every generation, a best-so-far that does
   not rise, the eigenvalue equal to rows 6 and 1's energy of the best
   individual, the evaluation count the reference's formula;
22. the command line (``queasars_tpu_torch.__main__.main``) in this process
   on config 4's instance written by the port's JSSP codec, on the fold
   then the slot route: a 4-generation run writing ``--output`` (decoded
   by the port's result decoder), then a run stopped after 2 generations
   with ``--checkpoint`` and resumed to 4 with ``--resume``, whose best per
   generation, ledger, eigenvalue and likeliest state must equal the
   uninterrupted run's bit for bit, with the route's kernels launched; then
   ``python -m queasars_tpu_torch solve`` once in a subprocess (exit 0);
23. the same crash and resume on config 3's instance with the CLI's
   sampler (512 shots, CVaR 0.5; row 10 draws the resumed stream) and with
   ``--algorithm qneat`` on config 4's (2 + 1 generations against 3);
24. an external backend: a ``CallbackCircuitEvaluator`` whose callable
   rebinds and packs the circuits and returns the port's own evaluator's
   energies on config 4's table: equal to ``evaluate_packed`` on a P=16,
   5-layer population; an EVQE solve through it (2 generations, NFT
   maxiter 10) stepping NFT on the host (row 1 and row 9 only, best so far
   not rising); one SPSA ``minimize`` call ending at or below its mean;
25. a black-box bitstring objective returning config 3's energy of the
   bitstring: per route, its values from the kernel's probabilities against
   the plain version's on the same keys (draws >= 99% slot, 97.5% fold,
   equal values where an individual's draws all agree), recomputed in
   float64 on the host from the counts read back; then
   ``compute_minimum_function_value`` (512 shots, CVaR 0.5, P=16, 2
   generations), the objective called once per distinct state;
26. ``utils/profiling.trace`` around config 4's slot solve with selection
   inside ``annotate("selection")``: the exported trace names ``slot_pass``
   and the annotation once per generation;
27. the population mesh's primitives at ``bench.py``'s shape (n=20, P=32,
   5 layers, 512 terms) on ``population_mesh()`` (every visible card) and
   on four blocks of the first card, per route:
   ``sharded_population_energies`` bit-equal to the unsharded row 1 / row 6
   call, ``sharded_training_step`` (4 NFT steps) bit-equal on both meshes;
28. config 4 per route and config 3's sampler solve (slot route),
   unsharded, on ``population_mesh()`` and on four blocks: the two meshes'
   trajectories equal bit for bit, each mesh solve launching its route's
   kernels (the prefix cache is off under a mesh, so no sweep);
29. two processes on the card joined by ``torch.distributed`` on gloo (both
   ranks on the first card), each solving config 4 on the slot route over
   the two-process mesh (generations cut 4 -> 2, printed as ``reduced``):
   both ranks equal the one-process two-block solve bit for bit;
30. ADAPT-VQE (b)'s first pool screen on four blocks equal to the unsharded
   screen bit for bit; ``python -m queasars_tpu_torch solve --n-devices 1``
   on config 4 (slot route) equal to the ``population_mesh(1)`` solve;
31. amplitude sharding's primitives at n=22 (config 8's table, P=16, 6
   layers) on the 1x1, 1x2, 1x4 and 2x2 meshes of the card, per route (fold,
   per-gate): energies bit-equal across the factorizations and within
   1e-5 * max|table| of row 6 / row 1 unsharded; every shard kernel (rows
   S1-S4, ``csrc/shard_kernels.cu``) bit-equal to its plain version at the
   1x4 shard shape, timed beside its bound (and ``torch.cumsum`` for S4);
32. config 8 (experiments/exp_solve_n22.py:70-78: 22 qubits, P=16, NFT
   maxiter 30, 3 generations) on four cells of the card (``shard_amplitudes``
   unset, so 1x4) per route, the likeliest bitstring's energy against the
   Hamiltonian's float64 terms; the 2x2 factorization (generations cut,
   printed as ``reduced``) gives the same trajectory bit for bit;
33. config 7 (:54-65: 21 qubits, 512 shots, CVaR 0.5; generations cut)
   with ``shard_amplitudes=True`` on 2 cells; exact CVaR bit-equal on 1, 2
   and 4 cells; TFIM-20 grouped shots bit-equal on 2 and 4; TFIM-20's
   general exact energies against the unsharded term scan;
34. sharded QAOA energies and gradients on config 4's table, bit-equal on 2
   and 4 cells and near the unsharded QAOA, and a cut sharded QAOA solve;
   ``--shard-amplitudes --n-devices 1`` through the CLI in process on config
   8 (1 generation) equal to the 1x4 solve; two gloo processes with one
   shard each on the card, whose exact energies and last-layer NFT sweep
   equal one process with 2 cells.

Phases 12-15 print their solve seconds, evaluations per second, the card's
name and power limit, and their launches per kernel row; phases 17-26 also
their peak device memory; phases 27-30 report their launch counts apart
from the earlier phases'; phases 31-34 print seconds, evaluations/s, peak
memory and launches per row, and the shard exchanges' bytes.

The line before the last is a JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.  Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import importlib
import itertools
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
#: the repository's config 3: its solve settings and its sampler
CONFIG3 = dict(SOLVE, qubits=18, shots=512, sampler_seed=0, alpha=0.5, tournament_size=2)
#: shots and key seed of the sampled-kernel phase
SAMPLED = dict(shots=512, seed=3)
#: bench.py's workload for population energies
BENCH = dict(population=32, layers=5, terms=512)
#: config 2's TFIM constants (experiments/exp_baseline_configs.py:117) and
#: the JAX package's molecular-like operator (experiments/
#: exp_grouped_pallas.py:65-78) for the grouped-kernel phase
TFIM = dict(coupling=1.0, field=0.9)
MOLECULAR = dict(terms=40, seed=7)
#: the TFIM-20 sampler solve: config 2's operator family, optimizer,
#: population and generations under config 3's sampler and selection
#: share of the grouped sampler's draws that must equal its plain
#: version's (see phase_grouped_kernels)
GROUPED_DRAW_BAR = 0.965
TFIM20 = dict(qubits=20, population=20, maxiter=20, generations=3, shots=512, sampler_seed=0,
              tournament_size=2, pack_min_layers=6, seed=0)
#: BASELINE's config 2 (experiments/exp_baseline_configs.py:116-126): the
#: 12-qubit TFIM, exact estimator, five-point NFT
CONFIG2 = dict(qubits=12, population=20, maxiter=20, generations=3, seed=0)
#: BASELINE's config 5 (:154-169): MoG-VQE on a 6-qubit Heisenberg chain
CONFIG5 = dict(qubits=6, population=16, maxiter=10, generations=3, seed=0)
#: SPSA on config 4's 20-qubit instance, cut (printed as ``reduced``):
#: BASELINE's 4 generations to 3, SPSAConfig's 100 steps and 25 calibration
#: pairs to 30 and 10
SPSA4 = dict(SOLVE, generations=3, maxiter=30, calibration_steps=10)
#: COBYLA on config 1's 8-qubit instance (:104-113), its 5 generations cut to 2
CONFIG1 = dict(qubits=8, population=10, maxiter=30, generations=2, seed=0)
#: the host-stepped SPSA call with termination checkers (n=20)
SPSA_CHECKED = dict(population=16, layers=3, maxiter=12, calibration_steps=4, seed=5)
#: the gradient EVQE solve on config 4's instance, its 4 generations cut to 2
GRADIENT4 = dict(SOLVE, generations=2, maxiter=10, learning_rate=0.1)
#: the direct gradient minimize call at n=20 and its use_fold comparison
GRADIENT_CALL = dict(population=16, layers=3, seed=9)
USE_FOLD_CALL = dict(maxiter=5)
#: QAOA's sampled run
QAOA_SHOTS = 512
#: ADAPT-VQE: (a) config 2's TFIM-12, (b) config 4's 20-qubit table
ADAPT_TFIM = dict(pool="full", max_depth=8, optimizer_maxiter=100)
ADAPT_JSSP = dict(pool="linear", max_depth=4, optimizer_maxiter=50)
#: QNEAT on config 4's instance, pure and with an NFT polish
QNEAT4 = dict(population=16, generations=3, seed=0, nft_maxiter=10)
#: the command line on config 4's instance: a run of 4 generations, and one
#: stopped after 2 then resumed to 4 from its checkpoint
CLI4 = dict(population=16, nft_maxiter=30, seed=0, generations=4, crash_at=2)
#: the sampler's resume on config 3's instance (512 shots, CVaR 0.5): 2 + 2
#: generations against 4; QNEAT's on config 4's: 2 + 1 against 3
CLI3 = dict(shots=512, alpha=0.5, generations=4, crash_at=2)
CLI_QNEAT = dict(generations=3, crash_at=2)
#: the external backend on config 4's table: the P=16, 5-layer population of
#: bar (a), an EVQE solve (NFT maxiter 10, generations 4 -> 2) and one SPSA
#: call (maxiter 10)
EXTERNAL = dict(population=16, layers=5, seed=21, maxiter=10, generations=2, spsa_maxiter=10)
#: the bitstring-function solve on config 3's energies: 512 shots, CVaR 0.5,
#: P=16, NFT maxiter 10, generations 4 -> 2
FUNCTION3 = dict(shots=512, alpha=0.5, population=16, maxiter=10, generations=2, seed=0,
                 layers=5)
#: draws from the probabilities kernels that must equal the plain
#: versions': row 4's states equal the plain version's bits but its squared
#: magnitudes round differently (4.7e-10 apart at n=20), so a draw on a bin
#: boundary can flip, as on the sampled kernels' bars
SLOT_DRAW_BAR = 0.99
FOLD_DRAW_BAR = 0.975
#: kernel -> its row in PERF.md's kernel table
ROWS = {
    "energies_exact": 1, "population_states": 2, "nft_layer_sweep": 3, "population_probs": 4,
    "sampled_shot_indices": 5, "energies_exact_folded": 6, "population_states_folded": 7,
    "nft_layer_sweep_folded": 8, "population_probs_folded": 9,
    "sampled_shot_indices_folded": 10, "grouped_shot_indices_folded": 11,
    "compact_energies_exact": 12, "compact_probs": 13,
    "shard_pair_combine": "S1", "shard_group_product": "S2", "shard_diag_phase": "S3",
    "shard_running_sum": "S4",
}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside
#: the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
#: U3 on an amplitude pair: u00 = cos(theta/2) is real, so the first output
#: takes 2 + 6 + 2 operations and the second 6 + 6 + 2
FLOPS_PER_PAIR = 24
FLOPS_PER_AMPLITUDE_ENERGY = 5  # (re^2 + im^2) * table, accumulated
FLOPS_PER_AMPLITUDE_PROB = 3
FLOPS_PER_AMPLITUDE_SAMPLE = 4  # |psi|^2 and one add of the running sum
#: the sweeps' pair sums: |a|^2, |b|^2, Re and Im a b* (12) and eight
#: products accumulated (16) per pair the probed gate acts on; T |x|^2
#: accumulated (5) per amplitude where a CU3's control bit is 0
FLOPS_PER_PAIR_SUMS = 28
FLOPS_PER_AMPLITUDE_OFF = 5
#: the sweeps' reset_interval (NFTConfig's default)
SWEEP_RESET = 32
SLOT_SOURCE = "queasars_tpu_torch/csrc/slot_kernels.cu"
FOLD_SOURCE = "queasars_tpu_torch/csrc/fold_kernels.cu"
COMPACT_SOURCE = "queasars_tpu_torch/csrc/compact_kernels.cu"
STEP_SOURCE = "queasars_tpu_torch/csrc/nft_step.cu"
BUILD_SOURCE = "queasars_tpu_torch/csrc/fold_build.cu"
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
    "sampled_shot_indices": (SLOT_SOURCE, "queasars_tpu/sim/pallas_kernels.py:660"),
    "sampled_shot_indices_folded": (
        FOLD_SOURCE, "queasars_tpu/sim/pallas_fold_kernels.py:795"),
    "grouped_shot_indices_folded": (
        FOLD_SOURCE, "queasars_tpu/sim/pallas_fold_kernels.py:1043"),
    "compact_energies_exact": (COMPACT_SOURCE, "queasars_tpu/sim/compact_kernels.py:338"),
    "compact_probs": (COMPACT_SOURCE, "queasars_tpu/sim/compact_kernels.py:353"),
    "nft_step": (STEP_SOURCE, "none: the NFT step's bookkeeping (XLA inside the JAX jit)"),
    "fold_build": (BUILD_SOURCE, "none: build_fold_pipeline's jnp algebra (XLA; "
                   "queasars_tpu/sim/fold_pipeline.py:207)"),
}
#: the compacted-gate kernels, which no solve launches: their launches are
#: counted over tools/port_compact.py's path (phase 7)
COMPACT_KERNELS = ("compact_energies_exact", "compact_probs")
#: the kernels each solve route must launch (the folded probabilities
#: kernel carries the fold route's final measurement distribution)
ROUTE_KERNELS = {
    "slot": ("energies_exact", "population_states", "nft_layer_sweep", "population_probs"),
    "fold": ("energies_exact_folded", "population_states_folded", "nft_layer_sweep_folded",
             "population_probs_folded"),
}
#: the kernels config 3 must launch on each route (prefix states come from
#: the slot states kernel at n=18 on both, as in the reference)
SAMPLER_ROUTE_KERNELS = {
    "slot": ("sampled_shot_indices", "population_states", "population_probs"),
    "fold": ("sampled_shot_indices_folded", "population_states", "population_probs_folded"),
}
#: the kernels the TFIM-20 solve must launch on each route, and the sampled
#: kernels it must not (grouped shots: one launch per group on the slot
#: route, the one-launch grouped kernel on the fold route)
TFIM_ROUTE_KERNELS = {
    "slot": ("sampled_shot_indices", "population_states", "population_probs"),
    "fold": ("grouped_shot_indices_folded", "population_states", "population_probs_folded"),
}
TFIM_ROUTE_FORBIDDEN = {
    "slot": ("grouped_shot_indices_folded", "sampled_shot_indices_folded"),
    "fold": ("sampled_shot_indices", "sampled_shot_indices_folded"),
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


def jssp_with_qubits(n_jobs, n_machines, makespan_limit, want_qubits, op_duration, rel=0.5):
    """The first seeded random JSSP instance whose Hamiltonian has
    ``want_qubits`` qubits (experiments/exp_baseline_configs.py:48-58)."""
    from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
    from queasars_tpu_torch.problems.jssp.random_instances import (
        random_job_shop_scheduling_instance,
    )

    for seed in range(200):
        instance = random_job_shop_scheduling_instance(
            instance_name=f"bl-{seed}", n_jobs=n_jobs, n_machines=n_machines,
            relative_op_amount=rel, op_duration=op_duration, random_seed=seed,
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


def molecular_like(n_qubits, n_terms, seed):
    """Random 3-local mixed-basis Pauli strings with normal coefficients
    (numpy seed): the JAX package's molecular-like operator
    (experiments/exp_grouped_pallas.py:65-78), O(10) QWC groups at 40
    terms."""
    import numpy as np

    from queasars_tpu_torch.paulis import PauliSum

    rng = np.random.default_rng(seed)
    terms = []
    for _ in range(n_terms):
        qubits = rng.choice(n_qubits, size=3, replace=False)
        label = ["I"] * n_qubits
        for q in qubits:
            label[n_qubits - 1 - int(q)] = "XYZ"[rng.integers(3)]
        terms.append(PauliSum.from_label("".join(label), float(rng.normal())))
    return PauliSum.sum(terms)


def tfim20():
    """The TFIM-20 operator: config 2's builder and constants at n=20."""
    from queasars_tpu_torch.problems.spin_chains import transverse_field_ising

    return transverse_field_ising(TFIM20["qubits"], **TFIM)


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
    say(f"phase build: {info.seconds:.2f} s, {len(info.commands) - 1} nvcc compiles in parallel "
        "and one link:")
    for command in info.commands:
        print(f"    {' '.join(command)}", flush=True)
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


def probs_tolerance(plain) -> float:
    """1e-5 of the largest probability: at n=20 the mean probability is
    2^-20, far below an absolute 1e-5."""
    return 1e-5 * float(plain.max())


def draw_agreement(probs, u_frac, got, want, rel=1e-5):
    """(share of equal draws, number of differing draws that are not
    boundary draws) of two samplers' indices [P, S] at the uniforms
    ``u_frac`` [P, S].  A differing draw is a boundary draw when
    ``u = frac * total`` lies within ``rel * total`` of the running sum
    (float64, from ``probs`` [P, 2^n]) at both ends of the gap between
    the two indices: a rounding-level flip into the neighbouring bin."""
    import torch

    same = got == want
    cdf = torch.cumsum(probs.double(), dim=-1)
    total = cdf[:, -1:]
    u = u_frac.double() * total
    lo = torch.minimum(got, want).long()
    hi = torch.maximum(got, want).long()
    off = torch.maximum((u - cdf.gather(1, lo)).abs(),
                        (u - cdf.gather(1, (hi - 1).clamp(min=0))).abs())
    bad = ~same & (off > rel * total)
    return float(same.double().mean()), int(bad.sum())


def engine_bytes(pipeline, n_qubits, rotated=()) -> int:
    """Plane traffic of the fold engine's circuit by its design's rule
    (n > 13): two passes per kron layer and individual where the layer has
    work (an active axis group, or a phase after it), each reading and
    writing the [2, 2^n] float32 planes.  A pass whose own part of the
    layer is idle skips, so this may count more than moves.  ``rotated``:
    the grouped sampler's pipelines extended by each rotated group's layer;
    each adds its rotation layer's passes."""
    work = pipeline.group_active.bool().any(dim=2)
    work[:, :-1] |= (pipeline.diag_count + pipeline.abs_count) > 0
    circuit = int(work.sum()) * 2 * 2 * (8 << n_qubits)
    return circuit + sum(engine_bytes(ext, n_qubits) - circuit for ext in rotated)


def slot_engine_bytes(gate_types, layer_mask, n_qubits) -> int:
    """Plane traffic of the slot engine's circuit by its design's rule
    (14 <= n <= 22): two passes per layer and individual where the layer
    has an active slot (a U3 or CU3 in a layer that is on), each reading
    and writing the [2, 2^n] float32 planes.  A pass with no slot of its
    own skips, so this may count more than moves."""
    active = ((gate_types == 1) | (gate_types == 3)) & layer_mask[:, :, None]
    return int(active.any(dim=2).sum()) * 2 * 2 * (8 << n_qubits)


def compact_engine_bytes(compact, n_qubits) -> int:
    """Plane traffic of the compacted-gate kernels' circuit by the slot
    engine's rule (14 <= n <= 22), counted from the lists themselves: two
    passes per individual and layer whose segment holds a gate, each
    reading and writing the [2, 2^n] float32 planes.  Equal to
    ``slot_engine_bytes`` on the genome the lists were compacted from."""
    b = compact.boundaries
    return int((b[:, 2::2] > b[:, :-1:2]).sum()) * 2 * 2 * (8 << n_qubits)


def engine_rate(name, moved, ms) -> str:
    """An engine's bytes for one call (``engine_bytes``,
    ``slot_engine_bytes``, ``compact_engine_bytes`` or
    ``sweep_engine_bytes``) and those bytes over
    the call's measured time."""
    rate = moved / ms * 1e3
    return (f"{name}: engine {moved / 1e9:.4f} GB per call in {ms:.3f} ms, {rate / 1e9:.1f} GB/s "
            f"({rate / PEAK_BYTES_PER_S:.1%} of 3.35 TB/s)")


def sweep_plan(gate_types, coords, n_free, active, n_qubits, maxiter, reset_interval):
    """The sweeps' schedule by their design's rule (csrc/sweep.cuh) on these
    inputs: each rebuild step's probed qubit per individual, every
    transition (individual, last qubit, next qubit), and the sweep_pass
    launches (one per rebuild and per step with a transition)."""
    gt = gate_types.cpu().numpy()
    qubits = coords[:, :, 0].cpu().numpy().clip(0, n_qubits - 1)
    n_free, active = n_free.cpu().numpy(), active.cpu().numpy()
    pop = gt.shape[0]

    def probed(k):
        return [int(qubits[p, k % max(int(n_free[p]), 1)]) for p in range(pop)]

    rebuilds, transitions, launches = [], [], 0
    for k in range(max(maxiter, 1)):
        now = probed(k)
        if k % reset_interval == 0:
            rebuilds.append(now)
            launches += 1
            continue
        last = probed(k - 1)
        moved = [(p, last[p], now[p]) for p in range(pop)
                 if active[p] and n_free[p] > 0 and last[p] != now[p]]
        transitions += moved
        launches += 1 if moved else 0
    return {"gate_types": gt, "n_qubits": n_qubits, "rebuilds": rebuilds,
            "transitions": transitions, "launches": launches}


def sweep_engine_bytes(plan, route) -> int:
    """Device-memory traffic of one sweep call by its design's rule: per
    rebuild and individual the route's engine on the swept layer (slot: one
    read+write pass at n <= 13, two above; fold: the same per kron layer
    with work, the V^dagger layer where the layer holds a CU3; an engine
    with nothing to apply copies once) and one read of BASE for the sums;
    per transition one read and write of BASE (a read where neither gate
    applies); the table once per sweep_pass launch."""
    gt, n = plan["gate_types"], plan["n_qubits"]
    plane = 8 << n
    gated = (gt == 1) | (gt == 3)
    per_layer = 1 if n <= 13 else 2
    total = plan["launches"] * (4 << n)
    for probed in plan["rebuilds"]:
        for p, q in enumerate(probed):
            rest = gated[p].copy()
            rest[q] = False
            if route == "slot":
                passes = per_layer if rest.any() else 1
            else:
                krons = int((gt[p] == 3).any()) + int(gated[p].any())
                passes = (1 if n <= 13 else per_layer * krons) if krons else 1
            total += passes * 2 * plane + plane
    for p, last, q in plan["transitions"]:
        total += (2 if gated[p, last] or gated[p, q] else 1) * plane
    return total


def sweep_flops(plan) -> float:
    """FLOPs of one sweep call by its design's rule: each rebuild's layer
    without the probed gate, every pass's pair sums, and each transition's
    two gates."""
    gt, n = plan["gate_types"], plan["n_qubits"]
    pairs, dim = 1 << (n - 1), 1 << n

    def gate(p, q):
        return FLOPS_PER_PAIR * pairs * {1: 1.0, 3: 0.5}.get(int(gt[p, q]), 0.0)

    def sums(p, q):
        acting = pairs // 2 if gt[p, q] == 3 else pairs
        return FLOPS_PER_PAIR_SUMS * acting + FLOPS_PER_AMPLITUDE_OFF * (dim - 2 * acting)

    total = 0.0
    for probed in plan["rebuilds"]:
        for p, q in enumerate(probed):
            total += sum(gate(p, r) for r in range(n) if r != q) + sums(p, q)
    for p, last, q in plan["transitions"]:
        total += gate(p, last) + gate(p, q) + sums(p, q)
    return total


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
        self.sweep_plan = sweep_plan(self.gt1, self.coords, self.n_free, self.active, n,
                                     SOLVE["maxiter"], SWEEP_RESET)
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
        A slot kernel and its fold counterpart share one bound.  A sweep's
        FLOPs are its design's (``sweep_flops``); ``sweep_probes`` is the
        bound of the 2 maxiter + 1 whole-layer evaluations the reference
        makes instead."""
        import torch

        dim, pop, n = 1 << N_QUBITS, self.pop, N_QUBITS
        gt, mask = self.gt, self.mask
        one = torch.ones((pop, 1), dtype=torch.bool, device=DEVICE)
        layer_flops = circuit_flops(self.gt1[:, None], one, n)
        evals = 2 * SOLVE["maxiter"] + 1 + (SOLVE["maxiter"] - 1) // SWEEP_RESET
        states = bound(genome_bytes(gt, mask) + 8 * dim * pop, circuit_flops(gt, self.pmask, n))
        energies = bound(genome_bytes(gt, mask) + 4 * dim + 8 * dim * pop + 4 * pop,
                         circuit_flops(gt, self.smask, n) + FLOPS_PER_AMPLITUDE_ENERGY * dim * pop)
        probs = bound(genome_bytes(gt, mask) + 4 * dim * pop,
                      circuit_flops(gt, mask, n) + FLOPS_PER_AMPLITUDE_PROB * dim * pop)
        sweep_bytes = 8 * dim * pop + 4 * dim + pop * (self.k_max * 8 + 2 * n * 12 + 9)
        sweep = bound(sweep_bytes, sweep_flops(self.sweep_plan))
        sweep_probes = bound(sweep_bytes,
                             evals * (layer_flops + FLOPS_PER_AMPLITUDE_ENERGY * dim * pop))
        bgt, _, _, bmask = self.bench
        bench = bound(genome_bytes(bgt, bmask) + 4 * dim + 4 * bgt.shape[0],
                      circuit_flops(bgt, bmask, n) + FLOPS_PER_AMPLITUDE_ENERGY * dim * bgt.shape[0])
        # sampled shots from |0>: genome, uniforms and indices once
        shots = SAMPLED["shots"]
        sampled = bound(genome_bytes(gt, mask) + 8 * pop * shots,
                        circuit_flops(gt, mask, n) + FLOPS_PER_AMPLITUDE_SAMPLE * dim * pop)
        bench_sampled = bound(
            genome_bytes(bgt, bmask) + 4 * dim + 8 * bgt.shape[0] * shots,
            circuit_flops(bgt, bmask, n) + FLOPS_PER_AMPLITUDE_SAMPLE * dim * bgt.shape[0])
        out = {"population_states": states, "energies_exact": energies,
               "population_probs": probs, "nft_layer_sweep": sweep,
               "sampled_shot_indices": sampled}
        out.update({f"{k}_folded": v for k, v in list(out.items())})
        out.update(bench=bench, bench_sampled=bench_sampled, sweep_probes=sweep_probes)
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
    plain_probs = sk.population_probs_plain(gt, ctrl, ang, mask, n)
    check_close(f"population_probs [{w.pop},2^{n}]", sk.population_probs(gt, ctrl, ang, mask, n),
                plain_probs, probs_tolerance(plain_probs), records, "population_probs")
    records["population_probs"].update(
        ms=time_ms(lambda: sk.population_probs(gt, ctrl, ang, mask, n), 5),
        plain_ms=time_ms(lambda: sk.population_probs_plain(gt, ctrl, ang, mask, n), 2),
    )

    # sweep kernel: the last-layer search, maxiter 30, compared through
    # energies of the full circuits at the final angles
    args = (w.gt1, w.ctrl1, w.ang1, w.coords, w.n_free, w.active, prefix, table, n,
            SOLVE["maxiter"], SWEEP_RESET)
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
    sweep_records(records["nft_layer_sweep"], w, "slot", bounds)
    for name, m in (("population_states", pmask), ("energies_exact", smask)):
        say("  " + engine_rate(name, slot_engine_bytes(gt, m, n), records[name]["ms"]))
    say("  " + engine_rate("energies_exact bench", slot_engine_bytes(bgt, bmask, n), bench_ms))
    return finish_records(records, bounds)


def phase_nft_step(w):
    """The NFT step kernel (``csrc/nft_step.cu``) under a parameter search's
    steps at n=20 (each individual's last layer, probes from the prefix
    states on the slot energies kernel): ``_nft_steps`` on the card against
    its PyTorch loop on the card, bit for bit, then both timed per step with
    an objective that launches nothing, so only the bookkeeping is timed."""
    import torch

    from queasars_tpu_torch.optim import nft
    from queasars_tpu_torch.sim import slot_kernels as sk

    n, table, maxiter = N_QUBITS, w.table, SOLVE["maxiter"]
    prefix = sk.population_states(w.gt, w.ctrl, w.ang, w.pmask, n)
    coords = torch.cat([w.last[:, None, None].expand(-1, w.k_max, 1).to(torch.int32),
                        w.coords], dim=2).long()
    args = (coords, w.n_free, w.active, maxiter, SWEEP_RESET)

    def objective(angles, keys):
        return sk.energies_exact(w.gt, w.ctrl, angles, w.smask, table, n, prefix)

    reset_launch_counts()
    a_k, z_k = nft._nft_steps(objective, w.ang, *args)
    launches = launch_counts()["nft_step"]
    a_p, z_p = nft._nft_steps_torch(objective, w.ang, *args)
    require(launches == maxiter + 1, f"the step kernel launched {launches} times")
    require(torch.equal(a_k, a_p) and torch.equal(z_k, z_p),
            "the step kernel's angles or energies differ from the PyTorch loop's")
    require(torch.equal(a_k[0], w.ang[0]), "the steps moved an inactive individual")
    energies = itertools.cycle([objective(w.ang, None) for _ in range(3)])

    def constant(angles, keys):
        return next(energies)

    moved = 4 * w.ang.numel() * 4 + 4 * 4 * w.pop
    rec = {"max_abs_err": 0.0, "bound": bound(moved, 0.0),
           "ms": time_ms(lambda: nft._nft_steps(constant, w.ang, *args), 5) / maxiter,
           "plain_ms": time_ms(lambda: nft._nft_steps_torch(constant, w.ang, *args), 5) / maxiter}
    say(f"  nft_step: {rec['ms']:.4f} ms a step (PyTorch loop {rec['plain_ms']:.4f} ms), "
        f"bound {rec['bound'][0]:.6f} ms by {rec['bound'][1]}; equal bits over {maxiter} steps")
    return {"nft_step": rec}


def sweep_records(rec, w, route, bounds):
    """A sweep's design-rule bytes and rate beside its time, and beside its
    bound the two others: the reference's 2 maxiter + 1 layer evaluations
    and the design's bytes over 3.35 TB/s."""
    plan = w.sweep_plan
    moved = sweep_engine_bytes(plan, route)
    rec["probe_bound"] = bounds["sweep_probes"]
    rec["design_bound"] = (moved / PEAK_BYTES_PER_S * 1e3, "bytes")
    say(f"  {route} sweep: {len(plan['rebuilds'])} rebuilds, {len(plan['transitions'])} "
        f"transitions in {plan['launches']} sweep_pass launches; bound of the reference's "
        f"layer evaluations {rec['probe_bound'][0]:.4f} ms ({rec['probe_bound'][1]}), of the "
        f"design's bytes {rec['design_bound'][0]:.4f} ms")
    name = "nft_layer_sweep" if route == "slot" else "nft_layer_sweep_folded"
    say("  " + engine_rate(name, moved, rec["ms"]))


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
        f"phases {int(full_pipe.diag_count.sum())}")

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
        f"(bound {bounds['bench'][0]:.3f} ms, {bounds['bench'][1]})")
    say("  " + engine_rate("energies_exact_folded bench", engine_bytes(bench_pipe, n), bench_ms))
    records["energies_exact_folded"].update(
        ms=time_ms(lambda: fk.energies_exact_folded(suf_pipe, table, n, prefix), 5),
        plain_ms=time_ms(lambda: fk.energies_exact_folded_plain(suf_pipe, table, n, prefix), 2),
        bench_ms=bench_ms,
    )

    # probabilities: the whole circuits (CVaR / the final measurement)
    probs = fk.population_probs_folded(full_pipe, n)
    plain_probs = fk.population_probs_folded_plain(full_pipe, n)
    check_close(f"population_probs_folded [{w.pop},2^{n}]", probs, plain_probs,
                probs_tolerance(plain_probs), records, "population_probs_folded")
    check_close("population_probs_folded vs slot population_probs", probs,
                sk.population_probs(gt, ctrl, ang, mask, n), probs_tolerance(plain_probs),
                records)
    records["population_probs_folded"].update(
        ms=time_ms(lambda: fk.population_probs_folded(full_pipe, n), 5),
        plain_ms=time_ms(lambda: fk.population_probs_folded_plain(full_pipe, n), 2),
    )

    # folded sweep: the last-layer search from the folded prefix, compared
    # through plain energies of the full circuits at its final angles
    meta = [torch.as_tensor(m, device=DEVICE) for m in fk.fold_sweep_metadata(
        w.gt1.cpu().numpy(), w.ctrl1.cpu().numpy(), n)]
    args = (w.gt1, w.ang1, w.coords, w.n_free, w.active, prefix, table, *meta, n,
            SOLVE["maxiter"], SWEEP_RESET)
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
    sweep_records(records["nft_layer_sweep_folded"], w, "fold", bounds)
    for name, pipe in (("population_states_folded", pre_pipe),
                       ("energies_exact_folded", suf_pipe),
                       ("population_probs_folded", full_pipe)):
        say("  " + engine_rate(name, engine_bytes(pipe, n), records[name]["ms"]))
    return finish_records(records, bounds)


def float_ulps(a, b):
    """Float32 units in the last place between ``a`` and ``b`` (+0 = -0)."""
    import torch

    def ordered(x):
        bits = x.contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)

    return (ordered(a) - ordered(b)).abs()


def kernel_device_us(fn, reps: int, name: str) -> float:
    """Mean device microseconds of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn``, from the profiler's CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if name in e.key]
    total = sum(getattr(e, "device_time_total", None) or e.cuda_time_total for e in rows)
    count = sum(e.count for e in rows)
    require(count == reps, f"the profiler saw {count} launches of {name}, not {reps}")
    return total / count


def phase_fold_build(w):
    """The fold pipeline's build kernel (``csrc/fold_build.cu``, row F0) on
    the slot phase's genomes (P=16, L=6, n=20, absorbed phases) against the
    PyTorch build on the card: integer fields equal, float fields within 2
    ulps.  Then each timed: host microseconds to issue a build (no
    synchronisation inside the loop; the PyTorch build's two constant
    copies wait for the card), microseconds a build with CUDA events over
    back-to-back builds, and the kernel's device microseconds a launch."""
    import torch

    from queasars_tpu_torch.sim import fold_pipeline as fp

    n, reps = N_QUBITS, 200
    genome = (w.gt, w.ctrl, w.ang, w.mask)
    before = fp.build_counts["kernel"]
    kernel = fp.build_fold_pipeline(*genome, n, absorb_diag=True)
    require(fp.build_counts["kernel"] == before + 1, "the build did not take the build kernel")
    plain = fp.build_fold_pipeline_plain(*genome, n, absorb_diag=True)
    worst, differing, max_abs = 0, 0, 0.0
    for name in fp.FoldPipeline._fields:
        a, b = getattr(kernel, name), getattr(plain, name)
        if a.dtype == torch.int32:
            require(torch.equal(a, b), f"fold build kernel: {name} differs from the PyTorch build")
            continue
        gap = float_ulps(a, b)
        worst, differing = max(worst, int(gap.max())), differing + int((gap > 0).sum())
        max_abs = max(max_abs, float((a - b).abs().max()))
    require(worst <= 2, f"fold build kernel: float fields {worst} ulps from the PyTorch build")

    def host_us(build):
        build()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            build()
        seconds = time.perf_counter() - start
        torch.cuda.synchronize()
        return seconds / reps * 1e6

    def kernel_build():
        return fp.build_fold_pipeline(*genome, n, absorb_diag=True)

    def plain_build():
        return fp.build_fold_pipeline_plain(*genome, n, absorb_diag=True)

    moved = (genome_bytes(w.gt, w.mask) + 4 * sum(t.numel() for t in kernel))
    rec = {"max_abs_err": max_abs, "bound": bound(moved, 0.0),
           "host_us": host_us(kernel_build), "plain_host_us": host_us(plain_build),
           "ms": time_ms(kernel_build, reps), "plain_ms": time_ms(plain_build, reps),
           "device_us": kernel_device_us(kernel_build, reps, "fold_build")}
    say(f"  fold_build: {rec['host_us']:.1f} us of host a build (PyTorch build "
        f"{rec['plain_host_us']:.1f} us), {rec['ms'] * 1e3:.1f} us a build back to back "
        f"(PyTorch {rec['plain_ms'] * 1e3:.1f} us), device {rec['device_us']:.2f} us a launch, "
        f"bound {rec['bound'][0] * 1e3:.4f} us by {rec['bound'][1]}; float fields within "
        f"{worst} ulps ({differing} entries not bit-equal, max |diff| {max_abs:.3e}), "
        "integer fields equal")
    return {"fold_build": rec}


def float64_probs(gt, ctrl, ang, mask, n_qubits, initial=None):
    """Probabilities of the slot engine's circuits in float64 (the plain
    engine's gate passes on float64 planes): the reference that shows how
    far float32 rounding alone moves a draw."""
    import torch

    from queasars_tpu_torch.sim.statevector import _apply_slot

    pop = gt.shape[0]
    if initial is None:
        state = torch.zeros((pop, 2, 1 << n_qubits), dtype=torch.float64, device=ang.device)
        state[:, 0, 0] = 1.0
    else:
        state = initial.double()
    for layer in range(gt.shape[1]):
        for q in range(n_qubits):
            state = _apply_slot(state, q, gt[:, layer, q], ctrl[:, layer, q],
                                ang[:, layer, q].double(), mask[:, layer], n_qubits)
    return state[:, 0] ** 2 + state[:, 1] ** 2


def phase_sampled_kernels(w):
    """Both sampled kernels against their plain versions and each other at
    n=20 with 512 shots, from |0...0> and from prefix states; the epilogue
    alone; bench.py's sampler shape through the objective on each route.

    Bars: every differing draw must be a boundary draw (u within 1e-5 of
    the total mass of the running sum at the gap); the slot sampler must
    agree with its plain version on at least 99% of draws (its circuit
    rounds as the plain one does); a comparison with the fold sampler on at
    least 97.5%: two float32 circuits of these dense 20-qubit states move
    1.3-1.9% of draws across a bin boundary whatever computes them (each
    plain version against the float64 state, printed here: 98.2-98.7%)."""
    import torch

    from queasars_tpu_torch.optim.objective import population_energies
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline
    from queasars_tpu_torch.sim.sampling import hierarchical_sample_plain
    from queasars_tpu_torch.utils import prng

    n, table, shots = N_QUBITS, w.table, SAMPLED["shots"]
    names = ("sampled_shot_indices", "sampled_shot_indices_folded")
    records = {name: {} for name in names}
    bounds = w.bounds()
    gt, ctrl, ang, mask, pmask, smask = w.gt, w.ctrl, w.ang, w.mask, w.pmask, w.smask
    keys = prng.split(prng.PRNGKey(SAMPLED["seed"]), w.pop)
    frac = prng.uniform(keys, (shots,)).to(DEVICE)
    prefix = sk.population_states(gt, ctrl, ang, pmask, n)

    def check_draws(label, probs, got, want, bar, key=None):
        share, not_boundary = draw_agreement(probs, frac, got, want)
        err = float((table[got.long()].mean(1) - table[want.long()].mean(1)).abs().max())
        say(f"  {label}: {share:.4%} of draws equal (bar {bar:.1%}), {not_boundary} differing "
            f"draws off a boundary, mean shot energy differs by at most {err:.3e}")
        require(share >= bar, f"{label}: only {share:.4%} of draws agree")
        require(not_boundary == 0, f"{label}: {not_boundary} differing draws are not boundary draws")
        if key is not None:
            records[key]["max_abs_err"] = max(records[key].get("max_abs_err", 0.0), err)

    for label, m, start in (("from |0>", mask, None), ("from prefix", smask, prefix)):
        pipe = build_fold_pipeline(gt, ctrl, ang, m, n, absorb_diag=True)
        probs = sk.population_probs_plain(gt, ctrl, ang, m, n, start)
        slot = sk.sampled_shot_indices(gt, ctrl, ang, m, frac, n, start)
        fold = fk.sampled_shot_indices_folded(pipe, frac, n, start)
        require(torch.equal(slot, sk.sampled_shot_indices(gt, ctrl, ang, m, frac, n, start)),
                "the slot sampler gives other bits for equal inputs")
        require(torch.equal(fold, fk.sampled_shot_indices_folded(pipe, frac, n, start)),
                "the fold sampler gives other bits for equal inputs")
        slot_plain = sk.sampled_shot_indices_plain(gt, ctrl, ang, m, frac, n, start)
        fold_plain = fk.sampled_shot_indices_folded_plain(pipe, frac, n, start)
        check_draws(f"sampled_shot_indices {label} vs plain", probs, slot, slot_plain, 0.99,
                    "sampled_shot_indices")
        check_draws(f"sampled_shot_indices_folded {label} vs plain", probs, fold, fold_plain,
                    0.975, "sampled_shot_indices_folded")
        check_draws(f"sampled_shot_indices_folded {label} vs slot sampler", probs, fold, slot,
                    0.975)
        exact64 = float64_probs(gt, ctrl, ang, m, n, start)
        truth = hierarchical_sample_plain(exact64, frac.double())
        say(f"  float64 state {label}: the float32 plain versions' draws equal its draws on "
            f"{float((slot_plain == truth).double().mean()):.4%} (slot) and "
            f"{float((fold_plain == truth).double().mean()):.4%} (fold); the kernels' on "
            f"{float((slot == truth).double().mean()):.4%} and "
            f"{float((fold == truth).double().mean()):.4%}")
        # the mean shot energy within 5 standard errors of the exact energy
        exact = probs @ table
        stderr = torch.sqrt((probs @ table**2 - exact**2).clamp(min=0) / shots)
        for name, idx in (("slot", slot), ("fold", fold)):
            z = ((table[idx.long()].mean(1) - exact) / stderr.clamp(min=1e-12)).abs().max()
            say(f"  {name} sampler {label}: mean shot energy within {float(z):.2f} standard "
                f"errors of the exact energy")
            require(float(z) < 5, f"the {name} sampler's mean is {float(z):.2f} standard errors off")
        if start is None:
            records["sampled_shot_indices"].update(
                ms=time_ms(lambda: sk.sampled_shot_indices(gt, ctrl, ang, m, frac, n), 5),
                plain_ms=time_ms(
                    lambda: sk.sampled_shot_indices_plain(gt, ctrl, ang, m, frac, n), 2),
            )
            records["sampled_shot_indices_folded"].update(
                ms=time_ms(lambda: fk.sampled_shot_indices_folded(pipe, frac, n), 5),
                plain_ms=time_ms(lambda: fk.sampled_shot_indices_folded_plain(pipe, frac, n), 2),
            )
            say("  " + engine_rate("sampled_shot_indices from |0>", slot_engine_bytes(gt, m, n),
                                   records["sampled_shot_indices"]["ms"]))
            say("  " + engine_rate("sampled_shot_indices_folded from |0>", engine_bytes(pipe, n),
                                   records["sampled_shot_indices_folded"]["ms"]))
        else:
            slot_ms = time_ms(lambda: sk.sampled_shot_indices(gt, ctrl, ang, m, frac, n, start), 5)
            fold_ms = time_ms(lambda: fk.sampled_shot_indices_folded(pipe, frac, n, start), 5)
            say(f"  sampled from prefix (the searches' shape): slot {slot_ms:.3f} ms, "
                f"fold {fold_ms:.3f} ms")
            say("  " + engine_rate("sampled_shot_indices from prefix", slot_engine_bytes(gt, m, n),
                                   slot_ms))
            say("  " + engine_rate("sampled_shot_indices_folded from prefix", engine_bytes(pipe, n),
                                   fold_ms))

    # the epilogue alone, beside the two-call flat sampler on the same
    # probabilities (torch.cumsum then torch.searchsorted)
    states = sk.population_states(gt, ctrl, ang, mask, n)
    probs = states[:, 0] ** 2 + states[:, 1] ** 2
    require(torch.equal(sk.sample_planes(states, frac, n), sk.sample_planes_plain(states, frac, n)),
            "the sampler epilogue disagrees with its plain version on equal planes")
    epilogue_ms = time_ms(lambda: sk.sample_planes(states, frac, n), 10)

    def flat():
        cdf = torch.cumsum(probs, dim=-1)
        return torch.searchsorted(cdf, frac * cdf[:, -1:], right=True)

    flat_ms = time_ms(flat, 10)
    say(f"  sampler epilogue alone [{w.pop},2^{n}] x {shots}: {epilogue_ms:.3f} ms; "
        f"torch.cumsum + torch.searchsorted (two calls) on the same probabilities: "
        f"{flat_ms:.3f} ms")

    # bench.py's sampler shape: 512-shot CVaR-0.5 population energies
    bgt, bctrl, bang, bmask = w.bench
    btable = w.bench_table
    bkeys = prng.split(prng.PRNGKey(0), bgt.shape[0])
    border = torch.argsort(btable, stable=True)
    bfrac = prng.uniform(bkeys, (shots,)).to(DEVICE)
    bprobs = sk.population_probs_plain(bgt, bctrl, bang, bmask, n)
    bslot = sk.sampled_shot_indices(bgt, bctrl, bang, bmask, bfrac, n)
    share, not_boundary = draw_agreement(
        bprobs, bfrac, bslot, sk.sampled_shot_indices_plain(bgt, bctrl, bang, bmask, bfrac, n))
    say(f"  bench shape slot sampler vs plain: {share:.4%} of draws equal (bar 99.0%), "
        f"{not_boundary} off a boundary")
    require(share >= 0.99 and not_boundary == 0, "the bench-shape slot sampler disagrees")
    energies = {}
    for route, use_mxu in (("slot", False), ("fold", True)):
        def objective(use_mxu=use_mxu):
            return population_energies(
                bgt, bctrl, bang, bmask, btable, btable[border], border, 0.5, bkeys,
                n_qubits=n, use_cvar=True, shots=shots, use_shots=True, use_mxu=use_mxu)

        energies[route] = objective()
        require(bool(torch.isfinite(energies[route]).all()), "bench-shape energies not finite")
        bench_ms = time_ms(objective, 5)
        say(f"  bench shape [{bgt.shape[0]}, L={bgt.shape[1]}] 512-shot CVaR-0.5 energies, "
            f"{route} route: {bench_ms:.3f} ms (bound {bounds['bench_sampled'][0]:.3f} ms, "
            f"{bounds['bench_sampled'][1]})")
    gap = float((energies["slot"] - energies["fold"]).abs().max())
    say(f"  bench shape CVaR energies, fold vs slot route: max difference {gap:.3e}")
    return finish_records(records, bounds)


def grouped_bound(gt, mask, operands, shots, n_qubits):
    """The least time of the grouped sampler at these shapes: each input
    read once (genome, rotation layers, uniforms), the indices written
    once, against the slot route's FLOPs: the circuit, every rotation
    slot of every group, and |psi|^2 plus the running sum once per
    group."""
    pop, dim = gt.shape[0], 1 << n_qubits
    rot_slots = int((operands.rot_types == 1).sum())
    n_groups = operands.tables.shape[0]
    flops = (circuit_flops(gt, mask, n_qubits)
             + pop * (rot_slots * FLOPS_PER_PAIR * dim / 2
                      + n_groups * FLOPS_PER_AMPLITUDE_SAMPLE * dim))
    moved = genome_bytes(gt, mask) + operands.rot_types.numel() * 16 + 8 * pop * sum(shots)
    return bound(moved, flops)


def phase_grouped_kernels(w):
    """The one-launch grouped sampler at n=20 (P=16, L=6, 512 shots per
    group) on TFIM and the molecular-like operator, from |0...0> and from
    prefix states: against the folded sampler once per group on the
    extended pipeline (equal bits), equal bits on a repeat, against its
    plain version (every differing draw a boundary draw, at least
    GROUPED_DRAW_BAR of draws equal), against the float64 state's draws
    (within one point of the float32 plain version's share), each group's
    mean shot energy within 5 standard errors of its exact energy; the
    grouped exact energies against the term scan to 1e-5 * sum|c|; times.

    The draw bar is below the folded sampler's 97.5%: a basis rotation on
    all 20 qubits (TFIM's X group) leaves every float32 engine -- the
    kernel, its plain version, the slot route's kernel and plain version
    -- agreeing with the float64 state's draws on only 96.7-97.4% of
    draws at these shapes (printed here)."""
    import torch

    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.expectation import general_pauli_expectation_real, pauli_terms
    from queasars_tpu_torch.sim.fold_pipeline import (
        build_fold_pipeline,
        extend_fold_pipeline_with_rotation,
    )
    from queasars_tpu_torch.sim.grouped_sampling import (
        append_rotation_layer,
        grouped_exact_energies_from_states,
        grouped_operands,
    )
    from queasars_tpu_torch.sim.sampling import hierarchical_sample_plain
    from queasars_tpu_torch.utils import prng

    n, shots = N_QUBITS, SAMPLED["shots"]
    name = "grouped_shot_indices_folded"
    records = {name: {}}
    gt, ctrl, ang, mask, pmask, smask = w.gt, w.ctrl, w.ang, w.mask, w.pmask, w.smask
    keys = prng.split(prng.PRNGKey(SAMPLED["seed"]), w.pop)
    prefix = sk.population_states(gt, ctrl, ang, pmask, n)
    operators = (("TFIM", tfim20()),
                 ("molecular-like", molecular_like(n, MOLECULAR["terms"], MOLECULAR["seed"])))
    for op_name, op in operators:
        ops = grouped_operands(op, DEVICE)
        n_groups = ops.tables.shape[0]
        counts = (shots,) * n_groups
        fracs = [prng.uniform(prng.fold_in(keys, g), (s,)).to(DEVICE) for g, s in enumerate(counts)]
        scale = float(abs(op.coeffs).sum())
        say(f"  {op_name}: {op.n_terms} terms in {n_groups} QWC groups, rotated groups "
            f"{sum(ops.rotate)}, sum|c| {scale:.3f}")
        terms = pauli_terms(op, DEVICE)
        for label, m, start in (("from |0>", mask, None), ("from prefix", smask, prefix)):
            base = build_fold_pipeline(gt, ctrl, ang, m, n, absorb_diag=True)
            args = (base, ops.rot_factors, ops.rot_active, fracs, n, start)
            got = fk.grouped_shot_indices_folded(*args, rotate=ops.rotate)
            again = fk.grouped_shot_indices_folded(*args, rotate=ops.rotate)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"the grouped sampler gives other bits for equal inputs ({op_name})")
            plain = fk.grouped_shot_indices_folded_plain(*args)
            extended = [extend_fold_pipeline_with_rotation(base, ops.rot_types[g],
                                                           ops.rot_angles[g], n)
                        for g in range(n_groups)]
            worst_share, worst_z, worst_truth = 1.0, 0.0, 1.0
            for g in range(n_groups):
                per_group = fk.sampled_shot_indices_folded(extended[g], fracs[g], n, start)
                require(torch.equal(got[g], per_group),
                        f"{op_name} {label} group {g}: the grouped sampler and the per-group "
                        "folded sampler disagree")
                ext = append_rotation_layer(gt, ctrl, ang, m, ops.rot_types[g], ops.rot_angles[g])
                probs = sk.population_probs_plain(*ext, n, start)
                share, not_boundary = draw_agreement(probs, fracs[g], got[g], plain[g])
                require(share >= GROUPED_DRAW_BAR and not_boundary == 0,
                        f"{op_name} {label} group {g}: {share:.4%} of draws equal to the plain "
                        f"version, {not_boundary} off a boundary")
                truth = hierarchical_sample_plain(float64_probs(*ext, n, start), fracs[g].double())
                kernel_truth = float((got[g] == truth).double().mean())
                plain_truth = float((plain[g] == truth).double().mean())
                require(kernel_truth >= plain_truth - 0.01,
                        f"{op_name} {label} group {g}: the kernel's draws equal the float64 "
                        f"state's on {kernel_truth:.4%}, the plain version's on {plain_truth:.4%}")
                table = ops.tables[g]
                exact = probs @ table
                stderr = torch.sqrt((probs @ table**2 - exact**2).clamp(min=0) / counts[g])
                z = float(((table[got[g].long()].mean(1) - exact)
                           / stderr.clamp(min=1e-12)).abs().max())
                require(z < 5, f"{op_name} {label} group {g}: mean {z:.2f} standard errors off")
                err = float((table[got[g].long()].mean(1)
                             - table[plain[g].long()].mean(1)).abs().max())
                records[name]["max_abs_err"] = max(records[name].get("max_abs_err", 0.0), err)
                worst_share, worst_z = min(worst_share, share), max(worst_z, z)
                worst_truth = min(worst_truth, kernel_truth)
                say(f"    group {g} (rotated: {ops.rotate[g]}): {share:.4%} of draws equal to the "
                    f"plain version; float64 state's draws: kernel {kernel_truth:.4%}, plain "
                    f"{plain_truth:.4%}")
            say(f"  grouped {op_name} {label}: equal bits to the per-group folded sampler in "
                f"all {n_groups} groups; at least {worst_share:.4%} of draws equal to the plain "
                f"version (bar {GROUPED_DRAW_BAR:.1%}), all others boundary draws; at least "
                f"{worst_truth:.4%} equal to the float64 state's; group means within "
                f"{worst_z:.2f} standard errors")
            states = fk.population_states_folded(base, n, start)
            grouped_exact = grouped_exact_energies_from_states(states, ops)
            scan = general_pauli_expectation_real(states, *terms)
            gap = float((grouped_exact - scan).abs().max())
            say(f"  {op_name} {label}: grouped exact energies vs term scan: {gap:.3e} "
                f"(tolerance {1e-5 * scale:.3e})")
            require(gap <= 1e-5 * scale, f"{op_name}: grouped exact energies disagree with the "
                    "term scan")
            kernel_ms = time_ms(lambda: fk.grouped_shot_indices_folded(*args, rotate=ops.rotate), 5)
            per_group_ms = time_ms(lambda: [
                fk.sampled_shot_indices_folded(extended[g], fracs[g], n, start)
                for g in range(n_groups)], 3)
            say(f"  grouped {op_name} {label}: kernel {kernel_ms:.3f} ms, per-group folded "
                f"route {per_group_ms:.3f} ms")
            rotated = [extended[g] for g in range(n_groups) if ops.rotate[g]]
            say("  " + engine_rate(f"grouped {op_name} {label} (circuit and rotations)",
                                   engine_bytes(base, n, rotated), kernel_ms))
            if op_name == "TFIM" and start is None:
                records[name].update(
                    ms=kernel_ms, per_group_ms=per_group_ms,
                    plain_ms=time_ms(lambda: fk.grouped_shot_indices_folded_plain(*args), 2),
                    bound=grouped_bound(gt, m, ops, counts, n),
                )
    rec = records[name]
    say(f"  {name}: {rec['ms']:.3f} ms (per-group route {rec['per_group_ms']:.3f} ms, plain "
        f"{rec['plain_ms']:.3f} ms, bound {rec['bound'][0]:.4f} ms by {rec['bound'][1]})")
    return records


def compact_bounds(genome, compact, n_qubits) -> dict:
    """The least time of each compacted-gate function: every active gate's
    qubit, control, angle index and angle triple and every count read once,
    the table read once and the output written once, against the active
    gates' FLOPs (which are rows 1's and 4's at this shape); and under
    ``design``, the circuit's bytes by the engine's rule
    (``compact_engine_bytes``) over 3.35 TB/s."""
    gt, _, _, mask = genome
    pop, dim = gt.shape[0], 1 << n_qubits
    active = int(compact.boundaries[:, -1].sum())
    moved = active * (4 + 4 + 4 + 12) + 4 * pop
    flops = circuit_flops(gt, mask, n_qubits)
    return {
        "compact_energies_exact": bound(moved + 4 * dim + 4 * pop,
                                        flops + FLOPS_PER_AMPLITUDE_ENERGY * dim * pop),
        "compact_probs": bound(moved + 4 * dim * pop, flops + FLOPS_PER_AMPLITUDE_PROB * dim * pop),
        "design": (compact_engine_bytes(compact, n_qubits) / PEAK_BYTES_PER_S * 1e3, "bytes"),
    }


def phase_compact_kernels(w):
    """Both compacted-gate kernels.  First their main path,
    tools/port_compact.py's, once at bench.py's shape with the launch
    counts set to 0 just before it: the compaction, equal bits to the slot
    energies and probabilities kernels, the sustained comparison.  Then at
    the bench shape and at the slot phase's: each kernel against its plain
    version (energies to 1e-5 * max|table|, probabilities to 1e-5 of the
    largest), equal bits on a repeat and, at the slot phase's shape, to
    the slot kernels; times in turns with those kernels (kernel, slot,
    slot, kernel).  Returns (records at the slot phase's shape, launches
    over the path)."""
    import torch

    from queasars_tpu_torch.sim import compact_kernels as ck
    from queasars_tpu_torch.sim import slot_kernels as sk
    from tools import port_compact

    t0 = time.perf_counter()
    n = N_QUBITS
    reset_launch_counts()
    result = port_compact.compact_path(w.bench, w.bench_table)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {name: counts[name] for name in COMPACT_KERNELS}
    port_compact.report_compact_path(result, say)
    say(f"  launches over the compact path: {launches}")
    for name in COMPACT_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the compact path")
    require(result["bits_equal"], "the compact path's energies or probabilities are not the "
            "slot kernels' bits")

    records = {name: {} for name in COMPACT_KERNELS}
    shapes = (("bench shape", w.bench, w.bench_table, False),
              ("slot phase shape", (w.gt, w.ctrl, w.ang, w.mask), w.table, True))
    for label, genome, table, against_slot in shapes:
        gt, ctrl, ang, mask = genome
        start = time.perf_counter()
        compact = ck.compact_gates(gt, ctrl, mask, n, device=DEVICE)
        host_ms = (time.perf_counter() - start) * 1e3
        say(f"  {label} [{gt.shape[0]}, L={gt.shape[1]}]: "
            f"{port_compact.describe_compaction(port_compact.compaction_stats(compact, gt))}; "
            f"compact_gates {host_ms:.3f} ms on the host")
        energies = ck.compact_energies_exact(compact, ang, table)
        probs = ck.compact_probs(compact, ang)
        check_close(f"compact_energies_exact {label}", energies,
                    ck.compact_energies_exact_plain(compact, ang, table),
                    1e-5 * float(table.abs().max()), records, "compact_energies_exact")
        plain_probs = ck.compact_probs_plain(compact, ang)
        check_close(f"compact_probs {label}", probs, plain_probs, probs_tolerance(plain_probs),
                    records, "compact_probs")
        if against_slot:
            require(torch.equal(energies, sk.energies_exact(gt, ctrl, ang, mask, table, n)),
                    f"compact_energies_exact {label}: other bits than energies_exact")
            require(torch.equal(probs, sk.population_probs(gt, ctrl, ang, mask, n)),
                    f"compact_probs {label}: other bits than population_probs")
            say(f"  {label}: equal bits to energies_exact and population_probs")
        require(torch.equal(energies, ck.compact_energies_exact(compact, ang, table))
                and torch.equal(probs, ck.compact_probs(compact, ang)),
                f"the compacted-gate kernels give other bits for equal inputs ({label})")
        say(f"  {label}: equal bits on a repeat")
        kernels = {
            "compact_energies_exact": (
                lambda: ck.compact_energies_exact(compact, ang, table),
                lambda: sk.energies_exact(gt, ctrl, ang, mask, table, n),
                lambda: ck.compact_energies_exact_plain(compact, ang, table)),
            "compact_probs": (
                lambda: ck.compact_probs(compact, ang),
                lambda: sk.population_probs(gt, ctrl, ang, mask, n),
                lambda: ck.compact_probs_plain(compact, ang)),
        }
        bounds = compact_bounds(genome, compact, n)
        moved = compact_engine_bytes(compact, n)
        require(moved == slot_engine_bytes(gt, mask, n),
                f"compact design bytes {moved} differ from the slot engine's ({label})")
        for name, (kernel, slot, plain) in kernels.items():
            first, slot_a, slot_b, last = (time_ms(fn, 5) for fn in (kernel, slot, slot, kernel))
            entry = dict(ms=(first + last) / 2, slot_ms=(slot_a + slot_b) / 2,
                         plain_ms=time_ms(plain, 1), bound=bounds[name],
                         design_bound=bounds["design"])
            say(f"  {name} {label}: {entry['ms']:.3f} ms ({first:.3f}, {last:.3f}); slot kernel "
                f"{entry['slot_ms']:.3f} ms ({slot_a:.3f}, {slot_b:.3f}); ratio "
                f"{entry['ms'] / entry['slot_ms']:.4f}; plain {entry['plain_ms']:.3f} ms; bound "
                f"{entry['bound'][0]:.4f} ms by {entry['bound'][1]}, of the design's bytes "
                f"{entry['design_bound'][0]:.4f} ms")
            say("  " + engine_rate(f"{name} {label}", moved, entry["ms"]))
            if against_slot:
                records[name].update(entry)
    say(f"phase compact kernels: {time.perf_counter() - t0:.2f} s")
    return records, launches


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


def baseline_solver(optimizer, settings, clock=None, penalty=0.1, mog=False, mesh=None,
                    amp_devices=None):
    """An exact-estimator solver under the repository's ``evqe_config``
    (experiments/exp_baseline_configs.py:64-83) on the card: ``settings``
    gives population, generations, seed and optionally ``pack_min_layers``;
    ``penalty`` both selection penalties; ``mog`` the MoG-VQE facade;
    ``clock`` is its termination criterion; ``mesh`` a population mesh, whose
    amplitude axis ``amp_devices`` sets (None: the driver's rule)."""
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
        MoGVQEMinimumEigensolver,
    )

    solver = MoGVQEMinimumEigensolver if mog else EVQEMinimumEigensolver
    return solver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        configured_sampler=None,
        optimizer=optimizer,
        optimizer_n_circuit_evaluations=None,
        max_generations=settings["generations"],
        max_circuit_evaluations=None,
        termination_criterion=clock,
        random_seed=settings["seed"],
        population_size=settings["population"],
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=penalty,
        selection_beta_penalty=penalty,
        parameter_search_probability=0.25,
        topological_search_probability=0.4,
        layer_removal_probability=0.05,
        pack_min_layers=settings.get("pack_min_layers"),
        device=DEVICE,
        mesh=mesh,
        amp_devices=amp_devices,
    ))


def config4_solver(clock=None, mesh=None, settings=SOLVE):
    """The EVQE solver of the repository's config 4
    (experiments/exp_baseline_configs.py:64-83, 143-151) on the card;
    ``clock`` is its termination criterion, ``mesh`` a population mesh."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig

    return baseline_solver(BatchedNFT(NFTConfig(maxiter=settings["maxiter"])), settings, clock,
                           mesh=mesh)


def config3_solver(clock=None, mesh=None):
    """The EVQE solver of the repository's config 3
    (experiments/exp_baseline_configs.py:64-83, 128-141) on the card: a
    512-shot sampler, no estimator, CVaR 0.5, tournament selection;
    ``mesh`` a population mesh."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import (
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=None,
        configured_sampler=ConfiguredSampler(shots=CONFIG3["shots"], seed=CONFIG3["sampler_seed"]),
        optimizer=BatchedNFT(NFTConfig(maxiter=CONFIG3["maxiter"])),
        optimizer_n_circuit_evaluations=None,
        max_generations=CONFIG3["generations"],
        max_circuit_evaluations=None,
        termination_criterion=clock,
        random_seed=CONFIG3["seed"],
        population_size=CONFIG3["population"],
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1,
        parameter_search_probability=0.25,
        topological_search_probability=0.4,
        layer_removal_probability=0.05,
        use_tournament_selection=True,
        tournament_size=CONFIG3["tournament_size"],
        distribution_alpha_tail=CONFIG3["alpha"],
        pack_min_layers=CONFIG3["pack_min_layers"],
        device=DEVICE,
        mesh=mesh,
    ))


def tfim20_solver(clock=None):
    """The TFIM-20 sampler solve on the card: config 2's optimizer
    (five-point NFT, maxiter 20), population (20) and generations (3)
    (experiments/exp_baseline_configs.py:116-125) under config 3's
    512-shot sampler with tournament selection of size 2 (TFIM energies are
    negative), no estimator, ``pack_min_layers=6``, seed 0."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import (
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=None,
        configured_sampler=ConfiguredSampler(shots=TFIM20["shots"], seed=TFIM20["sampler_seed"]),
        optimizer=BatchedNFT(NFTConfig(maxiter=TFIM20["maxiter"], five_point=True)),
        optimizer_n_circuit_evaluations=None,
        max_generations=TFIM20["generations"],
        max_circuit_evaluations=None,
        termination_criterion=clock,
        random_seed=TFIM20["seed"],
        population_size=TFIM20["population"],
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.1,
        parameter_search_probability=0.25,
        topological_search_probability=0.4,
        layer_removal_probability=0.05,
        use_tournament_selection=True,
        tournament_size=TFIM20["tournament_size"],
        pack_min_layers=TFIM20["pack_min_layers"],
        device=DEVICE,
    ))


def reset_launch_counts():
    from queasars_tpu_torch.sim import (
        compact_kernels, fold_kernels, fold_pipeline, shard_kernels, slot_kernels)

    slot_kernels.reset_launch_counts()
    fold_kernels.reset_launch_counts()
    compact_kernels.reset_launch_counts()
    shard_kernels.reset_launch_counts()
    fold_pipeline.build_counts["kernel"] = 0


def launch_counts() -> dict:
    """Launches per kernel row; ``fold_build`` counts the fold pipeline's
    builds on the build kernel."""
    from queasars_tpu_torch.sim import (
        compact_kernels, fold_kernels, fold_pipeline, shard_kernels, slot_kernels)

    return {**slot_kernels.launch_counts, **fold_kernels.launch_counts,
            **compact_kernels.launch_counts, **shard_kernels.launch_counts,
            "fold_build": fold_pipeline.build_counts["kernel"]}


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
        require(launches["fold_build"] > 0, "no fold build took the build kernel")
    else:
        require(not any(launches[name] for name in (*ROUTE_KERNELS["fold"], "fold_build")),
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


def phase_sampler_solve(route, seed, encoder, hamiltonian):
    """Config 3 on one route; returns that run's launch counts."""
    import numpy as np
    import torch

    from queasars_tpu_torch.genome import PackedPopulation
    from queasars_tpu_torch.optim.objective import population_probs
    from queasars_tpu_torch.paulis import diagonal_energy_table
    from queasars_tpu_torch.sim.evaluators import packed_tensors
    from queasars_tpu_torch.sim.expectation import cvar_expectation_from_probs

    use_route(route)
    n = hamiltonian.n_qubits
    table = diagonal_energy_table(hamiltonian, dtype=torch.float32, device=DEVICE)
    solver = config3_solver(_GenerationClock())
    reset_launch_counts()
    start = time.perf_counter()
    result = solver.compute_minimum_eigenvalue(hamiltonian)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    evals = int(sum(result.circuit_evaluations))
    best_state = max(result.eigenstate, key=result.eigenstate.get)
    say(f"phase config 3 ({route} route): instance seed {seed}, {n} qubits, "
        f"{result.generations} generations in {seconds:.2f} s, {evals} evaluations "
        f"({evals / seconds:.1f}/s), eigenvalue {result.eigenvalue:.6f}, best bitstring "
        f"{format(best_state, f'0{n}b')} (p={result.eigenstate[best_state]:.4f})")
    say(f"  launches over the solve: {launches}")
    require(result.generations == CONFIG3["generations"], "the sampler solve stopped early")
    for name in SAMPLER_ROUTE_KERNELS[route]:
        require(launches[name] > 0, f"kernel {name} was not launched by config 3 on the {route} route")
    other = "slot" if route == "fold" else "fold"
    require(launches[SAMPLER_ROUTE_KERNELS[other][0]] == 0,
            f"the {other} route's sampler ran on the {route} route")

    # check 1: the best bitstring's table energy is the Hamiltonian's value
    # there (host, float64); it decodes to a schedule, valid or not: four
    # generations of config 3 end on penalty energies, as the JAX package's
    # own run of it does (docs/performance.md:449, E = 96.5881)
    coeffs = hamiltonian.coeffs.real
    parity = np.array([bin(int(z) & best_state).count("1") & 1 for z in hamiltonian.z_masks_lo64()])
    host_value = float(np.sum(coeffs * (1.0 - 2.0 * parity)))
    table_value = float(table[best_state])
    schedule = encoder.translate_result_state(best_state)
    say(f"  check bitstring: table {table_value:.6f} vs host {host_value:.6f}; schedule "
        f"valid={schedule.is_valid} makespan={schedule.makespan}")
    require(abs(table_value - host_value) <= 1e-5 * float(table.abs().max()),
            "table energy disagrees with the Hamiltonian")
    # check 2: the final distribution holds the sampler's shots
    counts = np.array(list(result.eigenstate.values())) * CONFIG3["shots"]
    say(f"  check distribution: {counts.sum():.6f} shots over {len(counts)} states")
    require(abs(counts.sum() - CONFIG3["shots"]) < 1e-6 and np.allclose(counts, np.round(counts)),
            "the final distribution does not hold the sampler's shots")
    # check 3: the eigenvalue against the best individual's exact CVaR
    packed = PackedPopulation.pack([result.best_individual])
    probs = population_probs(*packed_tensors(packed, device=DEVICE), n_qubits=n)[0].double()
    table64 = table.double()
    order = torch.argsort(table64, stable=True)
    alpha = CONFIG3["alpha"]
    exact = float(cvar_expectation_from_probs(probs, table64[order], order, alpha))
    mean = float(probs @ table64)
    sigma = float(torch.sqrt((probs @ table64**2 - mean**2).clamp(min=0)))
    limit = 5 * sigma / np.sqrt(alpha * CONFIG3["shots"])
    say(f"  check eigenvalue: solver {result.eigenvalue:.6f} vs exact CVaR-{alpha} "
        f"{exact:.6f} (|difference| {abs(result.eigenvalue - exact):.6f}, limit {limit:.6f})")
    require(np.isfinite(result.eigenvalue), "eigenvalue is not finite")
    require(abs(result.eigenvalue - exact) <= limit, "eigenvalue is off the exact CVaR")
    return launches


def phase_tfim_solve(route):
    """The TFIM-20 sampler solve on one route; returns that run's launch
    counts."""
    import numpy as np
    import torch

    from queasars_tpu_torch.genome import PackedPopulation
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.evaluators import packed_tensors
    from queasars_tpu_torch.sim.expectation import general_pauli_expectation_real, pauli_terms
    from queasars_tpu_torch.sim.grouped_sampling import grouped_weights

    use_route(route)
    op = tfim20()
    n = op.n_qubits
    solver = tfim20_solver(_GenerationClock())
    reset_launch_counts()
    start = time.perf_counter()
    result = solver.compute_minimum_eigenvalue(op)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    evals = int(sum(result.circuit_evaluations))
    best_state = max(result.eigenstate, key=result.eigenstate.get)
    say(f"phase TFIM-20 ({route} route): {n} qubits, {op.n_terms} terms, {result.generations} "
        f"generations in {seconds:.2f} s, {evals} evaluations ({evals / seconds:.1f}/s), "
        f"eigenvalue {result.eigenvalue:.6f}, best bitstring {format(best_state, f'0{n}b')} "
        f"(p={result.eigenstate[best_state]:.4f})")
    say(f"  launches over the solve: {launches}")
    require(result.generations == TFIM20["generations"], "the TFIM-20 solve stopped early")
    for name in TFIM_ROUTE_KERNELS[route]:
        require(launches[name] > 0, f"kernel {name} was not launched by TFIM-20 on the {route} route")
    for name in TFIM_ROUTE_FORBIDDEN[route]:
        require(launches[name] == 0, f"kernel {name} ran on the {route} route of TFIM-20")
    # check 1: the final distribution holds the sampler's shots
    counts = np.array(list(result.eigenstate.values())) * TFIM20["shots"]
    say(f"  check distribution: {counts.sum():.6f} shots over {len(counts)} states")
    require(abs(counts.sum() - TFIM20["shots"]) < 1e-6 and np.allclose(counts, np.round(counts)),
            "the final distribution does not hold the sampler's shots")
    # check 2: the eigenvalue against the best individual's exact energy
    # (term scan), within 5 standard errors of a grouped 512-shot estimate
    packed = PackedPopulation.pack([result.best_individual])
    states = sk.population_states(*packed_tensors(packed, device=DEVICE), n)
    exact = float(general_pauli_expectation_real(states, *pauli_terms(op, DEVICE))[0])
    weights = grouped_weights(op)
    limit = 5 * float(np.sqrt(np.sum(weights**2 / TFIM20["shots"])))
    say(f"  check eigenvalue: solver {result.eigenvalue:.6f} vs exact {exact:.6f} "
        f"(|difference| {abs(result.eigenvalue - exact):.6f}, limit {limit:.6f})")
    require(np.isfinite(result.eigenvalue) and result.eigenvalue < 0,
            "the TFIM-20 eigenvalue is not negative")
    require(abs(result.eigenvalue - exact) <= limit, "the eigenvalue is off the exact energy")
    return launches


def timed_solve(solver, operator):
    """Run ``solver`` on ``operator`` with every launch count at 0 before
    and read after: (result, seconds, launches)."""
    import torch

    reset_launch_counts()
    start = time.perf_counter()
    result = solver.compute_minimum_eigenvalue(operator)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return result, seconds, launch_counts()


def per_row(launches) -> dict:
    """The non-zero launch counts by kernel row (the sampler epilogue, part
    of row 5, by its name)."""
    order = sorted(launches, key=lambda k: (0, ROWS[k]) if isinstance(ROWS.get(k), int)
                   else (1, str(ROWS.get(k, k))))
    return {f"row {ROWS[k]}" if k in ROWS else k: launches[k] for k in order if launches[k]}


def solve_line(label, result, seconds, card, launches) -> None:
    """The solve phases' line: seconds, evaluations per second, the card,
    and the launches per kernel row."""
    evals = int(sum(result.circuit_evaluations))
    rows = per_row(launches)
    say(f"phase {label}: {result.generations} generations in {seconds:.3f} s, {evals} "
        f"evaluations ({evals / seconds:.1f}/s), eigenvalue {result.eigenvalue:.6f} | {card} | "
        f"launches per row {rows}")


def best_energy_plain(result, operator, table=None) -> float:
    """The best individual's exact energy from a plain version: the
    energies version against a diagonal operator's ``table``, else the
    states version and the operator's dense matrix in float64 on the host
    (small operators only)."""
    import numpy as np

    from queasars_tpu_torch.genome import PackedPopulation
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    packed = PackedPopulation.pack([result.best_individual])
    tensors = packed_tensors(packed, device=DEVICE)
    if table is not None:
        return float(sk.energies_exact_plain(*tensors, table, operator.n_qubits)[0])
    states = sk.population_states_plain(*tensors, operator.n_qubits)
    planes = states[0].double().cpu().numpy()
    psi = planes[0] + 1j * planes[1]
    return float(np.real(np.vdot(psi, operator.to_dense_matrix() @ psi)))


def phase_config2(card):
    """BASELINE's config 2: the exact-estimator TFIM solve, whose parameter
    search runs the per-slot loop over the states kernel."""
    import numpy as np

    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.problems.spin_chains import transverse_field_ising

    use_route("fold")
    op = transverse_field_ising(CONFIG2["qubits"], **TFIM)
    optimizer = BatchedNFT(NFTConfig(maxiter=CONFIG2["maxiter"], five_point=True))
    result, seconds, launches = timed_solve(
        baseline_solver(optimizer, CONFIG2, _GenerationClock()), op)
    solve_line(f"config 2 ({op.n_qubits}-qubit TFIM, exact estimator, per-slot loop)", result,
               seconds, card, launches)
    scale = float(np.abs(op.coeffs).sum())
    ground = float(np.linalg.eigvalsh(op.to_dense_matrix())[0])
    plain = best_energy_plain(result, op)
    say(f"  check: eigenvalue {result.eigenvalue:.6f}, ground {ground:.6f}, best individual "
        f"by the plain version {plain:.6f} (tolerance {1e-5 * scale:.6f})")
    require(result.generations == CONFIG2["generations"], "config 2 stopped early")
    require(launches["population_states"] > 0, "config 2 did not launch the states kernel")
    for name in ("energies_exact", "sampled_shot_indices", "energies_exact_folded",
                 "sampled_shot_indices_folded"):
        require(launches[name] == 0, f"kernel {name} ran in config 2")
    require(ground - 1e-5 * scale <= result.eigenvalue < 0,
            "config 2's eigenvalue lies below the ground energy or is not negative")
    require(abs(plain - result.eigenvalue) <= 1e-5 * scale,
            "config 2's eigenvalue disagrees with the plain version")


def phase_config5(card):
    """BASELINE's config 5: MoG-VQE on a 6-qubit Heisenberg chain."""
    import numpy as np

    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.problems.spin_chains import heisenberg_chain
    from queasars_tpu_torch.solver import result_pareto_front

    use_route("fold")
    op = heisenberg_chain(CONFIG5["qubits"])
    optimizer = BatchedNFT(NFTConfig(maxiter=CONFIG5["maxiter"], five_point=True))
    result, seconds, launches = timed_solve(
        baseline_solver(optimizer, CONFIG5, _GenerationClock(), penalty=0.0, mog=True), op)
    solve_line(f"config 5 (MoG-VQE, {op.n_qubits}-qubit Heisenberg)", result, seconds, card,
               launches)
    front = result_pareto_front(result)
    ground = float(np.linalg.eigvalsh(op.to_dense_matrix())[0])
    best = result.final_population_evaluation_result.best_expectation_value
    say(f"  Pareto front (energy, controlled gates): "
        f"{[(round(e, 6), gates) for _, e, gates in front]}; ground {ground:.6f}")
    require(result.generations == CONFIG5["generations"], "config 5 stopped early")
    require(launches["population_states"] > 0, "config 5 did not launch the states kernel")
    require(result.eigenvalue >= ground - 1e-3, "config 5's eigenvalue lies below the ground energy")
    require(len(front) > 0, "config 5's Pareto front is empty")
    for _, e1, g1 in front:
        for _, e2, g2 in front:
            require(not (e1 <= e2 and g1 <= g2 and (e1 < e2 or g1 < g2)),
                    "config 5's Pareto front holds a dominated point")
    require(min(e for _, e, _ in front) == best,
            "config 5's Pareto front misses the generation's best energy")


def phase_spsa_solve(route, card, hamiltonian, table):
    """SPSA on config 4's 20-qubit instance on one route; returns its
    result."""
    import numpy as np

    from queasars_tpu_torch.optim import BatchedSPSA, SPSAConfig

    use_route(route)
    optimizer = BatchedSPSA(SPSAConfig(maxiter=SPSA4["maxiter"],
                                       calibration_steps=SPSA4["calibration_steps"]))
    result, seconds, launches = timed_solve(
        baseline_solver(optimizer, SPSA4, _GenerationClock()), hamiltonian)
    solve_line(f"SPSA config 4 ({route} route, {hamiltonian.n_qubits} qubits)", result, seconds,
               card, launches)
    say(f"  reduced: generations {SOLVE['generations']} -> {SPSA4['generations']}, SPSA steps "
        f"100 -> {SPSA4['maxiter']}, calibration pairs 25 -> {SPSA4['calibration_steps']} "
        f"(qubits uncut)")
    tol = 1e-5 * float(table.abs().max())
    plain = best_energy_plain(result, hamiltonian, table)
    say(f"  check: eigenvalue {result.eigenvalue:.6f}, table minimum {float(table.min()):.6f}, "
        f"best individual by the plain version {plain:.6f} (tolerance {tol:.6f})")
    require(result.generations == SPSA4["generations"], "the SPSA solve stopped early")
    if route == "slot":
        require(launches["energies_exact"] > 0 and launches["population_states"] > 0,
                "the slot route's SPSA solve did not launch rows 1 and 2")
        require(launches["energies_exact_folded"] == 0, "row 6 ran on the slot route")
    else:
        require(launches["energies_exact_folded"] > 0, "the fold route's SPSA solve skipped row 6")
    require(np.isfinite(result.eigenvalue) and result.eigenvalue >= float(table.min()) - tol,
            "the SPSA eigenvalue lies below the table's minimum")
    require(abs(plain - result.eigenvalue) <= tol,
            "the SPSA eigenvalue disagrees with the plain version")
    return result


def last_layer_problem(n_qubits, settings):
    """A seeded random population packed as config 4's solve packs it, with
    each individual's last-layer coordinates: (packed, coords, n_free)."""
    import numpy as np

    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation

    population = EVQEPopulation.random_population(
        n_qubits, settings["layers"], settings["population"], True, random_seed=settings["seed"])
    packed = PackedPopulation.pack(list(population.individuals), min_layers=SOLVE["pack_min_layers"])
    coords_list = [packed.layer_param_coordinates(i, -1) for i in range(packed.n_individuals)]
    coords = np.zeros((packed.n_individuals, max(len(c) for c in coords_list), 3), np.int32)
    n_free = np.array([len(c) for c in coords_list], np.int32)
    for i, c in enumerate(coords_list):
        coords[i, : len(c)] = c
    return packed, coords, n_free


def phase_spsa_routes_agree(results, hamiltonian, table):
    """SPSA on both routes from the same keys.  SPSA at calibrated rates
    moves each coordinate by about pi per step, so the routes' rounding
    differences grow 3-10x per step (tests/test_torch_spsa.py): the solves'
    first-generation gap and one calibrated last-layer call's gap after 1,
    2, 4 and 8 steps are printed for the record.  The bar holds the same
    call at a fixed rate of 1e-5 (steps of about 0.05 rad on this table,
    where rounding does not grow) over 8 steps: both routes within
    1e-5 * max|table| per individual."""
    import numpy as np

    from queasars_tpu_torch.optim import BatchedSPSA, SPSAConfig
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    scale = float(table.abs().max())
    slot, fold = (np.asarray(r.population_evaluation_results[0].expectation_values)
                  for r in results)
    gap = np.abs(slot - fold) / scale
    say(f"  SPSA routes, solves' generation 1 (record): largest |slot - fold| / max|table| "
        f"{gap.max():.3e}, per individual {np.array2string(gap, precision=2)}")
    packed, coords, n_free = last_layer_problem(hamiltonian.n_qubits, SPSA_CHECKED)
    last = (packed.layer_mask.sum(axis=1) - 1).astype(np.int32)

    def route_gap(config) -> float:
        energies = []
        for route in ("slot", "fold"):
            use_route(route)
            energies.append(BatchedSPSA(config).minimize(
                StatevectorExpectationEvaluator(hamiltonian, device=DEVICE), packed, coords,
                n_free, n_free > 0, seed=SPSA_CHECKED["seed"], last_layer=last)[1])
        return float(np.abs(energies[0] - energies[1]).max()) / scale

    calibrated = {steps: route_gap(SPSAConfig(
        maxiter=steps, calibration_steps=SPSA4["calibration_steps"])) for steps in (1, 2, 4, 8)}
    fixed = route_gap(SPSAConfig(maxiter=8, learning_rate=1e-5))
    say(f"  SPSA routes, one last-layer call, largest |slot - fold| / max|table|: calibrated "
        f"(record) after {', '.join(f'{k} steps {v:.3e}' for k, v in calibrated.items())}; "
        f"fixed rate 1e-5 after 8 steps {fixed:.3e} (bar 1e-5)")
    require(fixed <= 1e-5, "the routes' SPSA energies disagree at a fixed rate")


def phase_spsa_checkers(card, hamiltonian):
    """One host-stepped BatchedSPSA.minimize call at n=20 with a
    termination checker per individual: each stops at its maxfev."""
    import numpy as np

    from queasars_tpu_torch.optim import BatchedSPSA, SPSAConfig, SPSATerminationChecker
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    class Recording(SPSATerminationChecker):
        """Keeps the last call's evaluation count and parameters."""

        def termination_check(self, n_function_evaluations, parameter_values, **kwargs):
            self.last = (n_function_evaluations, np.array(parameter_values, copy=True))
            return super().termination_check(n_function_evaluations, parameter_values, **kwargs)

    use_route("fold")
    cfg = SPSA_CHECKED
    packed, coords, n_free = last_layer_problem(hamiltonian.n_qubits, cfg)
    calibration = 2 * cfg["calibration_steps"]
    # minimum relative change 0 never stalls: individual i stops at its maxfev,
    # after 1 + i % 6 steps
    maxfev = [calibration + 2 * (1 + i % 6) for i in range(packed.n_individuals)]
    checkers = [Recording(0.0, 0, maxfev=m) for m in maxfev]
    reset_launch_counts()
    start = time.perf_counter()
    angles, energies, nfev = BatchedSPSA(SPSAConfig(
        maxiter=cfg["maxiter"], calibration_steps=cfg["calibration_steps"])).minimize(
        StatevectorExpectationEvaluator(hamiltonian, device=DEVICE), packed, coords, n_free,
        n_free > 0, seed=cfg["seed"], termination_checkers=checkers)
    seconds = time.perf_counter() - start
    launches = per_row(launch_counts())
    say(f"phase SPSA with termination checkers (n={hamiltonian.n_qubits}, P={len(checkers)}): "
        f"{seconds:.3f} s, nfev {nfev} (checkers allowed {max(maxfev)}) | {card} | launches "
        f"per row {launches}")
    require(nfev == max(maxfev), "the host-stepped SPSA call ran past its checkers")
    for i, checker in enumerate(checkers):
        last_nfev, last_parameters = checker.last
        require(last_nfev == maxfev[i], f"individual {i} stopped at nfev {last_nfev}, not "
                                        f"{maxfev[i]}")
        require(np.array_equal(angles[i], last_parameters),
                f"individual {i}'s angles moved after its checker stopped it")
    require(np.all(np.isfinite(energies)), "the host-stepped SPSA energies are not finite")


def phase_cobyla(card):
    """COBYLA on config 1's 8-qubit JSSP instance."""
    import numpy as np
    import torch

    from queasars_tpu_torch.optim import CobylaConfig, ScipyCobyla
    from queasars_tpu_torch.paulis import diagonal_energy_table

    use_route("fold")
    seed, _, hamiltonian = jssp_with_qubits(2, 2, 4, CONFIG1["qubits"], 1, rel=1.0)
    table = diagonal_energy_table(hamiltonian, dtype=torch.float32, device=DEVICE)
    optimizer = ScipyCobyla(CobylaConfig(maxiter=CONFIG1["maxiter"]))
    result, seconds, launches = timed_solve(
        baseline_solver(optimizer, CONFIG1, _GenerationClock()), hamiltonian)
    solve_line(f"COBYLA config 1 ({hamiltonian.n_qubits}-qubit JSSP, instance seed {seed})",
               result, seconds, card, launches)
    minimum = float(table.min())
    say(f"  check: eigenvalue {result.eigenvalue:.6f}, table minimum {minimum:.6f}")
    require(result.generations == CONFIG1["generations"], "the COBYLA solve stopped early")
    require(launches["energies_exact"] > 0, "the COBYLA solve did not launch row 1")
    require(np.isfinite(result.eigenvalue)
            and result.eigenvalue >= minimum - 1e-5 * float(table.abs().max()),
            "the COBYLA eigenvalue lies below the table's minimum")


# ---------------------------------------------------------------------------
# the gradient family, QAOA, ADAPT-VQE and QNEAT
# ---------------------------------------------------------------------------


class _LaunchClock(_GenerationClock):
    """A never-terminating criterion that also records, at each generation's
    end, the launch counts so far."""

    def reset_state(self):
        super().reset_state()
        self.launches = []
        self.bests = []

    def check_termination(self, population_evaluation, best_individual, best_expectation_value):
        self.launches.append(dict(launch_counts()))
        self.bests.append(population_evaluation.best_expectation_value)
        return super().check_termination(population_evaluation, best_individual,
                                          best_expectation_value)


def memory_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def reset_memory() -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def phase_line(label, seconds, evals, card, launches) -> None:
    """The new phases' line: seconds, evaluations per second (the solver's
    own count), peak device memory, the card and launches per kernel row."""
    say(f"phase {label}: {seconds:.3f} s, {evals} evaluations ({evals / seconds:.1f}/s), peak "
        f"memory {memory_gib():.2f} GiB | {card} | launches per row {per_row(launches)}")


def row_energies(packed, angles, table, n_qubits, route):
    """Energies [P] of a packed population at ``angles`` by row 6 (``route``
    "fold") or row 1 ("slot"), launched directly."""
    from queasars_tpu_torch.sim import fold_kernels, slot_kernels
    from queasars_tpu_torch.sim.evaluators import packed_tensors
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline

    gt, ctrl, ang, lm = packed_tensors(packed, angles, DEVICE)
    if route == "fold":
        pipeline = build_fold_pipeline(gt, ctrl, ang, lm, n_qubits, absorb_diag=True)
        return fold_kernels.energies_exact_folded(pipeline, table, n_qubits)
    return slot_kernels.energies_exact(gt, ctrl, ang, lm, table, n_qubits)


def phase_gradient_solve(card, hamiltonian, table):
    """Config 4's instance under BatchedGradientDescent on the default
    route (2 of 4 generations): the autograd objective carries the searches,
    row 2 their prefix states, row 1 selection (the evaluator's exact
    energies take the slot kernel on both routes, as the reference's
    ``evaluate_packed`` does) and row 9 the final distribution."""
    from queasars_tpu_torch.optim import BatchedGradientDescent, GradientDescentConfig

    use_route("fold")
    optimizer = BatchedGradientDescent(GradientDescentConfig(
        maxiter=GRADIENT4["maxiter"], learning_rate=GRADIENT4["learning_rate"]))
    clock = _LaunchClock()
    reset_memory()
    result, seconds, launches = timed_solve(baseline_solver(optimizer, GRADIENT4, clock),
                                            hamiltonian)
    phase_line(f"gradient EVQE solve (config 4, {hamiltonian.n_qubits} qubits, default route, "
               f"{result.generations} generations, eigenvalue {result.eigenvalue:.6f})",
               seconds, int(sum(result.circuit_evaluations)), card, launches)
    say(f"  reduced: generations {SOLVE['generations']} -> {GRADIENT4['generations']} "
        f"(population, pack_min_layers, seed and qubits uncut; no BASELINE config uses the "
        f"gradient optimizer, maxiter {GRADIENT4['maxiter']}, learning rate "
        f"{GRADIENT4['learning_rate']})")
    say(f"  generation bests {[round(b, 6) for b in clock.bests]}")
    require(result.generations == GRADIENT4["generations"], "the gradient solve stopped early")
    require(launches["energies_exact"] > 0, "selection did not launch row 1")
    require(launches["population_states"] > 0, "the prefix states did not launch row 2")
    require(launches["population_probs_folded"] == 1,
            "the final distribution did not launch row 9 once")
    for name in ("nft_layer_sweep", "sampled_shot_indices", "nft_layer_sweep_folded",
                 "sampled_shot_indices_folded", "grouped_shot_indices_folded"):
        require(launches[name] == 0, f"kernel {name} ran in the gradient solve")
    require(clock.bests[1] <= clock.bests[0],
            "the gradient solve's best energy rose from generation 1 to 2")
    tol = 1e-5 * float(table.abs().max())
    plain = best_energy_plain(result, hamiltonian, table)
    require(abs(plain - result.eigenvalue) <= tol,
            "the gradient solve's eigenvalue disagrees with the plain version")


def float64_gradient(objective, angles, table, n_qubits):
    """d(sum of energies)/d theta at theta = 0 through the slot engine's
    arithmetic in float64 (the yardstick of both float32 gradients)."""
    import torch

    from queasars_tpu_torch.sim.statevector import _apply_slot

    gate_types, controls, layer_mask = objective.structure
    mask = objective.coord_mask.double()
    theta = torch.zeros_like(mask).requires_grad_(True)
    shifted = angles.double().reshape(-1).index_add(
        0, objective.flat, (theta * mask).reshape(-1)).reshape(angles.shape)
    state = torch.zeros((angles.shape[0], 2, 1 << n_qubits), dtype=torch.float64,
                        device=angles.device)
    state[:, 0, 0] = 1.0
    for layer, q in objective.slots:
        state = _apply_slot(state, q, gate_types[:, layer, q], controls[:, layer, q],
                            shifted[:, layer, q], layer_mask[:, layer], n_qubits)
    ((state[:, 0] ** 2 + state[:, 1] ** 2) * table.double()).sum().backward()
    return theta.grad


def phase_gradient_minimize(card, hamiltonian, table):
    """One last-layer ``minimize`` call at n=20 (P=16, the cache on): its
    energies against row 6 at the returned angles, the autograd gradient
    along a seeded direction against a central difference of row 1, and the
    angles it must not move; then ``use_fold`` against the slot engine."""
    import numpy as np
    import torch

    from queasars_tpu_torch.optim import BatchedGradientDescent, GradientDescentConfig
    from queasars_tpu_torch.optim.gradient import _Objective
    from queasars_tpu_torch.optim.objective import objective_operands
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator, packed_tensors

    use_route("fold")
    n = hamiltonian.n_qubits
    scale = float(table.abs().max())
    packed, coords, n_free = last_layer_problem(n, GRADIENT_CALL)
    last = (packed.layer_mask.sum(axis=1) - 1).astype(np.int32)
    active = n_free > 0
    active[3] = False
    evaluator = StatevectorExpectationEvaluator(hamiltonian, device=DEVICE)
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    angles, energies, nfev = BatchedGradientDescent(GradientDescentConfig(
        maxiter=GRADIENT4["maxiter"], learning_rate=GRADIENT4["learning_rate"])).minimize(
        evaluator, packed, coords, n_free, active, last_layer=last)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    phase_line(f"gradient minimize (n={n}, P={packed.n_individuals}, last layer, "
               f"maxiter {GRADIENT4['maxiter']})", seconds, nfev * int(active.sum()), card,
               launches)
    require(launches["population_states"] == 1, "the prefix states did not launch row 2 once")
    fold = row_energies(packed, angles, table, n, "fold").cpu().numpy()
    gap = float(np.abs(energies - fold).max())
    keep = np.ones(packed.angles.shape, bool)
    for i in np.nonzero(active)[0]:
        for l, q, k in coords[i, : n_free[i]]:
            keep[i, l, q, k] = False
    say(f"  check: returned energies against row 6 at the returned angles {gap:.3e} "
        f"(bar {1e-5 * scale:.3e}); angles off the free coordinates equal bit for bit: "
        f"{np.array_equal(angles[keep], packed.angles[keep])}")
    require(gap <= 1e-5 * scale, "the returned energies disagree with row 6")
    require(np.array_equal(angles[keep], packed.angles[keep]),
            "minimize moved a padded or inactive coordinate")

    # the autograd gradient along a seeded direction d (|d|_1 = 1 per
    # individual) against a central difference of row 1 at eps = 1e-2:
    # truncation <= (eps^2 / 6) * 8 * max|table| (every coordinate's
    # generator has norm <= 1), float32 energies' rounding <= 2e-6 * max|table|
    # over 2 eps
    eps = 1e-2
    bar = (eps * eps / 6 * 8 + 2 * 2e-6 / (2 * eps)) * scale
    gt, ctrl, ang, lm = packed_tensors(packed, device=DEVICE)
    coords_t = torch.as_tensor(coords, dtype=torch.long, device=DEVICE)
    mask = torch.as_tensor(np.arange(coords.shape[1])[None] < n_free[:, None],
                           dtype=torch.float32, device=DEVICE)
    objective = _Objective(objective_operands(evaluator), n, (gt, ctrl, lm), None, coords_t,
                           mask, ang.shape)
    grad = objective.gradient(ang, torch.zeros_like(mask), False)
    direction = torch.as_tensor(np.random.default_rng(5).normal(size=mask.shape),
                                dtype=torch.float32, device=DEVICE) * mask
    direction = direction / direction.abs().sum(dim=1, keepdim=True).clamp(min=1e-30)
    along = (grad * direction).sum(dim=1).double().cpu().numpy()
    plus = row_energies(packed, objective.shifted(ang, eps * direction), table, n, "slot")
    minus = row_energies(packed, objective.shifted(ang, -eps * direction), table, n, "slot")
    central = ((plus.double() - minus.double()) / (2 * eps)).cpu().numpy()
    worst = float(np.abs(along - central).max())
    say(f"  check: autograd gradient . d against row 1's central difference (eps {eps}): "
        f"largest gap {worst:.3e} (bar {bar:.3e} = (4 eps^2 / 3 + 2e-6 / eps) max|table|); "
        f"individual 0: {along[0]:.6f} vs {central[0]:.6f}")
    require(worst <= bar, "the autograd gradient disagrees with row 1's central difference")

    # use_fold: the fold applier's gradient against the slot engine's at
    # the same start angles (the JAX package's 5e-5 bar, scaled to this
    # table), and the minimize call both ways
    fold_grad = objective.gradient(ang, torch.zeros_like(mask), True)
    grad_gap = float((fold_grad - grad).abs().max())
    exact = float64_gradient(objective, ang, table, n)
    errors = {name: float((g.double() - exact).abs().max()) / scale
              for name, g in (("slot", grad), ("fold", fold_grad))}
    say(f"  check: first-step gradients against the slot engine's in float64, / max|table|: "
        f"slot {errors['slot']:.3e}, fold {errors['fold']:.3e} (bar 1e-6)")
    require(max(errors.values()) <= 1e-6, "a float32 gradient disagrees with float64")
    times = {}
    results = {}
    for use_fold in (True, False):
        reset_memory()
        start = time.perf_counter()
        results[use_fold] = BatchedGradientDescent(GradientDescentConfig(
            maxiter=USE_FOLD_CALL["maxiter"], learning_rate=GRADIENT4["learning_rate"],
            use_fold=use_fold)).minimize(evaluator, packed, coords, n_free, n_free > 0,
                                         last_layer=last)
        torch.cuda.synchronize()
        times[use_fold] = (time.perf_counter() - start, memory_gib())
    finite = all(np.isfinite(r[1]).all() and np.isfinite(r[0]).all() for r in results.values())
    say(f"phase use_fold (n={n}, P={packed.n_individuals}, last layer, maxiter "
        f"{USE_FOLD_CALL['maxiter']}): fold {times[True][0]:.3f} s (peak {times[True][1]:.2f} GiB), "
        f"slot {times[False][0]:.3f} s (peak {times[False][1]:.2f} GiB) | {card}; first-step "
        f"gradients fold vs slot {grad_gap:.3e} (bar {5e-5 * scale:.3e}); finite {finite}; "
        f"energies fold {np.round(results[True][1][:4], 4)} slot {np.round(results[False][1][:4], 4)}")
    require(finite, "a use_fold result is not finite")
    require(grad_gap <= 5e-5 * scale, "the fold gradient disagrees with the slot engine's")


def phase_qaoa(card, hamiltonian):
    """QAOA on config 4's table with QAOAConfiguration's defaults, exact
    and with 512 shots."""
    import numpy as np
    import torch

    from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table_device
    from queasars_tpu_torch.sim.qaoa import qaoa_energies_batch
    from queasars_tpu_torch.solver import QAOAConfiguration, QAOAMinimumEigensolver
    from queasars_tpu_torch.solver.qaoa import start_schedules

    n = hamiltonian.n_qubits
    default = QAOAConfiguration()
    p = default.reps
    say(f"  QAOA: no BASELINE config runs QAOA; config 4's {n}-qubit table under "
        f"QAOAConfiguration's defaults (reps {p}, {default.n_starts} starts, {default.maxiter} "
        f"steps), uncut")

    card_table = diagonal_energy_table_device(hamiltonian, device=DEVICE)

    def starts(device):
        table = card_table.to(device)
        scale = torch.clamp(table.abs().max(), min=1e-6)
        g0, b0, _ = start_schedules(default.seed, default.n_starts, p, scale)
        params = torch.cat([g0, b0], dim=1).requires_grad_(True)
        energies = qaoa_energies_batch(table, params[:, :p], params[:, p:], n)
        energies.sum().backward()
        return table, energies.detach().double().cpu().numpy(), params.grad.double().cpu().numpy()

    table, e_card, g_card = starts(DEVICE)
    _, e_host, g_host = starts("cpu")
    scale = float(table.abs().max())
    e_gap = float(np.abs(e_card - e_host).max())
    g_gap = float(np.abs(g_card - g_host).max() / np.abs(g_host).max())
    say(f"  check: start energies card vs CPU {e_gap:.3e} (bar {1e-5 * scale:.3e}), gradients "
        f"{g_gap:.3e} of the largest (bar 1e-4)")
    require(e_gap <= 1e-5 * scale, "QAOA start energies disagree with the CPU")
    require(g_gap <= 1e-4, "QAOA start gradients disagree with the CPU")
    coeffs, z_masks = hamiltonian.coeffs.real, hamiltonian.z_masks_lo64()
    for shots in (None, QAOA_SHOTS):
        reset_memory()
        reset_launch_counts()
        start = time.perf_counter()
        result = QAOAMinimumEigensolver(QAOAConfiguration(shots=shots, device=DEVICE)
                                        ).compute_minimum_eigenvalue(hamiltonian)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = launch_counts()
        phase_line(f"QAOA ({'exact' if shots is None else f'{shots} shots'}, n={n}, eigenvalue "
                   f"{result.eigenvalue:.6f}, best bitstring energy "
                   f"{result.best_bitstring_energy:.6f})", seconds, result.circuit_evaluations,
                   card, launches)
        norm = float((result.optimal_state.astype(np.float64) ** 2).sum())
        exact = float(table[result.best_bitstring].double())
        parity = np.array([bin(int(z) & result.best_bitstring).count("1") & 1 for z in z_masks])
        host = float(np.sum(coeffs * (1.0 - 2.0 * parity)))
        final = np.asarray(result.start_energies)
        say(f"  check: |psi|^2 {norm:.9f}; best bitstring energy {result.best_bitstring_energy} "
            f"vs table {exact} vs host float64 {host:.6f}; starts' energies before "
            f"{np.round(e_card, 4)} after {np.round(final, 4)}")
        require(not any(launches.values()), "QAOA launched a kernel")
        require(abs(norm - 1.0) <= 1e-5, "the QAOA state is not normalised")
        require(result.best_bitstring_energy == exact,
                "the best bitstring's energy is not the table's")
        require(abs(host - exact) <= 1e-5 * scale, "the table disagrees with the Hamiltonian")
        # at the defaults' learning rate a gamma step (0.05) is hundreds of
        # times the starts' gamma range (1 / max|table|), so single starts
        # can end above where they began, in the JAX package as here; the
        # solve's answer, the best start, must not
        rose = int(np.sum(final > e_card + 1e-6 * scale))
        say(f"  starts that ended above their start energy (record): {rose} of {len(final)}")
        require(result.eigenvalue <= e_card.min() + 1e-6 * scale,
                "the QAOA eigenvalue lies above the best start energy")


def phase_adapt(card, label, operator, settings, scale):
    """One ADAPT-VQE run on the card: the first screen against the CPU's,
    the picks against the screen maxima, energies that do not rise."""
    import numpy as np
    import torch

    from queasars_tpu_torch.paulis import diagonal_energy_table
    from queasars_tpu_torch.sim.expectation import pauli_terms
    from queasars_tpu_torch.solver import AdaptVQEConfiguration, AdaptVQEMinimumEigensolver
    from queasars_tpu_torch.solver.adapt_vqe import _build_pool, screen_pool

    n = operator.n_qubits
    diagonal = operator.is_diagonal
    pool = _build_pool(n, settings["pool"])
    plus = np.stack([np.full(1 << n, np.float32(2.0 ** (-n / 2.0))),
                     np.zeros(1 << n, np.float32)]).astype(np.float32)

    def first_screen(device):
        operands = (diagonal_energy_table(operator, dtype=torch.float32, device=device)
                    if diagonal else pauli_terms(operator, device))
        return screen_pool(torch.as_tensor(plus, device=device), *pool[:3], operands, n, diagonal)

    g_card, g_host = first_screen(DEVICE), first_screen("cpu")
    screen_gap = float(np.abs(g_card - g_host).max() / np.abs(g_host).max())
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    result = AdaptVQEMinimumEigensolver(AdaptVQEConfiguration(device=DEVICE, **settings)
                                        ).compute_minimum_eigenvalue(operator)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    energies = [r.energy for r in result.iterations]
    phase_line(f"ADAPT-VQE {label} ({len(pool[3])} candidates, depth {len(energies)}, "
               f"eigenvalue {result.eigenvalue:.6f})", seconds, result.n_circuit_evaluations,
               card, launches)
    say(f"  picks {[(r.candidate, round(r.gradient, 5)) for r in result.iterations]}; energies "
        f"{[round(e, 6) for e in energies]}; first screen card vs CPU {screen_gap:.3e} of the "
        f"largest (bar 1e-4); first pick |g| {abs(result.iterations[0].gradient):.6f} vs screen "
        f"max {np.abs(g_card).max():.6f}")
    require(len(energies) >= 1, f"ADAPT {label} grew nothing")
    require(screen_gap <= 1e-4, f"ADAPT {label}'s first screen disagrees with the CPU")
    require(abs(abs(result.iterations[0].gradient) - np.abs(g_card).max())
            <= 1e-6 * np.abs(g_card).max(), f"ADAPT {label}'s first pick is not the screen maximum")
    for before, after in zip(energies, energies[1:]):
        require(after <= before + 1e-6 * scale, f"ADAPT {label}'s energy rose")
    require(not any(launches.values()), f"ADAPT {label} launched a kernel")


def phase_qneat(card, hamiltonian, table):
    """QNEAT on config 4's instance (population 16, 3 generations), pure and
    with an NFT polish: row 1 evaluates every generation (the evaluator's
    exact energies take the slot kernel on both routes); the eigenvalue is
    the best individual's energy by rows 6 and 1."""
    import numpy as np

    from queasars_tpu_torch.genome import PackedPopulation
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        QNEATMinimumEigensolver,
        QNEATMinimumEigensolverConfiguration,
    )

    use_route("fold")
    n = hamiltonian.n_qubits
    tol = 1e-5 * float(table.abs().max())
    for polish in (None, BatchedNFT(NFTConfig(maxiter=QNEAT4["nft_maxiter"]))):
        clock = _LaunchClock()
        reset_memory()
        result, seconds, launches = timed_solve(QNEATMinimumEigensolver(
            QNEATMinimumEigensolverConfiguration(
                configured_estimator=ConfiguredEstimator(), configured_sampler=None,
                max_generations=QNEAT4["generations"], max_circuit_evaluations=None,
                termination_criterion=clock, random_seed=QNEAT4["seed"],
                population_size=QNEAT4["population"], optimizer=polish,
                pack_min_layers=SOLVE["pack_min_layers"], device=DEVICE)), hamiltonian)
        kind = "pure" if polish is None else f"NFT polish maxiter {QNEAT4['nft_maxiter']}"
        evals = int(sum(result.circuit_evaluations))
        phase_line(f"QNEAT ({kind}, config 4's {n} qubits, {result.generations} generations, "
                   f"eigenvalue {result.eigenvalue:.6f})", seconds, evals, card, launches)
        say(f"  reduced: no BASELINE config runs QNEAT; population {QNEAT4['population']}, "
            f"{QNEAT4['generations']} generations, config 4's instance uncut")
        per_generation = [c["energies_exact"] for c in clock.launches]
        bests = np.minimum.accumulate(clock.bests)
        packed = PackedPopulation.pack([result.best_individual])
        by_row = {route: float(row_energies(packed, None, table, n, route)[0])
                  for route in ("fold", "slot")}
        nfev = 0 if polish is None else polish.config.n_circuit_evaluations()
        formula = QNEAT4["generations"] * QNEAT4["population"] * (1 + nfev)
        say(f"  check: row 1 launches by generation {per_generation}; best so far "
            f"{[round(b, 6) for b in bests]}; eigenvalue vs row 6 {by_row['fold']:.6f} and row 1 "
            f"{by_row['slot']:.6f} (bar {tol:.3e}); evaluations {evals} vs formula {formula}")
        require(result.generations == QNEAT4["generations"], "the QNEAT solve stopped early")
        require(all(b > a for a, b in zip([0] + per_generation, per_generation)),
                "a QNEAT generation did not launch row 1")
        require(np.all(np.diff(bests) <= 0) and result.eigenvalue == bests[-1],
                "QNEAT's best-so-far energy rose")
        for route, value in by_row.items():
            require(abs(value - result.eigenvalue) <= tol,
                    f"QNEAT's eigenvalue disagrees with the {route} kernel")
        require(evals == formula, "QNEAT's evaluation count is not the reference's formula")


# ---------------------------------------------------------------------------
# the command line, checkpoint and resume, external evaluators, black-box
# bitstring objectives and profiling
# ---------------------------------------------------------------------------


def work_dir(*parts) -> str:
    """A fresh directory under the checkout's ignored ``build/`` for the
    phases' files (instances, checkpoints, results, traces)."""
    import os
    import shutil

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke", *parts)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def write_instance(encoder, path) -> str:
    """The encoder's JSSP instance as JSON through the port's codec."""
    from queasars_tpu_torch.problems.jssp.serialization import JSSPJSONEncoder

    with open(path, "w") as fh:
        json.dump(encoder.jssp_instance, fh, cls=JSSPJSONEncoder)
    return path


def run_cli(args) -> dict:
    """``python -m queasars_tpu_torch`` run in this process: its summary."""
    import contextlib
    import io

    import torch

    from queasars_tpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        status = cli_main(args)
    torch.cuda.synchronize()
    require(status == 0, f"the command line exited {status}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def crash_and_resume(label, card, base, total, crash_at, directory):
    """A CLI solve of ``total`` generations, then one stopped after
    ``crash_at`` (its last checkpoint is the pipeline pass before its last
    selection) and resumed to ``total``: (uninterrupted summary, resumed
    summary, the uninterrupted run's launches)."""
    import os

    from queasars_tpu_torch.solver.checkpoint import load_checkpoint

    checkpoint = os.path.join(directory, "state.json")
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    full = run_cli([*base, "--generations", str(total)])
    seconds = time.perf_counter() - start
    launches = launch_counts()
    phase_line(f"{label}: {total} generations, eigenvalue {full['eigenvalue']:.6f}", seconds,
               sum(full["circuit_evaluations"]), card, launches)
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    first = run_cli([*base, "--generations", str(crash_at), "--checkpoint", checkpoint])
    written = load_checkpoint(checkpoint)
    resumed = run_cli([*base, "--generations", str(total), "--checkpoint", checkpoint, "--resume"])
    seconds = time.perf_counter() - start
    evals = (sum(first["circuit_evaluations"]) + sum(resumed["circuit_evaluations"])
             - sum(written.n_circuit_evaluations))
    phase_line(f"{label}: stopped after {crash_at} generations (checkpoint at generation "
               f"{written.n_generations}), resumed to {total}", seconds, evals, card,
               launch_counts())
    for key in ("best_per_generation", "circuit_evaluations", "eigenvalue", "likeliest_state",
                "generations"):
        require(resumed[key] == full[key],
                f"{label}: the resumed {key} {resumed[key]} differs from the uninterrupted "
                f"{full[key]}")
    say(f"  check: the resumed run equals the uninterrupted one bit for bit (best per "
        f"generation {full['best_per_generation']}, ledger {full['circuit_evaluations']})")
    require(os.path.getsize(checkpoint) > 0, "no checkpoint was written")
    return full, resumed, launches


def phase_cli_resume(card, route, instance_path, makespan):
    """Config 4 through the command line on one route: a 4-generation run
    writing its result, then a crash after 2 generations resumed to 4."""
    import os

    from queasars_tpu_torch.solver.serialization import (
        EvolvingAnsatzMinimumEigensolverResultJSONDecoder,
    )

    use_route(route)
    directory = work_dir(f"cli_{route}")
    output = os.path.join(directory, "result.json")
    base = ["solve", "--jssp", instance_path, "--makespan-limit", str(makespan),
            "--population", str(CLI4["population"]), "--nft-maxiter", str(CLI4["nft_maxiter"]),
            "--seed", str(CLI4["seed"])]
    full, _, launches = crash_and_resume(
        f"CLI config 4 ({route} route)", card, [*base, "--output", output], CLI4["generations"],
        CLI4["crash_at"], directory)
    with open(output) as fh:
        result = json.load(fh, cls=EvolvingAnsatzMinimumEigensolverResultJSONDecoder)
    say(f"  check: --output decodes to {result.generations} generations, eigenvalue "
        f"{result.eigenvalue:.6f}; decoded {full['decoded']}")
    require(result.generations == CLI4["generations"], "the result file has the wrong generations")
    require(result.eigenvalue == full["eigenvalue"], "the result file's eigenvalue differs")
    slot, fold = ROUTE_KERNELS["slot"], ROUTE_KERNELS["fold"]
    must = (slot[0], slot[2], slot[3]) if route == "slot" else (fold[0], fold[2], fold[3])
    for name in must:
        require(launches[name] > 0, f"the CLI solve did not launch {name} on the {route} route")
    if route == "slot":
        require(not any(launches[name] for name in fold), "a fold kernel ran on the slot route")
    else:
        require(launches["nft_layer_sweep"] == 0 and launches["population_probs"] == 0,
                "a slot sweep or probabilities kernel ran on the fold route")


def phase_cli_subprocess(card, instance_path, makespan):
    """``python -m queasars_tpu_torch solve`` in a process of its own (the
    default route, one generation)."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    command = [sys.executable, "-m", "queasars_tpu_torch", "solve", "--jssp", instance_path,
               "--makespan-limit", str(makespan), "--population", str(CLI4["population"]),
               "--nft-maxiter", str(CLI4["nft_maxiter"]), "--seed", str(CLI4["seed"]),
               "--generations", "1"]
    env = {k: v for k, v in os.environ.items() if k != "QUEASARS_MXU"}
    env["PYTHONPATH"] = root
    start = time.perf_counter()
    proc = subprocess.run(command, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - start
    require(proc.returncode == 0, f"python -m queasars_tpu_torch exited {proc.returncode}: "
                                  f"{proc.stderr[-1500:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"phase CLI subprocess (python -m queasars_tpu_torch solve, default route, 1 generation): "
        f"{seconds:.3f} s with the process start, exit 0 | {card} | summary {summary}")
    require(summary["generations"] == 1, "the subprocess summary is wrong")


def phase_cli_sampler_and_qneat(card, encoder3, encoder4):
    """Crash-and-resume on the sampler path (config 3) and with QNEAT
    (config 4), default route: the shot-key counter and the QNEAT
    population resume."""
    use_route("fold")
    directory = work_dir("cli_sampler")
    path3 = write_instance(encoder3, f"{directory}/instance.json")
    base = ["solve", "--jssp", path3, "--makespan-limit", str(encoder3.makespan_limit),
            "--population", str(CLI4["population"]), "--nft-maxiter", str(CLI4["nft_maxiter"]),
            "--seed", str(CLI4["seed"]), "--sampler", "--shots", str(CLI3["shots"]),
            "--alpha-tail", str(CLI3["alpha"])]
    _, _, launches = crash_and_resume(f"CLI config 3 sampler ({encoder3.n_qubits} qubits)", card,
                                      base, CLI3["generations"], CLI3["crash_at"], directory)
    sampled = SAMPLER_ROUTE_KERNELS["fold"][0]
    require(launches[sampled] > 0, f"the sampler solve did not launch {sampled}")
    directory = work_dir("cli_qneat")
    path4 = write_instance(encoder4, f"{directory}/instance.json")
    base = ["solve", "--jssp", path4, "--makespan-limit", str(encoder4.makespan_limit),
            "--population", str(CLI4["population"]), "--nft-maxiter", str(CLI4["nft_maxiter"]),
            "--seed", str(CLI4["seed"]), "--algorithm", "qneat"]
    _, _, launches = crash_and_resume("CLI QNEAT (config 4)", card, base,
                                      CLI_QNEAT["generations"], CLI_QNEAT["crash_at"], directory)
    require(launches["energies_exact"] > 0 and launches["energies_exact_folded"] > 0,
            "the QNEAT solve did not launch rows 1 and 6")
    say(f"  reduced: config 3 generations {CONFIG3['generations']} stopped at "
        f"{CLI3['crash_at']} and resumed; QNEAT (no BASELINE config) {CLI_QNEAT['generations']} "
        f"generations; the CLI's own EVQE settings (parameter search 0.4, topological 0.5, "
        f"removal 0.1, penalties 0.1 / 0.05, tournament 2), population {CLI4['population']}, "
        f"NFT maxiter {CLI4['nft_maxiter']}")


def phase_external(card, hamiltonian, table):
    """An external backend: a callback that rebinds each circuit's
    parameters, packs the circuits and returns the port's internal
    evaluator's energies on the card (config 4's table)."""
    import numpy as np

    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.optim import BatchedNFT, BatchedSPSA, NFTConfig, SPSAConfig
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
    from queasars_tpu_torch.sim.external import CallbackCircuitEvaluator
    from queasars_tpu_torch.solver import (
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    use_route("fold")
    n = hamiltonian.n_qubits
    internal = StatevectorExpectationEvaluator(hamiltonian, device=DEVICE)
    calls = [0]

    def backend(circuits, parameter_values):
        calls[0] += 1
        return internal.evaluate_circuits(circuits, parameter_values)

    external = CallbackCircuitEvaluator(backend, n, name="internal-evaluator backend")
    scale = float(table.abs().max())
    cfg = EXTERNAL
    population = EVQEPopulation.random_population(n, cfg["layers"], cfg["population"], True,
                                                  random_seed=cfg["seed"])
    packed = PackedPopulation.pack(list(population.individuals),
                                   min_layers=SOLVE["pack_min_layers"])
    got, want = external.evaluate_packed(packed), internal.evaluate_packed(packed)
    gap = float(np.abs(got - want).max())
    say(f"phase external backend (a): callback vs evaluate_packed at n={n}, P={cfg['population']}, "
        f"{cfg['layers']} layers: max |difference| {gap:.3e} (bar {1e-6 * scale:.3e}), equal bits "
        f"{bool(np.array_equal(got, want))}")
    require(gap <= 1e-6 * scale, "the callback's energies disagree with the internal evaluator's")

    clock = _LaunchClock()
    solver = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=None, configured_sampler=None, evaluator=external,
        optimizer=BatchedNFT(NFTConfig(maxiter=cfg["maxiter"])),
        optimizer_n_circuit_evaluations=None, max_generations=cfg["generations"],
        max_circuit_evaluations=None, termination_criterion=clock, random_seed=SOLVE["seed"],
        population_size=cfg["population"], speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
        parameter_search_probability=0.25, topological_search_probability=0.4,
        layer_removal_probability=0.05, pack_min_layers=SOLVE["pack_min_layers"], device=DEVICE))
    calls[0] = 0
    reset_memory()
    result, seconds, launches = timed_solve(solver, hamiltonian)
    phase_line(f"external backend (b): EVQE solve through the callback (config 4, "
               f"{result.generations} generations, host-stepped NFT maxiter {cfg['maxiter']}, "
               f"{calls[0]} callback calls, eigenvalue {result.eigenvalue:.6f})", seconds,
               int(sum(result.circuit_evaluations)), card, launches)
    say(f"  reduced: generations {SOLVE['generations']} -> {cfg['generations']}, NFT maxiter "
        f"{SOLVE['maxiter']} -> {cfg['maxiter']} (population and qubits uncut)")
    bests = np.minimum.accumulate(clock.bests)
    say(f"  check: generation bests {[round(b, 6) for b in clock.bests]}, best so far "
        f"{[round(b, 6) for b in bests]}")
    require(result.generations == cfg["generations"], "the external solve stopped early")
    require(result.eigenvalue == bests[-1] and np.all(np.diff(bests) <= 0),
            "the external solve's best energy rose")
    require(launches["energies_exact"] > 0, "the callback did not launch row 1")
    for name in ("nft_layer_sweep", "nft_layer_sweep_folded", "energies_exact_folded"):
        require(launches[name] == 0, f"{name} ran: NFT did not step on the host")
    require(launches["population_probs_folded"] == 1,
            "the final distribution did not launch row 9 once")

    spsa_packed, coords, n_free = last_layer_problem(n, dict(
        population=cfg["population"], layers=3, seed=cfg["seed"] + 1))
    before = external.evaluate_packed(spsa_packed)
    calls[0] = 0
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    angles, energies, nfev = BatchedSPSA(SPSAConfig(maxiter=cfg["spsa_maxiter"])).minimize(
        external, spsa_packed, coords, n_free, n_free > 0, seed=cfg["seed"])
    seconds = time.perf_counter() - start
    phase_line(f"external backend (c): host-stepped SPSA minimize (P={cfg['population']}, "
               f"maxiter {cfg['spsa_maxiter']}, {calls[0]} callback calls)", seconds, nfev, card,
               launch_counts())
    say(f"  check: mean energy {float(before.mean()):.6f} -> {float(energies.mean()):.6f}")
    require(float(energies.mean()) <= float(before.mean()), "SPSA raised the mean energy")
    require(np.array_equal(energies, internal.evaluate_packed(spsa_packed, angles=angles)),
            "SPSA's final energies are not the internal evaluator's at its angles")


def reference_function_values(observed, counts, values, shots, alpha):
    """The float64 expectation or CVaR of counts [P, K] over the observed
    states' objective values [K]: frequencies as float32 counts times the
    float32 reciprocal of the shots, then the reference's arithmetic
    (queasars_tpu/sim/evaluators.py:663-680) on the host."""
    import numpy as np

    probs = (counts.astype(np.float32) * np.float32(1.0 / shots)).astype(np.float64)
    if alpha >= 1.0:
        return probs @ values
    order = np.argsort(values, kind="stable")
    v_sorted = values[order]
    p_sorted = probs[:, order]
    cum_prev = np.cumsum(p_sorted, axis=1) - p_sorted
    weights = np.clip(alpha - cum_prev, 0.0, p_sorted)
    return (weights * v_sorted).sum(axis=1) / alpha


def phase_function_value(card, hamiltonian3):
    """A black-box bitstring objective: config 3's diagonal energy of the
    bitstring, minimised by ``compute_minimum_function_value``."""
    import numpy as np
    import torch

    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.paulis import diagonal_energy_table
    from queasars_tpu_torch.sim import fold_kernels, slot_kernels
    from queasars_tpu_torch.sim.evaluators import (
        BitstringFunctionEvaluator,
        observed_frequencies,
        packed_tensors,
    )
    from queasars_tpu_torch.sim.fold_pipeline import build_fold_pipeline
    from queasars_tpu_torch.sim.sampling import sample_indices
    from queasars_tpu_torch.solver import (
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )
    from queasars_tpu_torch.utils import BitstringEvaluator, prng

    cfg = FUNCTION3
    n = hamiltonian3.n_qubits
    energies = diagonal_energy_table(hamiltonian3, dtype=torch.float64).numpy()
    calls = []

    def energy(bits: str) -> float:
        # the bitstring is the basis state written most significant qubit
        # first: bits[0] is qubit n-1, bits[-1] qubit 0
        calls.append(bits)
        return float(energies[int(bits, 2)])

    objective = BitstringEvaluator(n, energy)
    population = EVQEPopulation.random_population(n, cfg["layers"], cfg["population"], True,
                                                  random_seed=cfg["seed"] + 7)
    packed = PackedPopulation.pack(list(population.individuals),
                                   min_layers=SOLVE["pack_min_layers"])
    tensors = packed_tensors(packed, device=DEVICE)
    keys = prng.split(prng.fold_in(prng.PRNGKey(cfg["seed"]), 1), packed.n_individuals)
    frac = prng.uniform(keys, (cfg["shots"],)).to(DEVICE)
    for route in ("slot", "fold"):
        use_route(route)
        evaluator = BitstringFunctionEvaluator(objective, cfg["shots"], cfg["alpha"],
                                               seed=cfg["seed"], device=DEVICE)
        reset_launch_counts()
        probs = evaluator.probabilities(packed)
        launched = per_row(launch_counts())
        if route == "slot":
            plain = slot_kernels.population_probs_plain(*tensors, n)
        else:
            pipeline = build_fold_pipeline(*tensors, n, absorb_diag=True)
            plain = fold_kernels.population_probs_folded_plain(pipeline, n)
        got = evaluator.energies_from_probabilities(probs, keys)
        want = evaluator.energies_from_probabilities(plain, keys)
        drawn = sample_indices(keys, probs, cfg["shots"])
        drawn_plain = sample_indices(keys, plain, cfg["shots"])
        share, not_boundary = draw_agreement(plain, frac, drawn, drawn_plain)
        # an individual whose draws all agree has the plain version's value;
        # each flipped draw moves a CVaR by at most 2 max|f| / (alpha shots)
        flips = (drawn != drawn_plain).sum(dim=1).cpu().numpy()
        allowed = flips * 2 * float(np.abs(energies).max()) / (cfg["alpha"] * cfg["shots"])
        # bar (b): the values again, in float64 on the host from the counts
        # read back from the device
        observed, frequencies = observed_frequencies(keys, probs, cfg["shots"])
        counts = torch.round(frequencies * cfg["shots"]).to(torch.int64).cpu().numpy()
        values = np.array([energies[s] for s in observed.cpu().numpy()])
        host = reference_function_values(observed, counts, values, cfg["shots"], cfg["alpha"])
        say(f"phase bitstring function (a, b) on the {route} route (n={n}, P={cfg['population']}, "
            f"{cfg['shots']} shots, alpha {cfg['alpha']}): launches {launched}; kernel vs plain "
            f"probabilities: draws equal {share:.4%} (non-boundary differences {not_boundary}), "
            f"individuals with every draw equal {int((flips == 0).sum())} of {len(flips)}, values "
            f"max |difference| {float(np.abs(got - want).max()):.3e} (flipped-draw bound "
            f"{float(allowed.max()):.3e}); host float64 recomputation from {int(counts.sum())} "
            f"counts over {len(values)} states equal {bool(np.array_equal(host, got))}")
        row = "row 4" if route == "slot" else "row 9"
        require(launched.get(row, 0) == 1, f"the probabilities did not launch {row} once")
        bar = SLOT_DRAW_BAR if route == "slot" else FOLD_DRAW_BAR
        require(share >= bar and not_boundary == 0,
                f"the {route} route's draws disagree with the plain version's")
        require(np.all(np.abs(got - want) <= allowed),
                f"the {route} route's values differ from the plain version's beyond its flips")
        require(np.array_equal(host, got), "the host recomputation disagrees with the evaluator")

    use_route("fold")
    clock = _LaunchClock()
    solver = EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=None,
        configured_sampler=ConfiguredSampler(shots=cfg["shots"], seed=cfg["seed"]),
        optimizer=BatchedNFT(NFTConfig(maxiter=cfg["maxiter"])),
        optimizer_n_circuit_evaluations=None, max_generations=cfg["generations"],
        max_circuit_evaluations=None, termination_criterion=clock, random_seed=cfg["seed"],
        population_size=cfg["population"], speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
        parameter_search_probability=0.25, topological_search_probability=0.4,
        layer_removal_probability=0.05, use_tournament_selection=True,
        tournament_size=CONFIG3["tournament_size"], distribution_alpha_tail=cfg["alpha"],
        pack_min_layers=SOLVE["pack_min_layers"], device=DEVICE))
    calls.clear()
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    result = solver.compute_minimum_function_value(objective)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    phase_line(f"bitstring-function solve (config 3's energies, {n} qubits, default route, "
               f"{result.generations} generations, host-stepped NFT maxiter {cfg['maxiter']}, "
               f"best {result.eigenvalue:.6f})", seconds, int(sum(result.circuit_evaluations)),
               card, launches)
    say(f"  reduced: generations {CONFIG3['generations']} -> {cfg['generations']}, NFT maxiter "
        f"{CONFIG3['maxiter']} -> {cfg['maxiter']} (shots, alpha, population and qubits uncut)")
    bests = np.minimum.accumulate(clock.bests)
    say(f"  check (c, d): the function ran {len(calls)} times on {len(set(calls))} distinct "
        f"states; generation bests {[round(b, 6) for b in clock.bests]}, best so far "
        f"{[round(b, 6) for b in bests]}")
    require(len(calls) == len(set(calls)), "the function ran twice on one state")
    require(result.eigenvalue == bests[-1] and np.all(np.diff(bests) <= 0),
            "the function solve's best value rose")
    require(launches["population_probs_folded"] > 0, "the function solve did not launch row 9")
    for name in ("nft_layer_sweep_folded", "energies_exact_folded", "sampled_shot_indices_folded",
                 "sampled_shot_indices"):
        require(launches[name] == 0, f"{name} ran in the function solve")


def phase_profiling(card, hamiltonian):
    """``utils/profiling.trace`` around one config 4 slot solve, with the
    selection operator inside ``annotate("selection")``."""
    import glob
    import os

    from queasars_tpu_torch.utils.profiling import annotate, trace

    use_route("slot")
    solver = config4_solver()
    selection = solver.configuration.evolutionary_operators[2]
    apply_operator = selection.apply_operator

    def annotated(population, operator_context):
        with annotate("selection"):
            return apply_operator(population, operator_context)

    selection.apply_operator = annotated
    directory = work_dir("trace")
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    with trace(directory, label="config4-slot"):
        result = solver.compute_minimum_eigenvalue(hamiltonian)
    seconds = time.perf_counter() - start
    (path,) = glob.glob(os.path.join(directory, "config4-slot.*.pt.trace.json"))
    with open(path) as fh:
        names = [event.get("name", "") for event in json.load(fh)["traceEvents"]]
    slot_passes = sum("slot_pass" in name for name in names)
    selections = names.count("selection")
    phase_line(f"profiled config 4 slot solve ({result.generations} generations, trace "
               f"{os.path.getsize(path) / 2**20:.2f} MiB, {len(names)} events, {slot_passes} "
               f"slot_pass events, {selections} selection annotations)", seconds,
               int(sum(result.circuit_evaluations)), card, launch_counts())
    require(slot_passes > 0, "the trace names no slot_pass kernel")
    require(selections == result.generations, "the trace lacks the selection annotations")


# ---------------------------------------------------------------------------
# the population mesh (phases 27-30)
# ---------------------------------------------------------------------------

#: blocks of the one-card mesh the mesh phases split the population into
MESH_BLOCKS = 4
#: the two-process phase: config 4 on the slot route, 4 generations cut to 2
MULTIHOST4 = dict(SOLVE, generations=2)
#: how long each process of the two-process phase may take
WORKER_TIMEOUT_S = 300
#: the kernels a mesh solve must launch: the searches' full-circuit
#: objective (the prefix cache is off under a mesh, so no sweep runs), the
#: per-slot search's prefix states (row 2 on both routes at n <= 20) and the
#: final distribution; the sampler solve its sampled kernel instead
MESH_ROUTE_KERNELS = {
    "config 4 slot": ("energies_exact", "population_states", "population_probs"),
    "config 4 fold": ("energies_exact_folded", "population_states", "population_probs_folded"),
    "config 3 sampler slot": ("sampled_shot_indices", "population_states", "population_probs"),
}
#: the command line's EVQE settings (queasars_tpu_torch/__main__.py)
CLI_EVQE = dict(penalties=(0.1, 0.05), parameter_search=0.4, topological=0.5, removal=0.1,
                tournament_size=2)


def card_meshes():
    """The two meshes of the mesh phases: ``population_mesh()`` (every
    visible card, one block each) and ``MESH_BLOCKS`` blocks on the first
    card."""
    from queasars_tpu_torch.parallel import population_mesh

    return {"population_mesh()": population_mesh(),
            f"{MESH_BLOCKS} blocks on one card": population_mesh(
                devices=[f"{DEVICE}:0"] * MESH_BLOCKS)}


def trajectory(result) -> dict:
    """A solve's trajectory, JSON-able: every generation's energies, the
    ledger, the eigenvalue and the best individual."""
    return {
        "energies": [[None if v is None else float(v) for v in g.expectation_values]
                     for g in result.population_evaluation_results],
        "evaluations": [int(v) for v in result.circuit_evaluations],
        "eigenvalue": float(result.eigenvalue),
        "best_individual": repr(result.best_individual),
    }


def all_coordinates(packed):
    """Every individual's free coordinates [P, K, 3], padded with zeros, and
    their counts [P]."""
    import numpy as np

    width = int(packed.n_params.max())
    coords = np.stack([
        np.pad(packed.param_coordinates(i), ((0, width - packed.n_params[i]), (0, 0)))
        for i in range(packed.n_individuals)
    ])
    return coords, np.asarray(packed.n_params)


def phase_mesh_primitives(card, w):
    """Phase 27: ``sharded_population_energies`` and ``sharded_training_step``
    at bench.py's shape on each mesh and route, bit-equal to the unsharded
    row 1 / row 6 call and to each other."""
    import numpy as np
    import torch

    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.parallel import sharded_population_energies, sharded_training_step

    n = N_QUBITS
    population = EVQEPopulation.random_population(
        n, BENCH["layers"], BENCH["population"], True, random_seed=0)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=BENCH["layers"])
    coords, n_free = all_coordinates(packed)
    active = np.ones(packed.n_individuals, bool)
    table = w.bench_table
    meshes = card_meshes()
    for route in ("slot", "fold"):
        use_route(route)
        reset_launch_counts()
        start = time.perf_counter()
        plain = row_energies(packed, None, table, n, route).cpu().numpy()
        torch.cuda.synchronize()
        say(f"phase mesh energies ({route} route, n={n}, P={packed.n_individuals}, "
            f"{BENCH['layers']} layers, {BENCH['terms']} terms): unsharded row "
            f"{1 if route == 'slot' else 6} call {time.perf_counter() - start:.4f} s | {card} "
            f"| launches per row {per_row(launch_counts())}")
        steps = {}
        for label, mesh in meshes.items():
            reset_launch_counts()
            start = time.perf_counter()
            got = sharded_population_energies(mesh, packed, table)
            seconds = time.perf_counter() - start
            say(f"  {label} ({mesh.size} block(s)): {seconds:.4f} s, launches per row "
                f"{per_row(launch_counts())}, equal bits to the unsharded call: "
                f"{bool(np.array_equal(got, plain))}")
            require(np.array_equal(got, plain),
                    f"sharded energies on {label} ({route}) differ from the unsharded call by "
                    f"{float(np.abs(got - plain).max()):.3e}")
            reset_launch_counts()
            start = time.perf_counter()
            steps[label] = sharded_training_step(mesh, packed, table, coords, n_free, active)
            say(f"  {label}: training step (NFT maxiter 4) {time.perf_counter() - start:.4f} s, "
                f"mean energy {float(plain.mean()):.6f} -> {float(steps[label][1].mean()):.6f}, "
                f"launches per row {per_row(launch_counts())}")
        (a1, e1), (a4, e4) = steps.values()
        require(np.array_equal(a1, a4) and np.array_equal(e1, e4),
                f"the training step differs across the meshes on the {route} route")
        require(e1.mean() < plain.mean(), "the training step did not lower the energies")
        say(f"  check: the training step is bit-equal on both meshes ({route} route)")


def phase_mesh_solves(card, hamiltonian, hamiltonian3):
    """Phase 28: config 4 per route and config 3's sampler solve (slot
    route) unsharded, on ``population_mesh()`` and on four blocks of one
    card; the two meshes' trajectories must be equal bit for bit."""
    meshes = card_meshes()
    cases = [("config 4", route, config4_solver, hamiltonian) for route in ("slot", "fold")]
    cases.append(("config 3 sampler", "slot", config3_solver, hamiltonian3))
    for name, route, make, operator in cases:
        use_route(route)
        runs = {}
        for label, mesh in [("unsharded", None), *meshes.items()]:
            result, seconds, launches = timed_solve(make(mesh=mesh), operator)
            solve_line(f"mesh {name} ({route} route, {label})", result, seconds, card, launches)
            runs[label] = trajectory(result)
            if mesh is None:
                continue
            for kernel in MESH_ROUTE_KERNELS[f"{name} {route}"]:
                require(launches[kernel] > 0, f"{name} on {label} did not launch {kernel}")
            require(not launches["nft_layer_sweep"] and not launches["nft_layer_sweep_folded"],
                    f"a sweep kernel ran in {name}'s mesh solve (the prefix cache is off)")
            if route == "slot":
                require(not any(launches[k] for k in ROUTE_KERNELS["fold"]),
                        f"a fold kernel ran in {name}'s slot-route mesh solve")
        one, four = (runs[label] for label in meshes)
        require(one == four, f"{name} ({route} route): the mesh trajectories differ")
        say(f"  check: {name} ({route} route) gives equal trajectories on both meshes "
            f"(eigenvalue {one['eigenvalue']:.6f}; unsharded {runs['unsharded']['eigenvalue']:.6f}"
            f", which caches prefixes the mesh does not)")


MULTIHOST_WORKER = """
import sys
import chip_smoke
sys.exit(chip_smoke.multihost_worker(sys.argv[1], int(sys.argv[2])))
"""


def multihost_worker(address: str, rank: int) -> int:
    """One process of phase 29: join the two-process group, solve config 4
    (cut) on the slot route over ``population_mesh()``, print the
    trajectory."""
    import torch

    from queasars_tpu_torch.parallel import initialize_multihost, population_mesh, process_info

    initialize_multihost(coordinator_address=address, num_processes=2, process_id=rank)
    try:
        mesh = population_mesh()
        _, encoder, hamiltonian = jssp_with_qubits(3, 3, 6, N_QUBITS, {1: 0.5, 2: 0.5})
        use_route("slot")
        result, seconds, launches = timed_solve(
            config4_solver(mesh=mesh, settings=MULTIHOST4), hamiltonian)
        print("RESULT" + json.dumps({
            "rank": rank, "process_info": list(process_info()), "blocks": mesh.size,
            "seconds": seconds, "launches": per_row(launches),
            "trajectory": trajectory(result)}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_multihost(card, hamiltonian):
    """Phase 29: two processes on the card (gloo, both ranks on the first
    card) solve config 4 (slot route, 2 generations) over the two-process
    mesh; both must equal the one-process two-block solve."""
    import os
    import socket

    from queasars_tpu_torch.parallel import population_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root, "QUEASARS_MXU": "0"}
    start = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", MULTIHOST_WORKER, f"localhost:{port}",
                               str(rank)], cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=WORKER_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        raise Failure("a process of the two-process phase timed out")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    seconds = time.perf_counter() - start
    payloads = {}
    for rank, (proc, (out, err)) in enumerate(zip(procs, outputs)):
        require(proc.returncode == 0, f"rank {rank} exited {proc.returncode}: {err[-1500:]}")
        for line in out.splitlines():
            if line.startswith("RESULT"):
                payloads[rank] = json.loads(line[len("RESULT"):])
    require(set(payloads) == {0, 1}, "a rank printed no result")
    use_route("slot")
    result, local_seconds, launches = timed_solve(
        config4_solver(mesh=population_mesh(devices=[f"{DEVICE}:0"] * 2), settings=MULTIHOST4),
        hamiltonian)
    local = trajectory(result)
    for rank in (0, 1):
        p = payloads[rank]
        say(f"phase two processes (gloo, rank {rank} of {p['process_info'][1]}, "
            f"{p['blocks']} blocks): config 4 slot route {MULTIHOST4['generations']} "
            f"generations in {p['seconds']:.3f} s, eigenvalue "
            f"{p['trajectory']['eigenvalue']:.6f} | {card} | launches per row {p['launches']}")
        require(p["trajectory"] == local, f"rank {rank}'s trajectory differs from the "
                                          f"one-process two-block solve")
    solve_line("one process, 2 blocks (the comparison)", result, local_seconds, card, launches)
    say(f"  check: both ranks equal the one-process two-block trajectory bit for bit "
        f"({seconds:.1f} s with both processes' start); reduced: config 4's "
        f"{SOLVE['generations']} generations cut to {MULTIHOST4['generations']}")


def cli_solver(mesh, generations=None, shard_amplitudes=None, settings=CLI4):
    """The command line's EVQE solve (``queasars_tpu_torch/__main__.py``) on
    ``settings`` (config 4's by default), with ``mesh``, ``generations``
    (None: the settings') and ``shard_amplitudes``."""
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(),
        configured_sampler=ConfiguredSampler(shots=2048, seed=settings["seed"]),
        optimizer=BatchedNFT(NFTConfig(maxiter=settings["nft_maxiter"])),
        optimizer_n_circuit_evaluations=None,
        max_generations=settings["generations"] if generations is None else generations,
        max_circuit_evaluations=None,
        termination_criterion=None,
        random_seed=settings["seed"],
        population_size=settings["population"],
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=CLI_EVQE["penalties"][0],
        selection_beta_penalty=CLI_EVQE["penalties"][1],
        parameter_search_probability=CLI_EVQE["parameter_search"],
        topological_search_probability=CLI_EVQE["topological"],
        layer_removal_probability=CLI_EVQE["removal"],
        use_tournament_selection=True,
        tournament_size=CLI_EVQE["tournament_size"],
        device=DEVICE,
        mesh=mesh,
        shard_amplitudes=shard_amplitudes,
    ))


def phase_mesh_adapt_and_cli(card, hamiltonian, instance_path, makespan):
    """Phase 30: ADAPT-VQE (b)'s first screen on four blocks of the card
    equals the unsharded screen bit for bit; then ``python -m
    queasars_tpu_torch solve --n-devices 1`` on config 4 equals the
    ``population_mesh(1)`` solve."""
    import os

    import numpy as np
    import torch

    from queasars_tpu_torch.parallel import population_mesh
    from queasars_tpu_torch.paulis import diagonal_energy_table
    from queasars_tpu_torch.solver.adapt_vqe import _build_pool, screen_pool, screen_pool_sharded

    n = hamiltonian.n_qubits
    pool = _build_pool(n, ADAPT_JSSP["pool"])
    plus = torch.full((2, 1 << n), float(np.float32(2.0 ** (-n / 2.0))), device=DEVICE)
    plus[1] = 0.0
    table = diagonal_energy_table(hamiltonian, dtype=torch.float32, device=DEVICE)
    start = time.perf_counter()
    single = screen_pool(plus, *pool[:3], table, n, True)
    single_s = time.perf_counter() - start
    mesh = card_meshes()[f"{MESH_BLOCKS} blocks on one card"]
    reset_launch_counts()
    start = time.perf_counter()
    sharded = screen_pool_sharded(mesh, plus, *pool[:3], table, n, True)
    sharded_s = time.perf_counter() - start
    say(f"phase mesh ADAPT-VQE (b) screen ({len(pool[3])} candidates, n={n}): unsharded "
        f"{single_s:.3f} s, {mesh.size} blocks {sharded_s:.3f} s, equal bits "
        f"{bool(np.array_equal(single, sharded))}, largest |g| {np.abs(single).max():.6f} | "
        f"{card} | launches per row {per_row(launch_counts())}")
    require(np.array_equal(single, sharded), "the sharded ADAPT screen differs from the "
            f"unsharded one by {float(np.abs(single - sharded).max()):.3e}")

    root = os.path.dirname(os.path.abspath(__file__))
    command = [sys.executable, "-m", "queasars_tpu_torch", "solve", "--jssp", instance_path,
               "--makespan-limit", str(makespan), "--population", str(CLI4["population"]),
               "--nft-maxiter", str(CLI4["nft_maxiter"]), "--seed", str(CLI4["seed"]),
               "--generations", str(CLI4["generations"]), "--n-devices", "1"]
    env = {**os.environ, "PYTHONPATH": root, "QUEASARS_MXU": "0"}
    start = time.perf_counter()
    proc = subprocess.run(command, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - start
    require(proc.returncode == 0, f"the --n-devices 1 solve exited {proc.returncode}: "
                                  f"{proc.stderr[-1500:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    use_route("slot")
    result, local_seconds, launches = timed_solve(cli_solver(population_mesh(1)), hamiltonian)
    say(f"phase CLI --n-devices 1 (config 4, slot route, {summary['generations']} generations): "
        f"{seconds:.3f} s with the process start; population_mesh(1) in process "
        f"{local_seconds:.3f} s, eigenvalue {result.eigenvalue:.6f} | {card} | launches per row "
        f"{per_row(launches)}")
    likeliest = max(result.eigenstate, key=result.eigenstate.get)
    ours = {"best_per_generation": [g.best_expectation_value
                                    for g in result.population_evaluation_results],
            "eigenvalue": result.eigenvalue, "circuit_evaluations": result.circuit_evaluations,
            "likeliest_state": likeliest}
    for key, value in ours.items():
        require(summary[key] == value, f"--n-devices 1's {key} {summary[key]} differs from the "
                                       f"population_mesh(1) solve's {value}")
    say("  check: the CLI's --n-devices 1 summary equals the population_mesh(1) solve")


# ---------------------------------------------------------------------------
# amplitude sharding (phases 31-34)
# ---------------------------------------------------------------------------

#: config 8 (experiments/exp_solve_n22.py:70-78): 22-qubit 3x3 JSSP, exact
#: estimator, P=16, NFT maxiter 30, 3 generations; the 2 x 2 factorization's
#: run is cut to ``cut`` generations (printed as ``reduced``)
CONFIG8 = dict(qubits=22, makespan=7, population=16, maxiter=30, generations=3,
               pack_min_layers=6, seed=0, cut=1)
#: config 7 (:54-65): 21-qubit instance, 512 shots (seed 0), CVaR 0.5,
#: tournament 2; its 3 generations cut to 1 on 2 blocks
CONFIG7 = dict(qubits=21, makespan=6, population=16, maxiter=30, generations=1, shots=512,
               sampler_seed=0, alpha=0.5, tournament_size=2, pack_min_layers=6, seed=0)
#: the primitives' population (phase 31) and the meshes of one card
AMP_PRIMITIVES = dict(population=16, layers=6, seed=22)
AMP_MESHES = {"1x1": (1, 1), "1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
#: QAOA on config 4's table (phase 34): starts and reps of QAOAConfiguration's
#: defaults; the cut solve's Adam steps
AMP_QAOA = dict(starts=8, reps=2, maxiter=10)
#: the two-process amplitude case (phase 34): P=4 (padded to 8) on config 8's
#: operator, a last-layer NFT sweep of 4 steps
AMP_MULTIHOST = dict(population=4, layers=6, seed=5, maxiter=4)
SHARD_SOURCE = "queasars_tpu_torch/csrc/shard_kernels.cu"
#: the amplitude-shard kernels (port-only rows: the JAX package's sharded
#: engine is XLA code) and the XLA function each stands for
SHARD_KERNELS = {
    "shard_pair_combine": (SHARD_SOURCE, "queasars_tpu/sim/sharded_statevector.py:87"),
    "shard_group_product": (SHARD_SOURCE, "queasars_tpu/sim/sharded_fold.py:105"),
    "shard_diag_phase": (SHARD_SOURCE, "queasars_tpu/sim/sharded_fold.py:167"),
    "shard_running_sum": (SHARD_SOURCE, "queasars_tpu/sim/sharded_statevector.py:238"),
}


def card_amp_mesh(n_pop, n_amp):
    from queasars_tpu_torch.parallel.amplitude import pop_amp_mesh

    return pop_amp_mesh(n_pop, n_amp, devices=[f"{DEVICE}:0"] * (n_pop * n_amp))


def use_shard_route(route: str) -> None:
    """``QUEASARS_SHARD_FOLD=0`` for the per-gate route, unset (the default)
    for the fold route."""
    import os

    if route == "per-gate":
        os.environ["QUEASARS_SHARD_FOLD"] = "0"
    else:
        os.environ.pop("QUEASARS_SHARD_FOLD", None)


def exchange_line() -> str:
    from queasars_tpu_torch.parallel.amplitude import exchange_bytes

    return ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in exchange_bytes.items())


def host_energy(hamiltonian, state: int) -> float:
    """A basis state's energy from the Hamiltonian's terms, float64 on the
    host."""
    import numpy as np

    from queasars_tpu_torch.paulis.diagonal import diagonal_terms

    coeffs, masks = diagonal_terms(hamiltonian)
    parity = np.array([bin(int(state) & int(m)).count("1") & 1 for m in masks], np.float64)
    return float((1.0 - 2.0 * parity) @ coeffs)


def unitary_factors(gen, rows, n):
    """[rows, n, 2 (re/im), 2, 2] float32 per-qubit unitaries (QR of complex
    normal matrices): random fold factors."""
    import torch

    z = torch.complex(torch.randn((rows, n, 2, 2), generator=gen, dtype=torch.float64),
                      torch.randn((rows, n, 2, 2), generator=gen, dtype=torch.float64))
    q, r = torch.linalg.qr(z)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    u = q * (d / d.abs())[..., None, :]
    return torch.stack([u.real, u.imag], dim=2).float()


def matmul_group_operands(state, dense, local_bits, q0, m):
    """``torch.matmul``'s operands for S2's product on one shard: the
    complex group matrices U [B, d, d] (``dense`` [B, 2, d, d], re and im)
    and the group vectors as the columns of [B, d, instances] (one batched
    product per row)."""
    import torch

    rows, d = state.shape[0], 1 << m
    x = torch.complex(state[:, 0], state[:, 1]).reshape(
        rows, (1 << local_bits) >> (q0 + m), d, 1 << q0)
    columns = x.transpose(1, 2).reshape(rows, d, -1).contiguous()
    return torch.complex(dense[:, 0], dense[:, 1]).contiguous(), columns


def matmul_group_product(state, dense, local_bits, q0, m):
    """S2's function by one ``torch.matmul`` with the dense Kronecker matrix
    (TF32 off by the caller), back in the shard's [B, 2, 2^local_bits]
    layout."""
    import torch

    rows, d = state.shape[0], 1 << m
    u, columns = matmul_group_operands(state, dense, local_bits, q0, m)
    out = torch.matmul(u, columns).reshape(rows, d, -1, 1 << q0).transpose(1, 2)
    return torch.stack([out.real, out.imag], dim=1).reshape(state.shape)


def group_product_mesh_gaps(state, entries, dense, n, q0, m):
    """S2 (on the factor ``entries``) and ``torch.matmul`` (on their
    ``dense`` Kronecker matrices) on the n-qubit rows of ``state`` cut as the
    1x1, 1x2, 1x4 and 2x2 meshes cut it (rows over pop, amplitudes over
    amp): per implementation and mesh, the largest difference from the 1x1
    result (0.0: equal bits)."""
    import torch

    from queasars_tpu_torch.sim import shard_kernels as shk

    gaps = {}
    for label, product, operand in (("S2", shk.group_product, entries),
                                    ("torch.matmul", matmul_group_product, dense)):
        whole = None
        for mesh, (n_pop, n_amp) in AMP_MESHES.items():
            lb = n - n_amp.bit_length() + 1
            got = torch.cat([
                torch.cat([product(s.contiguous(), u, lb, q0, m) for s in rows.chunk(n_amp, dim=2)],
                          dim=2)
                for rows, u in zip(state.chunk(n_pop), operand.chunk(n_pop))])
            if whole is None:
                whole = got
            gaps[(label, mesh)] = 0.0 if torch.equal(got, whole) else float(
                (got - whole).abs().max())
    return gaps


def shard_kernel_records(n):
    """Phase 31's kernel checks at the 1x4 shard shapes of an n-qubit state
    (P=16): each shard kernel against its plain version on the same card
    inputs (equal bits), ms against the plain version's, the bound and the
    library call where there is one; S2 also on the groups (0, 7) and (7, 3)
    and on shards of 2^5 to 2^8 amplitudes (tiles of 1 to 8 threads); then
    S2 and ``torch.matmul`` across shard widths."""
    import torch

    from queasars_tpu_torch.sim import shard_kernels as shk
    from queasars_tpu_torch.sim.sampling import running_sum as plain_scan
    from queasars_tpu_torch.sim.sharded_fold import factor_entries, group_fold_dense
    from queasars_tpu_torch.sim.sharded_statevector import slot_entries

    gen = torch.Generator(device="cpu").manual_seed(31)
    rows, lb = AMP_PRIMITIVES["population"], n - 2
    length = 1 << lb
    state = torch.randn((rows, 2, length), generator=gen).to(DEVICE)
    partner = torch.randn((rows, 2, length), generator=gen).to(DEVICE)
    entries = slot_entries(torch.rand((rows, 3), generator=gen).to(DEVICE) * 6.0)
    ctrl = torch.tensor([-1, 3] * (rows // 2), dtype=torch.int32, device=DEVICE)
    enabled = torch.ones(rows, dtype=torch.bool, device=DEVICE)
    factors = unitary_factors(gen, rows, 14).to(DEVICE)
    group = factor_entries(factors[:, 7:14]).contiguous()
    dense = torch.stack(group_fold_dense(factors, 7, 7), dim=1)  # [rows, 2, 128, 128]
    d_ctrl = torch.tensor([[2, 21, -1]] * rows, dtype=torch.int32, device=DEVICE)
    d_tgt = torch.tensor([[20, 5, 0]] * rows, dtype=torch.int32, device=DEVICE)
    phase = torch.randn((rows, 3, 2, 2), generator=gen).to(DEVICE)
    probs = (state[:, 0] ** 2).contiguous()
    work = state.clone()
    u_c, columns_c = matmul_group_operands(state, dense, lb, 7, 7)
    state_bytes = rows * 2 * length * 4
    cases = {
        "shard_pair_combine": (
            lambda: shk.pair_combine(state, partner, entries, ctrl, enabled, lb, -1, 1), None,
            lambda: shk.pair_combine_plain(state, partner, entries, ctrl, enabled, lb, -1, 1),
            3 * state_bytes, rows * length * 14.0, None),
        "shard_group_product": (
            lambda: shk.group_product(state, group, lb, 7, 7), None,
            lambda: shk.group_product_plain(state, group, lb, 7, 7),
            2 * state_bytes + group.numel() * 4, rows * length * 7 * 14.0,
            lambda: torch.matmul(u_c, columns_c)),
        "shard_diag_phase": (
            lambda: shk.diag_phase(state.clone(), d_ctrl, d_tgt, phase, lb, 2),
            lambda: shk.diag_phase(work, d_ctrl, d_tgt, phase, lb, 2),
            lambda: shk.diag_phase_plain(state, d_ctrl, d_tgt, phase, lb, 2),
            2 * state_bytes, rows * length * 3 * 6.0, None),
        "shard_running_sum": (
            lambda: shk.running_sum(probs, 1024), None,
            lambda: plain_scan(probs.reshape(-1, 1024)).reshape(probs.shape),
            2 * probs.numel() * 4, probs.numel() * 1.0,
            lambda: torch.cumsum(probs.reshape(-1, 1024), dim=-1)),
    }
    library_names = {"shard_group_product": "torch.matmul (complex64, TF32 off, dense Kronecker "
                                            "matrix)",
                     "shard_running_sum": "torch.cumsum"}
    tf32, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    records = {}
    for name, (kernel, timed, plain, moved, flops, library) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        require(equal, f"{name} differs from its plain version by {err:.3e} at n={n}")
        ms = time_ms(timed or kernel, 20)
        plain_ms = time_ms(plain, 2)
        library_ms = None if library is None else time_ms(library, 20)
        records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound": bound(moved, flops), "library_ms": library_ms}
        extra = "" if library_ms is None else f", {library_names[name]} {library_ms:.4f} ms"
        say(f"  {name} ({rows} rows x 2^{lb}): equal bits to its plain version; {ms:.4f} ms "
            f"(plain {plain_ms:.3f} ms{extra}), bound {records[name]['bound'][0]:.4f} ms by "
            f"{records[name]['bound'][1]}")
    for seg_len in (1, 16, 64, 1024, 2048, 4096):
        values = probs[:, :1 << 14].contiguous()
        require(torch.equal(shk.running_sum(values, seg_len),
                            plain_scan(values.reshape(-1, seg_len)).reshape(values.shape)),
                f"shard_running_sum differs from its plain version at seg_len {seg_len}")
    say("  shard_running_sum: equal bits to its plain version at seg_len 1, 16, 64, 1024, 2048 "
        "and 4096")
    whole = torch.randn((rows, 2, 1 << n), generator=gen).to(DEVICE)
    small = torch.randn((rows, 2, 1 << 8), generator=gen).to(DEVICE)
    checked = []
    for width, q0, m in ((lb, 0, 7), (lb, 7, 3), (8, 0, 7), (8, 7, 1), (7, 0, 7), (6, 0, 5),
                         (6, 2, 4), (5, 0, 5), (5, 4, 1)):
        shard = state if width == lb else small[:, :, :1 << width].contiguous()
        short = factor_entries(factors[:, q0:q0 + m]).contiguous()
        require(torch.equal(shk.group_product(shard, short, width, q0, m),
                            shk.group_product_plain(shard, short, width, q0, m)),
                f"shard_group_product differs from its plain version at 2^{width}, q0 {q0}, "
                f"m {m}")
        checked.append(f"({width}, {q0}, {m})")
    say("  shard_group_product: equal bits to its plain version at (local bits, q0, m) "
        + ", ".join(checked))
    gaps = group_product_mesh_gaps(whole, group, dense, n, 7, 7)
    matmul_gap = float((matmul_group_product(state, dense, lb, 7, 7)
                        - shk.group_product(state, group, lb, 7, 7)).abs().max())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(precision)
    for label in ("S2", "torch.matmul"):
        say(f"  {label} on the 1x1 / 1x2 / 1x4 / 2x2 shards of {rows} rows x 2^{n} (q0 7, m 7): "
            f"largest gap from 1x1 " + " / ".join(f"{gaps[(label, k)]:.3e}" for k in AMP_MESHES)
            + (f"; {matmul_gap:.3e} from S2 at 2^{lb}" if label != "S2" else ""))
    require(all(gaps[("S2", k)] == 0.0 for k in AMP_MESHES), "S2 changes with the mesh")
    require(matmul_gap <= 1e-5, f"S2 lies {matmul_gap:.3e} from torch.matmul's dense product")
    return records


def phase_amp_primitives(card, hamiltonian8):
    """Phase 31: energies of P=16 six-layer genomes at n=22 on the 1x1,
    1x2, 1x4 and 2x2 meshes of one card, per route: bit-equal across the
    factorizations, the per-gate route within 1e-5 max|table| of row 1
    unsharded and the fold route of row 6; then every shard kernel against
    its plain version."""
    import numpy as np
    import torch

    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.parallel.amplitude import reset_exchange_bytes
    from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator

    use_route("fold")
    n = hamiltonian8.n_qubits
    cfg = AMP_PRIMITIVES
    population = EVQEPopulation.random_population(n, cfg["layers"], cfg["population"], True,
                                                  random_seed=cfg["seed"])
    packed = PackedPopulation.pack(list(population.individuals), min_layers=cfg["layers"])
    table = None
    for route in ("fold", "per-gate"):
        results = {}
        for label, (n_pop, n_amp) in AMP_MESHES.items():
            evaluator = AmplitudeShardedExpectationEvaluator(
                hamiltonian8, card_amp_mesh(n_pop, n_amp), use_fold=route == "fold")
            if table is None:
                table = evaluator._table.full().to(DEVICE)
            evaluator.evaluate_packed(packed)
            reset_launch_counts()
            reset_exchange_bytes()
            torch.cuda.synchronize()
            start = time.perf_counter()
            results[label] = evaluator.evaluate_packed(packed)
            seconds = time.perf_counter() - start
            say(f"phase amplitude primitives ({route} route, n={n}, P={packed.n_individuals}, "
                f"{cfg['layers']} layers, {label}): {seconds * 1e3:.2f} ms per energies call | "
                f"{card} | launches per row {per_row(launch_counts())} | exchanges "
                f"{exchange_line()}")
        first = results["1x1"]
        for label, got in results.items():
            require(np.array_equal(got, first), f"{route} energies on {label} differ from 1x1 "
                                                f"by {float(np.abs(got - first).max()):.3e}")
        unsharded = row_energies(packed, None, table, n, "fold" if route == "fold" else "slot")
        gap = float(np.abs(unsharded.cpu().numpy() - first).max())
        scale = float(table.abs().max())
        require(gap <= 1e-5 * scale, f"{route} energies are {gap:.3e} from row "
                                     f"{6 if route == 'fold' else 1} (max|table| {scale:.1f})")
        say(f"  check: {route} energies bit-equal on 1x1, 1x2, 1x4 and 2x2; {gap:.3e} from row "
            f"{6 if route == 'fold' else 1} unsharded (bar {1e-5 * scale:.3e})")
    return shard_kernel_records(n)


def config8_solver(mesh, generations, amp_devices=None):
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig

    settings = dict(CONFIG8, generations=generations)
    return baseline_solver(BatchedNFT(NFTConfig(maxiter=CONFIG8["maxiter"])), settings,
                           mesh=mesh, amp_devices=amp_devices)


def phase_config8(card, hamiltonian8, table8):
    """Phase 32: config 8 at full width on four blocks of the card (amp 4,
    shard_amplitudes unset), per route, and on 2 x 2 (generations cut):
    equal trajectories; seconds, evaluations/s, peak memory, launches, the
    eigenvalue and the likeliest bitstring's energy against the
    Hamiltonian's float64 terms."""
    from queasars_tpu_torch.parallel import population_mesh
    from queasars_tpu_torch.parallel.amplitude import reset_exchange_bytes

    four = population_mesh(devices=[f"{DEVICE}:0"] * 4)
    launches = {}
    for route in ("fold", "per-gate"):
        use_shard_route(route)
        reset_memory()
        reset_exchange_bytes()
        result, seconds, counts = timed_solve(config8_solver(four, CONFIG8["generations"]),
                                              hamiltonian8)
        evals = int(sum(result.circuit_evaluations))
        likeliest = max(result.eigenstate, key=result.eigenstate.get)
        energy = host_energy(hamiltonian8, likeliest)
        phase_line(f"config 8 ({hamiltonian8.n_qubits} qubits, {route} route, 1x4, "
                   f"{result.generations} generations, eigenvalue {result.eigenvalue:.6f}, "
                   f"likeliest state {likeliest} at {energy:.6f})", seconds, evals, card, counts)
        say(f"  exchanges {exchange_line()}")
        need = (("shard_pair_combine", "shard_group_product", "shard_diag_phase")
                if route == "fold" else ("population_states", "shard_pair_combine"))
        for kernel in need:
            require(counts[kernel] > 0, f"config 8 ({route}) did not launch {kernel}")
        scale = float(table8.abs().max())
        gap = abs(float(table8[likeliest]) - energy)
        require(gap <= 1e-5 * scale, f"config 8's likeliest state has table energy "
                                     f"{float(table8[likeliest])} against {energy} on the host")
        require(result.eigenvalue >= float(table8.min()) - 1e-5 * scale,
                "config 8's eigenvalue lies below the table's minimum")
        if route == "fold":
            launches = {k: counts[k] for k in SHARD_KERNELS if k != "shard_running_sum"}
        cut = CONFIG8["cut"]
        reset_launch_counts()
        start = time.perf_counter()
        other = config8_solver(four, cut, amp_devices=2).compute_minimum_eigenvalue(hamiltonian8)
        cut_seconds = time.perf_counter() - start
        full = trajectory(result)
        part = trajectory(other)
        require(part["energies"] == full["energies"][:cut],
                f"config 8 ({route}) on 2x2 differs from 1x4")
        say(f"  check: 2x2 ({cut_seconds:.3f} s) gives 1x4's first {cut} generation(s) bit for "
            f"bit; reduced: the 2x2 run's {CONFIG8['generations']} generations cut to {cut}")
    use_shard_route("fold")
    return launches


def config7_solver(mesh):
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import (
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    cfg = CONFIG7
    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=None,
        configured_sampler=ConfiguredSampler(shots=cfg["shots"], seed=cfg["sampler_seed"]),
        optimizer=BatchedNFT(NFTConfig(maxiter=cfg["maxiter"])),
        optimizer_n_circuit_evaluations=None, max_generations=cfg["generations"],
        max_circuit_evaluations=None, termination_criterion=None, random_seed=cfg["seed"],
        population_size=cfg["population"], speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
        parameter_search_probability=0.25, topological_search_probability=0.4,
        layer_removal_probability=0.05, use_tournament_selection=True,
        tournament_size=cfg["tournament_size"], distribution_alpha_tail=cfg["alpha"],
        pack_min_layers=cfg["pack_min_layers"], device=DEVICE, mesh=mesh,
        shard_amplitudes=True,
    ))


def phase_amp_shots(card):
    """Phase 33: config 7 (shots, CVaR) on 2 blocks; exact CVaR bit-equal on
    1, 2, 4 blocks; TFIM-20 grouped shots bit-equal on 2 and 4 blocks;
    TFIM-20 general exact energies against the unsharded term scan."""
    import numpy as np

    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.parallel import population_mesh
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
    from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator

    _, _, hamiltonian7 = jssp_with_qubits(3, 3, CONFIG7["makespan"], CONFIG7["qubits"],
                                          {1: 0.5, 2: 0.5}, rel=1.0)
    reset_memory()
    result, seconds, counts = timed_solve(
        config7_solver(population_mesh(devices=[f"{DEVICE}:0"] * 2)), hamiltonian7)
    evals = int(sum(result.circuit_evaluations))
    phase_line(f"config 7 ({hamiltonian7.n_qubits} qubits, 512 shots, CVaR 0.5, 1x2, fold "
               f"route, {result.generations} generation, eigenvalue {result.eigenvalue:.6f})",
               seconds, evals, card, counts)
    require(counts["shard_running_sum"] > 0, "config 7 did not launch shard_running_sum")
    require(sum(result.eigenstate.values()) > 0.999, "config 7's distribution is empty")
    say("  reduced: config 7's 3 generations cut to 1")
    n = hamiltonian7.n_qubits
    population = EVQEPopulation.random_population(n, 6, 16, True, random_seed=7)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=6)
    cvar = {}
    for blocks in (1, 2, 4):
        evaluator = AmplitudeShardedExpectationEvaluator(hamiltonian7, card_amp_mesh(1, blocks),
                                                         alpha=CONFIG7["alpha"])
        start = time.perf_counter()
        cvar[blocks] = evaluator.evaluate_packed(packed)
        say(f"  exact CVaR 0.5 (n={n}, P=16, 1x{blocks}): "
            f"{time.perf_counter() - start:.3f} s, mean {float(cvar[blocks].mean()):.6f}")
    require(all(np.array_equal(cvar[1], cvar[b]) for b in (2, 4)),
            "exact CVaR differs across 1, 2 and 4 blocks")
    operator = tfim20()
    population = EVQEPopulation.random_population(operator.n_qubits, 4, 16, True,
                                                  random_seed=8)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=4)
    grouped = {}
    for blocks in (2, 4):
        evaluator = AmplitudeShardedExpectationEvaluator(operator, card_amp_mesh(1, blocks),
                                                         shots=512, seed=0)
        start = time.perf_counter()
        grouped[blocks] = evaluator.evaluate_packed(packed)
        say(f"  TFIM-20 grouped shots (512 per group, 1x{blocks}): "
            f"{time.perf_counter() - start:.3f} s")
    require(np.array_equal(grouped[2], grouped[4]), "grouped shots differ on 2 and 4 blocks")
    exact = AmplitudeShardedExpectationEvaluator(operator, card_amp_mesh(1, 4))
    start = time.perf_counter()
    got = exact.evaluate_packed(packed)
    sharded_s = time.perf_counter() - start
    want = StatevectorExpectationEvaluator(operator, device=DEVICE).evaluate_packed(packed)
    gap = float(np.abs(got - want).max())
    require(gap <= 1e-5 * float(np.abs(operator.coeffs).sum()),
            f"general sharded energies are {gap:.3e} from the term scan")
    say(f"  check: exact CVaR bit-equal on 1, 2, 4 blocks; grouped shots bit-equal on 2 and 4; "
        f"general exact energies (1x4, {sharded_s:.3f} s) {gap:.3e} from the unsharded term scan "
        f"| {card}")
    return {"shard_running_sum": counts["shard_running_sum"]}


AMP_MULTIHOST_WORKER = """
import sys
import chip_smoke
sys.exit(chip_smoke.amp_multihost_worker(sys.argv[1], int(sys.argv[2])))
"""


def amp_multihost_work(mesh):
    """Phase 34's two-process work: exact energies and a last-layer NFT
    sweep of config 8's operator over ``mesh`` (JSON-able)."""
    import numpy as np

    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.sim.sharded_evaluator import AmplitudeShardedExpectationEvaluator

    cfg = AMP_MULTIHOST
    _, _, hamiltonian = jssp_with_qubits(3, 3, CONFIG8["makespan"], CONFIG8["qubits"],
                                         {1: 0.5, 2: 0.5})
    n = hamiltonian.n_qubits
    population = EVQEPopulation.random_population(n, cfg["layers"], cfg["population"], True,
                                                  random_seed=cfg["seed"])
    packed = PackedPopulation.pack(list(population.individuals), min_layers=cfg["layers"])
    evaluator = AmplitudeShardedExpectationEvaluator(hamiltonian, mesh)
    start = time.perf_counter()
    energies = evaluator.evaluate_packed(packed)
    energies_s = time.perf_counter() - start
    last = packed.layer_mask.sum(axis=1).astype(np.int64) - 1
    rows = [packed.param_coordinates(i) for i in range(packed.n_individuals)]
    rows = [c[c[:, 0] == last[i]] for i, c in enumerate(rows)]
    width = max(len(c) for c in rows)
    coords = np.stack([np.pad(c, ((0, width - len(c)), (0, 0))) for c in rows])
    n_free = np.asarray([len(c) for c in rows], np.int32)
    start = time.perf_counter()
    angles, swept, _ = BatchedNFT(NFTConfig(maxiter=cfg["maxiter"])).minimize(
        evaluator, packed, coords, n_free, np.ones(len(rows), bool), last_layer=last)
    return {"energies": [float(v) for v in energies], "swept": [float(v) for v in swept],
            "angles": np.asarray(angles).ravel().tolist(), "energies_s": energies_s,
            "sweep_s": time.perf_counter() - start}


def amp_multihost_worker(address: str, rank: int) -> int:
    import torch

    from queasars_tpu_torch.parallel import initialize_multihost
    from queasars_tpu_torch.parallel.amplitude import amplitude_mesh, exchange_bytes

    initialize_multihost(coordinator_address=address, num_processes=2, process_id=rank)
    try:
        out = amp_multihost_work(amplitude_mesh(devices=[f"{DEVICE}:0"]))
        out["sent_mib"] = exchange_bytes["sent"] / 2**20
        print("RESULT" + json.dumps(out), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_amp_qaoa_cli_processes(card, hamiltonian4, hamiltonian8, instance8):
    """Phase 34: sharded QAOA energies and gradients on config 4's table on
    2 and 4 blocks (bit-equal, within tolerance of the unsharded QAOA) and a
    cut sharded QAOA solve; ``--shard-amplitudes`` through the CLI in
    process on config 8 (1 generation) against the in-process 1x4 solve;
    two gloo processes, one shard each on the card, against one process
    with 2 blocks."""
    import os
    import socket

    import numpy as np
    import torch

    from queasars_tpu_torch.__main__ import main as cli_main
    from queasars_tpu_torch.parallel import population_mesh
    from queasars_tpu_torch.parallel.amplitude import amplitude_mesh
    from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table_device, diagonal_terms
    from queasars_tpu_torch.sim.qaoa import qaoa_energies_batch, sharded_qaoa_energies
    from queasars_tpu_torch.sim.sharded_statevector import build_device_table
    from queasars_tpu_torch.solver.qaoa import (
        QAOAConfiguration,
        QAOAMinimumEigensolver,
        start_schedules,
    )
    from queasars_tpu_torch.utils import batch_invariant

    n = hamiltonian4.n_qubits
    cfg = AMP_QAOA
    coeffs, masks = diagonal_terms(hamiltonian4)
    table = diagonal_energy_table_device(hamiltonian4, device=DEVICE)
    scale = torch.clamp(table.abs().max(), min=1e-6)
    gammas, betas, _ = start_schedules(0, cfg["starts"], cfg["reps"], scale)
    params0 = torch.cat([gammas, betas], dim=1)
    runs = {}
    for blocks in (2, 4):
        mesh = card_amp_mesh(1, blocks)
        row = mesh.row(0, n)
        tables = build_device_table(mesh, coeffs, masks, n).of(row)
        leaf = params0.clone().requires_grad_(True)
        start = time.perf_counter()
        with batch_invariant.scope():
            energies = sharded_qaoa_energies(row, tables, leaf[:, :cfg["reps"]],
                                             leaf[:, cfg["reps"]:])
            (grad,) = torch.autograd.grad(energies.sum(), leaf)
        torch.cuda.synchronize()
        runs[blocks] = (energies.detach().cpu().numpy(), grad.cpu().numpy(),
                        time.perf_counter() - start)
    require(np.array_equal(runs[2][0], runs[4][0]) and np.array_equal(runs[2][1], runs[4][1]),
            "sharded QAOA energies or gradients differ on 2 and 4 blocks")
    leaf = params0.clone().requires_grad_(True)
    plain = qaoa_energies_batch(table, leaf[:, :cfg["reps"]], leaf[:, cfg["reps"]:], n)
    (plain_grad,) = torch.autograd.grad(plain.sum(), leaf)
    e_gap = float(np.abs(plain.detach().cpu().numpy() - runs[4][0]).max())
    g_gap = float(np.abs(plain_grad.cpu().numpy() - runs[4][1]).max())
    g_scale = float(np.abs(runs[4][1]).max())
    require(e_gap <= 1e-5 * float(scale), f"sharded QAOA energies {e_gap:.3e} from unsharded")
    require(g_gap <= 1e-4 * g_scale, f"sharded QAOA gradients {g_gap:.3e} from unsharded")
    say(f"phase sharded QAOA (config 4's table, n={n}, {cfg['starts']} starts, p={cfg['reps']}): "
        f"energies + gradient {runs[2][2]:.3f} s on 2 blocks, {runs[4][2]:.3f} s on 4, bit-equal; "
        f"{e_gap:.3e} / {g_gap:.3e} from the unsharded QAOA | {card}")
    reset_memory()
    reset_launch_counts()
    start = time.perf_counter()
    solved = QAOAMinimumEigensolver(QAOAConfiguration(
        n_starts=cfg["starts"], reps=cfg["reps"], maxiter=cfg["maxiter"], device=DEVICE,
        mesh=card_amp_mesh(1, 4))).compute_minimum_eigenvalue(hamiltonian4)
    seconds = time.perf_counter() - start
    require(abs(solved.best_bitstring_energy - host_energy(hamiltonian4, solved.best_bitstring))
            < 1e-9, "QAOA's best bitstring energy is not the Hamiltonian's")
    require(solved.eigenvalue <= max(solved.start_energies) + 1e-6, "QAOA rose")
    phase_line(f"sharded QAOA solve (1x4, Adam maxiter {cfg['maxiter']}, eigenvalue "
               f"{solved.eigenvalue:.6f}, best bitstring {solved.best_bitstring} at "
               f"{solved.best_bitstring_energy:.6f})", seconds, solved.circuit_evaluations,
               card, launch_counts())
    say(f"  reduced: QAOAConfiguration's maxiter 150 cut to {cfg['maxiter']}")

    args = ["solve", "--jssp", instance8, "--makespan-limit", str(CONFIG8["makespan"]),
            "--population", str(CONFIG8["population"]), "--nft-maxiter",
            str(CONFIG8["maxiter"]), "--seed", str(CONFIG8["seed"]), "--generations", "1",
            "--n-devices", "1", "--shard-amplitudes", "--device", DEVICE]
    import contextlib
    import io

    buffer = io.StringIO()
    reset_launch_counts()
    start = time.perf_counter()
    with contextlib.redirect_stdout(buffer):
        require(cli_main(args) == 0, "the --shard-amplitudes CLI run failed")
    cli_s = time.perf_counter() - start
    cli_counts = launch_counts()
    summary = json.loads(buffer.getvalue().strip().splitlines()[-1])
    result, local_s, counts = timed_solve(
        cli_solver(population_mesh(devices=[f"{DEVICE}:0"] * 4), generations=1,
                   shard_amplitudes=True, settings=dict(CLI4, population=CONFIG8["population"],
                                                        nft_maxiter=CONFIG8["maxiter"],
                                                        seed=CONFIG8["seed"])),
        hamiltonian8)
    ours = {"best_per_generation": [g.best_expectation_value
                                    for g in result.population_evaluation_results],
            "eigenvalue": result.eigenvalue, "circuit_evaluations": result.circuit_evaluations}
    for key, value in ours.items():
        require(summary[key] == value, f"the CLI's {key} {summary[key]} differs from the 1x4 "
                                       f"solve's {value}")
    say(f"phase CLI --shard-amplitudes --n-devices 1 (config 8, 1 generation): {cli_s:.3f} s, "
        f"eigenvalue {summary['eigenvalue']:.6f} | {card} | launches per row "
        f"{per_row(cli_counts)}; the 1x4 solve in process {local_s:.3f} s, launches per row "
        f"{per_row(counts)}; equal summaries")

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    start = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", AMP_MULTIHOST_WORKER, f"localhost:{port}",
                               str(rank)], cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=WORKER_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        raise Failure("a process of the two-process amplitude phase timed out")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    seconds = time.perf_counter() - start
    payloads = {}
    for rank, (proc, (out, err)) in enumerate(zip(procs, outputs)):
        require(proc.returncode == 0, f"rank {rank} exited {proc.returncode}: {err[-1500:]}")
        for line in out.splitlines():
            if line.startswith("RESULT"):
                payloads[rank] = json.loads(line[len("RESULT"):])
    require(set(payloads) == {0, 1}, "a rank printed no result")
    local = amp_multihost_work(amplitude_mesh(devices=[f"{DEVICE}:0"] * 2))
    for rank in (0, 1):
        p = payloads[rank]
        for key in ("energies", "swept", "angles"):
            require(p[key] == local[key], f"rank {rank}'s {key} differ from one process")
        say(f"phase two processes, one shard each (gloo, rank {rank}, config 8's operator, "
            f"P={AMP_MULTIHOST['population']}): energies {p['energies_s']:.3f} s, last-layer "
            f"NFT sweep ({AMP_MULTIHOST['maxiter']} steps) {p['sweep_s']:.3f} s, "
            f"{p['sent_mib']:.1f} MiB sent through gloo | {card}")
    say(f"  check: both ranks equal one process with 2 blocks (energies {local['energies_s']:.3f} "
        f"s, sweep {local['sweep_s']:.3f} s) bit for bit ({seconds:.1f} s with both processes' "
        f"start)")


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
        records.update(phase_nft_step(workload))
        say("phase NFT step: the step kernel keeps the PyTorch loop's bits")
        records.update(phase_fold_kernels(workload))
        say("phase fold kernels: all four fold kernels agree with their plain versions "
            "and the slot route")
        records.update(phase_fold_build(workload))
        say("phase fold build: the build kernel agrees with the PyTorch build")
        records.update(phase_sampled_kernels(workload))
        say("phase sampled kernels: both sampled kernels agree with their plain versions "
            "and with each other")
        records.update(phase_grouped_kernels(workload))
        say("phase grouped kernel: the grouped sampler agrees with its plain version and "
            "equals the per-group folded sampler")
        compact_records, launches = phase_compact_kernels(workload)
        records.update(compact_records)
        for route in ROUTE_KERNELS:
            counts = phase_solve(route, seed, encoder, hamiltonian, table)
            launches.update({name: counts[name] for name in ROUTE_KERNELS[route]})
            require(counts["nft_step"] > 0, f"the NFT step kernel did not run on the {route} route")
            if route == "slot":
                launches["nft_step"] = counts["nft_step"]
            else:
                launches["fold_build"] = counts["fold_build"]
        seed3, encoder3, hamiltonian3 = jssp_with_qubits(3, 3, 5, CONFIG3["qubits"], 1)
        for route, route_kernels in SAMPLER_ROUTE_KERNELS.items():
            counts = phase_sampler_solve(route, seed3, encoder3, hamiltonian3)
            launches[route_kernels[0]] = counts[route_kernels[0]]
        for route, route_kernels in TFIM_ROUTE_KERNELS.items():
            counts = phase_tfim_solve(route)
            if route == "fold":
                launches[route_kernels[0]] = counts[route_kernels[0]]
        phase_config2(card)
        phase_config5(card)
        spsa = [phase_spsa_solve(route, card, hamiltonian, table) for route in ("slot", "fold")]
        phase_spsa_checkers(card, hamiltonian)
        phase_cobyla(card)
        phase_spsa_routes_agree(spsa, hamiltonian, table)
        phase_gradient_solve(card, hamiltonian, table)
        phase_gradient_minimize(card, hamiltonian, table)
        phase_qaoa(card, hamiltonian)
        from queasars_tpu_torch.problems.spin_chains import transverse_field_ising

        tfim12 = transverse_field_ising(CONFIG2["qubits"], **TFIM)
        phase_adapt(card, "(a) config 2's TFIM-12", tfim12, ADAPT_TFIM,
                    float(abs(tfim12.coeffs).sum()))
        phase_adapt(card, "(b) config 4's JSSP-20", hamiltonian, ADAPT_JSSP,
                    float(table.abs().max()))
        phase_qneat(card, hamiltonian, table)
        instance_path = write_instance(encoder, f"{work_dir('cli')}/instance.json")
        for route in ("fold", "slot"):
            phase_cli_resume(card, route, instance_path, encoder.makespan_limit)
        phase_cli_subprocess(card, instance_path, encoder.makespan_limit)
        phase_cli_sampler_and_qneat(card, encoder3, encoder)
        phase_external(card, hamiltonian, table)
        phase_function_value(card, hamiltonian3)
        phase_profiling(card, hamiltonian)
        phase_mesh_primitives(card, workload)
        phase_mesh_solves(card, hamiltonian, hamiltonian3)
        phase_multihost(card, hamiltonian)
        phase_mesh_adapt_and_cli(card, hamiltonian, instance_path, encoder.makespan_limit)
        _, encoder8, hamiltonian8 = jssp_with_qubits(3, 3, CONFIG8["makespan"],
                                                     CONFIG8["qubits"], {1: 0.5, 2: 0.5})
        require(hamiltonian8.n_qubits == CONFIG8["qubits"], "the instance is not 22 qubits")
        table8 = diagonal_energy_table(hamiltonian8, dtype=torch.float32, device=DEVICE)
        records.update(phase_amp_primitives(card, hamiltonian8))
        launches.update(phase_config8(card, hamiltonian8, table8))
        launches.update(phase_amp_shots(card))
        instance8 = write_instance(encoder8, f"{work_dir('cli')}/instance8.json")
        phase_amp_qaoa_cli_processes(card, hamiltonian, hamiltonian8, instance8)
    except Failure as failure:
        say(f"FAILED: {failure}")
        return 1

    kernels = [
        {
            "name": k, "route": "cuda", "source": {**KERNELS, **SHARD_KERNELS}[k][0],
            "replaces": {**KERNELS, **SHARD_KERNELS}[k][1],
            "launches": launches[k], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
            "bound_by": rec["bound"][1], "library_ms": rec.get("library_ms"),
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
