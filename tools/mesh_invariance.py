#!/usr/bin/env python3
"""The population mesh's contract beyond ``chip_smoke.py``'s phases 27-30,
on one CUDA card: seeded solves whose energies pass through plain torch
reductions (the term scan, grouped shot means, autograd, the five-point
fit) on ``population_mesh()`` and on four blocks of the first card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/mesh_invariance.py
    python3 tools/mesh_invariance.py --without-scope   # the repair off

First the plain reductions alone at n=20 (16 rows against blocks of 1, 2,
4 and 8 rows: ``torch.sum``, ``torch.cumsum`` and
``utils/batch_invariant.row_sum``), then each case's two mesh solves with
their seconds, evaluations/s and launches per kernel row, and whether their
trajectories are equal (else the first differing generation and its largest
energy difference).  ``--without-scope`` runs the blocks outside
``batch_invariant.scope`` (plain torch reductions everywhere), the state the
repair of the card's row reductions replaced.  A JSON summary is the last
line.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reductions() -> dict:
    """Equal bits of each reduction of 16 rows of 2^20 values computed
    whole and in blocks of 1, 2, 4 and 8 rows."""
    import torch

    from queasars_tpu_torch.utils import batch_invariant

    x = torch.rand((16, 1 << 20), device="cuda", generator=torch.Generator("cuda").manual_seed(0))

    def row_sum(t):
        with batch_invariant.scope():
            return batch_invariant.row_sum(t)

    out = {}
    for name, fn in (("torch.sum", lambda t: t.sum(-1)), ("torch.cumsum", lambda t: t.cumsum(-1)),
                     ("row_sum", row_sum)):
        whole = fn(x)
        out[name] = {
            width: bool(torch.equal(whole, torch.cat([fn(x[i:i + width])
                                                      for i in range(0, 16, width)])))
            for width in (1, 2, 4, 8)
        }
    return out


def cases(cs):
    """(name, route, solver factory of a mesh, operator)."""
    from queasars_tpu_torch.optim import (
        BatchedGradientDescent,
        BatchedNFT,
        BatchedSPSA,
        GradientDescentConfig,
        NFTConfig,
        SPSAConfig,
    )
    from queasars_tpu_torch.problems.spin_chains import heisenberg_chain, transverse_field_ising
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
        QNEATMinimumEigensolver,
        QNEATMinimumEigensolverConfiguration,
    )

    _, _, jssp20 = cs.jssp_with_qubits(3, 3, 6, cs.N_QUBITS, {1: 0.5, 2: 0.5})
    _, _, jssp18 = cs.jssp_with_qubits(3, 3, 5, cs.CONFIG3["qubits"], 1)
    two = dict(cs.SOLVE, generations=2)

    def sampler_solver(mesh, optimizer, population, generations):
        return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
            configured_estimator=None, configured_sampler=ConfiguredSampler(shots=512, seed=0),
            optimizer=optimizer, optimizer_n_circuit_evaluations=None,
            max_generations=generations, max_circuit_evaluations=None, termination_criterion=None,
            random_seed=0, population_size=population, speciation_genetic_distance_threshold=2,
            selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
            parameter_search_probability=0.25, topological_search_probability=0.4,
            layer_removal_probability=0.05, use_tournament_selection=True, tournament_size=2,
            pack_min_layers=6, device=cs.DEVICE, mesh=mesh))

    return [
        ("config 2 (TFIM-12, exact, five-point NFT, 2 of 3 generations)", "fold",
         lambda m: cs.baseline_solver(
             BatchedNFT(NFTConfig(maxiter=cs.CONFIG2["maxiter"], five_point=True)),
             dict(cs.CONFIG2, generations=2), mesh=m),
         transverse_field_ising(cs.CONFIG2["qubits"], **cs.TFIM)),
        ("config 5 (MoG-VQE, Heisenberg-6)", "fold",
         lambda m: cs.baseline_solver(
             BatchedNFT(NFTConfig(maxiter=cs.CONFIG5["maxiter"], five_point=True)), cs.CONFIG5,
             penalty=0.0, mog=True, mesh=m),
         heisenberg_chain(cs.CONFIG5["qubits"])),
        ("SPSA on config 4 (2 of 4 generations)", "slot",
         lambda m: cs.baseline_solver(BatchedSPSA(SPSAConfig(maxiter=30, calibration_steps=10)),
                                      two, mesh=m), jssp20),
        ("gradient on config 4 (2 of 4 generations)", "fold",
         lambda m: cs.baseline_solver(
             BatchedGradientDescent(GradientDescentConfig(maxiter=10, learning_rate=0.1)), two,
             mesh=m), jssp20),
        ("QNEAT on config 4 (NFT polish, 2 generations)", "fold",
         lambda m: QNEATMinimumEigensolver(QNEATMinimumEigensolverConfiguration(
             configured_estimator=ConfiguredEstimator(), configured_sampler=None,
             max_generations=2, max_circuit_evaluations=None, termination_criterion=None,
             random_seed=0, population_size=16, optimizer=BatchedNFT(NFTConfig(maxiter=10)),
             device=cs.DEVICE, mesh=m)), jssp20),
        ("config 3's instance, 512-shot mean (alpha 1, 2 generations)", "fold",
         lambda m: sampler_solver(m, BatchedNFT(NFTConfig(maxiter=30)), 16, 2), jssp18),
        ("TFIM-20, grouped shots (five-point NFT maxiter 10, 1 generation)", "fold",
         lambda m: sampler_solver(m, BatchedNFT(NFTConfig(maxiter=10, five_point=True)), 20, 1),
         cs.tfim20()),
    ]


def compare(cs, card, name, route, make, operator) -> dict:
    cs.use_route(route)
    runs, seconds = {}, {}
    for label, mesh in cs.card_meshes().items():
        result, seconds[label], launches = cs.timed_solve(make(mesh), operator)
        cs.solve_line(f"{name} ({route} route, {label})", result, seconds[label], card, launches)
        runs[label] = cs.trajectory(result)
    one, four = runs.values()
    record = {"case": name, "route": route, "equal": one == four, "seconds": seconds}
    for generation, (a, b) in enumerate(zip(one["energies"], four["energies"])):
        if a != b:
            record["first_differing_generation"] = generation
            record["max_difference"] = max(abs(u - v) for u, v in zip(a, b)
                                           if u is not None and v is not None)
            break
    cs.say(f"  {'equal' if record['equal'] else 'DIFFERENT'} trajectories: {record}")
    return record


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--without-scope", action="store_true",
                        help="run the mesh's blocks outside batch_invariant.scope")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_invariance: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from queasars_tpu_torch.utils import batch_invariant

    card, _ = cs.phase_device()
    cs.phase_build()
    found = reductions()
    cs.say(f"reductions of 16 rows at n=20, equal bits in blocks of 1/2/4/8 rows: {found}")
    if args.without_scope:
        batch_invariant.scope = contextlib.nullcontext
    records = [compare(cs, card, *case) for case in cases(cs)]
    print(card, flush=True)
    print(json.dumps({"without_scope": args.without_scope, "reductions": found,
                      "cases": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
