"""Command-line solve runner: ``python -m queasars_tpu_torch solve ...``.

Counterpart of ``queasars_tpu/__main__.py`` with its flags and summary
line, except two: ``--device`` replaces ``--platform`` (the card by
default, ``cpu`` for the kernels' plain versions), and there is no
``--use-pallas``, because on the card the port always runs its CUDA
kernels.  ``--n-devices N`` splits an EVQE solve's population over
``population_mesh(N)`` (with ``--device cpu``, over N CPU blocks), and
``--shard-amplitudes`` splits each state over that mesh's amplitude axis
(``sim/sharded_evaluator.py``), as in the reference.

Load a JSSP instance (JSON, the wire-compatible codec) or a QUBO (.npy
matrix / JSON), run EVQE or QNEAT with checkpointing, and write the full
result JSON.  Crash/preemption recovery: re-run the same command with
``--resume`` and the solve continues its exact trajectory from the
checkpoint.

Examples::

    python -m queasars_tpu_torch solve --jssp instance.json --makespan-limit 5 \\
        --generations 10 --population 16 --output result.json \\
        --checkpoint state.json
    python -m queasars_tpu_torch solve --jssp instance.json --makespan-limit 5 \\
        --generations 20 --checkpoint state.json --resume
    python -m queasars_tpu_torch solve --qubo matrix.npy --generations 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="queasars_tpu_torch",
        description="Solves run on the CUDA card with the port's kernels (there is no "
        "--use-pallas switch); --device cpu runs the kernels' plain PyTorch versions.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    solve = sub.add_parser("solve", help="run an EVQE or QNEAT solve")
    source = solve.add_mutually_exclusive_group(required=True)
    source.add_argument("--jssp", help="JSSP problem instance JSON file")
    source.add_argument("--qubo", help="QUBO matrix (.npy) or JSON {quadratic, linear, constant}")
    solve.add_argument("--makespan-limit", type=int, default=None, help="JSSP makespan horizon")
    solve.add_argument("--generations", type=int, default=10)
    solve.add_argument("--population", type=int, default=16)
    solve.add_argument("--seed", type=int, default=0)
    solve.add_argument("--shots", type=int, default=2048)
    solve.add_argument("--nft-maxiter", type=int, default=40)
    solve.add_argument("--alpha-tail", type=float, default=1.0, help="CVaR alpha (sampler path)")
    solve.add_argument("--sampler", action="store_true", help="shot-based evaluation path")
    solve.add_argument(
        "--algorithm", choices=("evqe", "qneat"), default="evqe",
        help="evolutionary algorithm (default evqe; qneat = speciated gate-genome evolution)",
    )
    solve.add_argument("--pack-min-layers", type=int, default=None)
    solve.add_argument(
        "--n-devices", type=int, default=None,
        help="population-mesh width (EVQE only; with --device cpu, that many CPU blocks)",
    )
    solve.add_argument(
        "--shard-amplitudes", action="store_true",
        help="amplitude sharding (split each state over the --n-devices mesh)",
    )
    solve.add_argument("--checkpoint", default=None, help="solver-state checkpoint path")
    solve.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    solve.add_argument("--output", default=None, help="result JSON path (default: stdout summary)")
    solve.add_argument(
        "--device", default=None,
        help="torch device of the solve (default: the CUDA card; 'cpu' runs the kernels' "
        "plain versions)",
    )
    return parser


def _load_hamiltonian(args):
    if args.jssp:
        from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
        from queasars_tpu_torch.problems.jssp.serialization import JSSPJSONDecoder

        if args.makespan_limit is None:
            raise SystemExit("--makespan-limit is required with --jssp")
        with open(args.jssp) as fh:
            instance = json.load(fh, cls=JSSPJSONDecoder)
        encoder = JSSPDomainWallHamiltonianEncoder(instance, makespan_limit=args.makespan_limit)
        hamiltonian = encoder.get_problem_hamiltonian()

        def describe(state: int) -> dict:
            bitstring = format(state, f"0{encoder.n_qubits}b")
            schedule = encoder.translate_result_bitstring(bitstring)
            return {
                "bitstring": bitstring,
                "valid_schedule": bool(schedule.is_valid),
                "makespan": schedule.makespan if schedule.is_valid else None,
            }

        return hamiltonian, describe
    import numpy as np

    from queasars_tpu_torch.problems.qubo import decode_qubo_bits, qubo_hamiltonian

    if args.qubo.endswith(".npy"):
        quadratic = np.load(args.qubo)
        linear, constant = None, 0.0
    else:
        with open(args.qubo) as fh:
            payload = json.load(fh)
        quadratic = np.asarray(payload["quadratic"], dtype=float)
        linear = np.asarray(payload["linear"], dtype=float) if "linear" in payload else None
        constant = float(payload.get("constant", 0.0))
    hamiltonian, offset = qubo_hamiltonian(quadratic, linear, constant)

    def describe(state: int) -> dict:
        return {
            "bits": decode_qubo_bits(state, hamiltonian.n_qubits),
            "objective_offset": offset,
        }

    return hamiltonian, describe


def _solve(args) -> int:
    from queasars_tpu_torch.optim import BatchedNFT, NFTConfig
    from queasars_tpu_torch.solver import (
        ConfiguredEstimator,
        ConfiguredSampler,
        EVQEMinimumEigensolver,
        EVQEMinimumEigensolverConfiguration,
    )

    if args.resume and not args.checkpoint:
        raise SystemExit("--resume requires --checkpoint")
    if args.algorithm == "qneat" and (args.shard_amplitudes or args.n_devices):
        raise SystemExit("mesh options are EVQE-only in the CLI for now")
    hamiltonian, describe = _load_hamiltonian(args)
    if args.algorithm == "qneat":
        from queasars_tpu_torch.solver import (
            QNEATMinimumEigensolver,
            QNEATMinimumEigensolverConfiguration,
        )

        qneat_configuration = QNEATMinimumEigensolverConfiguration(
            configured_estimator=None if args.sampler else ConfiguredEstimator(),
            configured_sampler=ConfiguredSampler(shots=args.shots, seed=args.seed),
            max_generations=args.generations,
            max_circuit_evaluations=None,
            termination_criterion=None,
            random_seed=args.seed,
            population_size=args.population,
            optimizer=BatchedNFT(NFTConfig(maxiter=args.nft_maxiter)),
            distribution_alpha_tail=args.alpha_tail,
            pack_min_layers=args.pack_min_layers,
            checkpoint_path=args.checkpoint,
            resume_from_checkpoint=args.checkpoint if args.resume else None,
            device=args.device,
        )
        solver = QNEATMinimumEigensolver(qneat_configuration)
        return _report(solver.compute_minimum_eigenvalue(hamiltonian), describe, args)
    configuration = EVQEMinimumEigensolverConfiguration(
        configured_estimator=None if args.sampler else ConfiguredEstimator(),
        configured_sampler=ConfiguredSampler(shots=args.shots, seed=args.seed),
        optimizer=BatchedNFT(NFTConfig(maxiter=args.nft_maxiter)),
        optimizer_n_circuit_evaluations=None,
        max_generations=args.generations,
        max_circuit_evaluations=None,
        termination_criterion=None,
        random_seed=args.seed,
        population_size=args.population,
        speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1,
        selection_beta_penalty=0.05,
        parameter_search_probability=0.4,
        topological_search_probability=0.5,
        layer_removal_probability=0.1,
        use_tournament_selection=True,
        tournament_size=2,
        distribution_alpha_tail=args.alpha_tail,
        pack_min_layers=args.pack_min_layers,
        n_devices=args.n_devices,
        shard_amplitudes=True if args.shard_amplitudes else None,
        checkpoint_path=args.checkpoint,
        resume_from_checkpoint=args.checkpoint if args.resume else None,
        device=args.device,
    )
    result = EVQEMinimumEigensolver(configuration).compute_minimum_eigenvalue(hamiltonian)
    return _report(result, describe, args)


def _report(result, describe, args) -> int:
    likeliest = max(result.eigenstate.items(), key=lambda kv: kv[1])[0]
    summary = {
        "eigenvalue": result.eigenvalue,
        "generations": result.generations,
        "circuit_evaluations": result.circuit_evaluations,
        "best_per_generation": [
            gen.best_expectation_value for gen in result.population_evaluation_results
        ],
        "likeliest_state": likeliest,
        "decoded": describe(likeliest),
    }
    if args.output:
        from queasars_tpu_torch.solver.serialization import (
            EvolvingAnsatzMinimumEigensolverResultJSONEncoder,
        )

        with open(args.output, "w") as fh:
            json.dump(result, fh, cls=EvolvingAnsatzMinimumEigensolverResultJSONEncoder)
        summary["result_file"] = args.output
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "solve":
        return _solve(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
