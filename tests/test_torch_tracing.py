"""The port's span recorder (``utils/profiling.py``) on the CPU.

Off, :func:`span` records nothing; on, spans nest per thread with their
parents and request ids; an 8-qubit EVQE solve records the spans of its
layers (one ``nft.step`` per NFT step the searches ran, one ``operator.*``
per ``apply_operator``, the launch counts per solve) and gives the same
bits with recording on as off.  The kron-fold route's spans (``fold.build``
per pipeline built, ``wait.fold_sweep_metadata`` per folded sweep) and the
counts kept at each solve's start are read on the CPU with the route forced
(``fold_kernels.fold_supported`` patched).  Tests marked ``cuda`` run on a
card: ``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda``.
"""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import pytest
import torch

from queasars_tpu_torch.genome import PackedPopulation
from queasars_tpu_torch.optim import BatchedNFT, NFTConfig, nft
from queasars_tpu_torch.problems.jssp import JSSPDomainWallHamiltonianEncoder
from queasars_tpu_torch.problems.jssp.random_instances import random_job_shop_scheduling_instance
from queasars_tpu_torch.optim import sweep_kernel_launch
from queasars_tpu_torch.sim import fold_kernels, fold_pipeline, slot_kernels
from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator
from queasars_tpu_torch.solver import (
    ConfiguredEstimator,
    EVQEMinimumEigensolver,
    EVQEMinimumEigensolverConfiguration,
)
from queasars_tpu_torch.utils import profiling
from queasars_tpu_torch.utils.profiling import recording, span

MAXITER = 3


def _solver(seed=5):
    return EVQEMinimumEigensolver(EVQEMinimumEigensolverConfiguration(
        configured_estimator=ConfiguredEstimator(), configured_sampler=None,
        optimizer=BatchedNFT(NFTConfig(maxiter=MAXITER)), optimizer_n_circuit_evaluations=None,
        max_generations=2, max_circuit_evaluations=None, termination_criterion=None,
        random_seed=seed, population_size=6, speciation_genetic_distance_threshold=2,
        selection_alpha_penalty=0.1, selection_beta_penalty=0.1,
        parameter_search_probability=0.5, topological_search_probability=0.5,
        layer_removal_probability=0.2, pack_min_layers=4, device="cpu",
    ))


def _hamiltonian():
    instance = random_job_shop_scheduling_instance(
        "t8", n_jobs=2, n_machines=2, relative_op_amount=0.5, op_duration={1: 0.5, 2: 0.5},
        random_seed=4,
    )
    return JSSPDomainWallHamiltonianEncoder(instance, makespan_limit=5).get_problem_hamiltonian()


def _by_name(recorded):
    return Counter(s[0] for s in recorded.spans)


def test_nothing_is_recorded_with_recording_off():
    assert profiling._active is None
    with span("solve", entries=3) as region:
        region.set(entries=4)
    assert span("a") is span("b")
    with recording() as recorded:
        pass
    with span("nft.step"):
        pass
    assert recorded.spans == [] and recorded.launches == {}
    assert profiling._active is None


def test_spans_nest_with_parents_and_request_ids_per_thread():
    ready, go = threading.Barrier(2, timeout=10), threading.Event()

    def worker():
        with span("solve"):
            ready.wait()
            with span("nft.step"):
                go.wait(10)

    with recording() as recorded:
        with span("encode"):
            pass
        thread = threading.Thread(target=worker)
        thread.start()
        with span("solve"):
            with span("operator.X"):
                ready.wait()
                with span("evaluator.evaluate_packed"):
                    go.set()
                    with span("wait.evaluate_packed"):
                        pass
        with span("evaluator.evaluate_packed"):
            with span("evaluator.population_energies"):
                pass
        thread.join(10)
    assert not thread.is_alive()
    spans = recorded.spans
    index = {}
    for i, (name, start, end, parent, request, attrs) in enumerate(spans):
        assert end is not None and end >= start and attrs == {}
        index.setdefault(name, []).append(i)

    def parent_name(i):
        return spans[spans[i][3]][0] if spans[i][3] >= 0 else None

    encode, = index["encode"]
    assert spans[encode][3:5] == (-1, -1)
    solves = index["solve"]
    assert [spans[i][3] for i in solves] == [-1, -1]
    assert [spans[i][4] for i in solves] == solves
    step, = index["nft.step"]
    main, = [i for i in solves if i != spans[step][3]]
    assert parent_name(step) == "solve" and spans[step][4] == spans[step][3]
    inner, outer = index["evaluator.evaluate_packed"]
    assert parent_name(inner) == "operator.X" and spans[inner][4] == main
    wait, = index["wait.evaluate_packed"]
    assert spans[wait][3] == inner and spans[wait][4] == main
    assert spans[outer][3] == -1 and spans[outer][4] == outer
    energies, = index["evaluator.population_energies"]
    assert spans[energies][3] == outer and spans[energies][4] == outer
    assert sorted(recorded.launches) == solves


def test_self_times_durations_and_innermost_on_hand_made_spans():
    recorded = profiling.Recording()
    ms = 1_000_000
    recorded.spans = [
        ("operator.P", 0, 100 * ms, -1, -1, {}),
        ("nft.step", 10 * ms, 50 * ms, 0, -1, {}),
        ("evaluator.population_energies", 12 * ms, 20 * ms, 1, -1, {}),
        ("evaluator.population_probs", 13 * ms, 18 * ms, 2, -1, {}),
        ("wait.a", 14 * ms, 16 * ms, 3, -1, {}),
        ("wait.b", 30 * ms, 35 * ms, 1, -1, {}),
        ("wait.c", 31 * ms, 32 * ms, 5, -1, {}),
        ("nft.step", 60 * ms, 70 * ms, 0, -1, {}),
        ("nft.step", 80 * ms, None, 0, -1, {}),
    ]
    summary = recorded.summary()
    assert summary["nft.step"]["count"] == 2
    assert summary["nft.step"]["total_s"] == pytest.approx(0.050)
    assert summary["nft.step"]["self_s"] == pytest.approx(0.050 - 0.008 - 0.005)
    assert summary["operator.P"]["self_s"] == pytest.approx(0.100 - 0.040 - 0.010)
    assert summary["wait.b"]["self_s"] == pytest.approx(0.004)
    steps = recorded.durations("nft.step", minus=("evaluator.", "wait."))
    assert steps == pytest.approx([0.027, 0.010])
    entries = recorded.durations(("evaluator.population_energies", "evaluator.population_probs"),
                                 minus="wait.")
    assert entries == pytest.approx([0.006])
    assert recorded.durations("wait.") == pytest.approx([0.002, 0.005])
    times = [5 * ms, 15 * ms, 31500 * 1000, 55 * ms, 65 * ms, 150 * ms, 90 * ms]
    assert recorded.innermost(times) == [
        "operator.P", "wait.a", "wait.c", "operator.P", "nft.step", None, "operator.P"]


def _run(monkeypatch, record):
    runs = []
    original = nft._nft_steps

    def counted(*args, **kwargs):
        runs.append(args[5])
        return original(*args, **kwargs)

    monkeypatch.setattr(nft, "_nft_steps", counted)
    solver = _solver()
    applied = Counter()
    for op in solver.configuration.evolutionary_operators:
        apply = op.apply_operator

        def applying(population, operator_context, apply=apply, name=type(op).__name__):
            applied[name] += 1
            return apply(population=population, operator_context=operator_context)

        op.apply_operator = applying
    hamiltonian = _hamiltonian()
    if not record:
        return solver.compute_minimum_eigenvalue(hamiltonian), runs, applied, None
    with recording() as recorded:
        result = solver.compute_minimum_eigenvalue(hamiltonian)
    return result, runs, applied, recorded


def test_a_cpu_solve_records_its_layers(monkeypatch):
    monkeypatch.setenv("QUEASARS_MXU", "0")
    result, runs, applied, recorded = _run(monkeypatch, record=True)
    names = _by_name(recorded)
    assert result.eigenstate
    assert runs and names["nft.step"] == sum(runs)
    assert {f"operator.{k}": v for k, v in applied.items()} == {
        k: v for k, v in names.items() if k.startswith("operator.")}
    for name in ("solve", "evaluator.build", "eigenstate", "wait.eigenstate",
                 "evaluator.population_energies", "evaluator.population_probs",
                 "evaluator.simulate_prefix_states", "evaluator.nft_layer_sweep_launch",
                 "wait.nft_minimize", "wait.nft_minimize_slots"):
        assert names[name] >= 1, name
    assert names["solve"] == names["evaluator.build"] == names["eigenstate"] == 1
    solve, = [i for i, s in enumerate(recorded.spans) if s[0] == "solve"]
    assert all(s[4] == solve for s in recorded.spans)
    eigenstate, = [s for s in recorded.spans if s[0] == "eigenstate"]
    assert eigenstate[5] == {"entries": len(result.eigenstate)}
    parents = {recorded.spans[s[3]][0] for s in recorded.spans if s[0] == "nft.step"}
    assert parents == {"operator.EVQEParameterSearch"}
    assert all(s[2] is not None for s in recorded.spans)

    evaluator = StatevectorExpectationEvaluator(_hamiltonian(), device="cpu")
    packed = PackedPopulation.pack(list(result.population_evaluation_results[-1]
                                        .population.individuals))
    with recording() as direct:
        evaluator.evaluate_packed(packed)
    assert [(s[0], s[3], s[4]) for s in direct.spans] == [
        ("evaluator.evaluate_packed", -1, 0), ("evaluator.population_energies", 0, 0),
        ("wait.evaluate_packed", 0, 0)]


def test_recording_changes_no_result(monkeypatch):
    monkeypatch.setenv("QUEASARS_MXU", "0")
    off, *_ = _run(monkeypatch, record=False)
    on, *_ = _run(monkeypatch, record=True)
    assert off.eigenvalue == on.eigenvalue
    assert off.circuit_evaluations == on.circuit_evaluations
    assert off.eigenstate == on.eigenstate
    assert off.best_individual.parameter_values == on.best_individual.parameter_values
    for a, b in zip(off.population_evaluation_results, on.population_evaluation_results, strict=True):
        assert np.array_equal(np.asarray(a.expectation_values, dtype=float),
                              np.asarray(b.expectation_values, dtype=float))
        assert [i.parameter_values for i in a.population.individuals] == [
            i.parameter_values for i in b.population.individuals]


def test_launch_counts_are_read_per_solve(monkeypatch):
    monkeypatch.setattr(slot_kernels, "launch_counts", dict(slot_kernels.launch_counts))
    with recording() as recorded:
        with span("solve"):
            slot_kernels.launch_counts["energies_exact"] += 3
            with span("solve"):
                slot_kernels.launch_counts["population_probs"] += 1
        with span("evaluator.evaluate_packed"):
            slot_kernels.launch_counts["energies_exact"] += 5
        with span("solve"):
            pass
    outer, inner, last = sorted(recorded.launches)
    assert recorded.launches[outer]["slot_kernels.energies_exact"] == 3
    assert recorded.launches[outer]["slot_kernels.population_probs"] == 1
    assert recorded.launches[inner]["slot_kernels.energies_exact"] == 0
    assert recorded.launches[inner]["slot_kernels.population_probs"] == 1
    assert set(recorded.launches[last].values()) == {0}
    assert set(recorded.launches[last]) >= {f"slot_kernels.{row}"
                                            for row in slot_kernels.launch_counts}


@pytest.fixture
def fold_route(monkeypatch):
    monkeypatch.delenv("QUEASARS_MXU", raising=False)
    monkeypatch.setattr(
        fold_kernels, "fold_supported",
        lambda n, device, path="exact": fold_pipeline.LANE_BITS <= n <= fold_kernels._CAPS[path])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _genome(n=8, pop=3, layers=3, seed=3, device="cpu"):
    from queasars_tpu_torch.genome import EVQEPopulation
    from queasars_tpu_torch.sim.evaluators import packed_tensors

    population = EVQEPopulation.random_population(n, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=layers + 1)
    return packed_tensors(packed, device=device)


def test_each_fold_pipeline_build_is_one_span_and_is_counted_recording_or_not(monkeypatch):
    monkeypatch.setattr(fold_pipeline, "build_counts", {"builds": 0, "host_ns": 0})
    genome = _genome()
    fold_pipeline.build_fold_pipeline(*genome, 8, absorb_diag=True)
    assert fold_pipeline.build_counts["builds"] == 1
    with recording() as recorded:
        for absorb in (False, True, True):
            fold_pipeline.build_fold_pipeline(*genome, 8, absorb_diag=absorb)
    assert _by_name(recorded) == {"fold.build": 3}
    assert fold_pipeline.build_counts["builds"] == 4
    assert fold_pipeline.build_counts["host_ns"] > 0


def _sweep_arguments(genome, n=8, device="cpu"):
    gate_types, controls, angles, layer_mask = genome
    pop = gate_types.shape[0]
    last = layer_mask.sum(dim=1) - 1
    rows = torch.arange(pop, device=device)
    layer = gate_types[rows, last]
    coords = torch.stack([torch.arange(n, device=device).repeat(pop, 1),
                          torch.zeros(pop, n, dtype=torch.long, device=device)], dim=-1)
    n_free = torch.full((pop,), n, dtype=torch.int32, device=device)
    active = (layer != 0).any(dim=1)
    table = torch.linspace(-2.0, 3.0, 1 << n, device=device)
    return ((gate_types, controls, angles, layer_mask, last, coords.to(torch.int32), n_free,
             active, table),
            dict(n_qubits=n, maxiter=6, reset_interval=3,
                 initial_state=None))


def test_a_folded_sweep_opens_one_metadata_wait_under_the_sweep_entry_point(
        monkeypatch, fold_route):
    args, kwargs = _sweep_arguments(_genome())
    with recording() as recorded:
        folded = sweep_kernel_launch.nft_layer_sweep_launch(*args, **kwargs)
    names = [s[0] for s in recorded.spans]
    assert names.count("evaluator.nft_layer_sweep_launch") == 1
    assert names.count("wait.fold_sweep_metadata") == 1
    assert names.count("fold.build") >= 1
    direct = sweep_kernel_launch.nft_layer_sweep_folded_launch(*args, **kwargs)
    monkeypatch.setenv("QUEASARS_MXU", "0")
    with recording() as recorded:
        slot = sweep_kernel_launch.nft_layer_sweep_launch(*args, **kwargs)
    assert "wait.fold_sweep_metadata" not in {s[0] for s in recorded.spans}
    for a, b in zip(folded, direct, strict=True):
        assert torch.equal(a, b)
    assert torch.allclose(folded[1], slot[1], atol=1e-5)


def test_each_solve_keeps_the_counts_at_its_start(monkeypatch, fold_route):
    monkeypatch.setattr(profiling, "solve_starts", profiling.collections.deque(maxlen=4))
    assert profiling.counts_since(1) is None
    builds = []
    for seed in (5, 6):
        before = fold_pipeline.build_counts["builds"]
        _solver(seed).compute_minimum_eigenvalue(_hamiltonian())
        builds.append(fold_pipeline.build_counts["builds"] - before)
    assert len(profiling.solve_starts) == 2 and min(builds) > 0
    assert profiling.counts_since(1)["fold_pipeline.builds"] == builds[1]
    assert profiling.counts_since(2)["fold_pipeline.builds"] == sum(builds)
    assert profiling.counts_since(3) is None
    assert {row for row in profiling.counts_since(2) if row.startswith("fold_kernels.")} == {
        f"fold_kernels.{row}" for row in fold_kernels.launch_counts}


@pytest.mark.cuda
def test_a_folded_sweep_on_the_card_opens_one_metadata_wait(cuda_device, monkeypatch):
    monkeypatch.delenv("QUEASARS_MXU", raising=False)
    n = 14
    args, kwargs = _sweep_arguments(_genome(n=n, device=cuda_device), n=n, device=cuda_device)
    before = fold_kernels.launch_counts["nft_layer_sweep_folded"]
    with recording() as recorded:
        sweep_kernel_launch.nft_layer_sweep_launch(*args, **kwargs)
    names = Counter(s[0] for s in recorded.spans)
    assert names["wait.fold_sweep_metadata"] == 1
    assert names["evaluator.nft_layer_sweep_launch"] == 1
    assert fold_kernels.launch_counts["nft_layer_sweep_folded"] == before + 1


@pytest.mark.cuda
def test_a_default_route_config_four_solve_launches_fold_kernels_within_the_limits(
        cuda_device, monkeypatch):
    from benchmark import check, program, workload

    monkeypatch.delenv("QUEASARS_MXU", raising=False)
    config = workload.load("configs", "jssp20-exact-fold")
    family = config["instance"]
    instance_seed, instance = workload.instances_with_qubits(family, family["first_seed"], 1)[0]
    hamiltonian = program.encode(instance, family["makespan_limit"])
    assert hamiltonian.n_qubits == 20
    result = program.solver(config["solver"], 2**31 + 17).compute_minimum_eigenvalue(hamiltonian)
    counts = profiling.counts_since(1)
    assert sum(n for row, n in counts.items() if row.startswith("fold_kernels.")) > 0
    assert counts["fold_kernels.nft_layer_sweep_folded"] > 0
    assert counts["fold_pipeline.builds"] > 0
    assert counts["fold_pipeline.kernel"] == counts["fold_pipeline.builds"]
    answer = program.solve_answer(result, hamiltonian, 8)
    gaps = check.solve_gaps(answer, instance_seed, instance,
                            check.Reference(family["makespan_limit"], "cuda"))
    ok, shown = check.verdict(gaps, config["limits"])
    assert ok, shown
