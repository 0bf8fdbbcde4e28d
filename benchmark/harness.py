"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

:func:`run_cell` takes the cell's entry, its configuration, its traffic mix
and the metric entries of ``BENCHMARK.json`` as data; ``benchmark/run.py``
finds them by name.  A closed loop with one client drives the port: the
next solve (or evaluator call) starts when the previous one has returned
its answer to the host.  Set-up ends, and the window starts, after a
warm-up that runs the cell's own shapes; the window closes at the first
answer after ``seconds`` and holds every answer before it.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import sys
import time
import traceback
from pathlib import Path

from benchmark import check, workload
from benchmark.devicetrace import DeviceWindow, EntryWork, Spans, reduce_window

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "queasars_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded."""


_IMPORTED = time.perf_counter()


def process_seconds() -> float:
    """Seconds since this process started (from ``/proc``), or since the
    harness was imported where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    """The reader of metric ``name``: ``benchmark/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(cell: str, end_to_end: list[dict], per_layer: list[dict]) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries this cell reports."""
    e2e = [m for m in end_to_end if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in per_layer
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def say(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the two kinds of traffic
# ---------------------------------------------------------------------------


class SolveTraffic:
    """Closed-loop EVQE solves (``kind: solve``)."""

    kind = "solve"

    def __init__(self, config, traffic, seed, device, spans):
        from benchmark import program

        self.program, self.config, self.traffic = program, config, traffic
        self.seed, self.device, self.spans = seed, device, spans
        self.limit = config["instance"]["makespan_limit"]
        self.plan = workload.plan_solves(config, traffic, seed)
        self.fixed = None
        if not traffic["fresh_instances"]:
            instance_seed, instance = self.plan.fixed
            self.fixed = program.encode(instance, self.limit, f"i{instance_seed}")
        self.seconds, self.evals, self.kept, self.longest = [], [], [], None
        self.failed = 0

    def _solve(self, request, traced):
        instance_seed, instance, solver_seed = request
        if self.fixed is None:
            with self.spans.span("encode"):
                hamiltonian = self.program.encode(instance, self.limit, f"i{instance_seed}")
        else:
            hamiltonian = self.fixed
        solver = self.program.solver(self.config["solver"], solver_seed, self.device)
        if traced:
            for op in solver.configuration.evolutionary_operators:
                self.spans.wrap(op, "apply_operator", type(op).__name__)
            self.spans.wrap(solver, "_measure_eigenstate", "eigenstate")
        return solver.compute_minimum_eigenvalue(hamiltonian), hamiltonian

    def warmup(self) -> None:
        for k in range(2):
            self._solve(self.plan.warmup(k), traced=False)

    def step(self, i: int, traced: bool) -> None:
        request = self.plan.request(i)
        start = time.perf_counter()
        try:
            with self.spans.span("solve"):
                result, hamiltonian = self._solve(request, traced)
        except Exception:  # a solve that raises is a failed request, and the loop goes on
            self.failed += 1
            say(f"solve {i} failed:\n{traceback.format_exc()}")
            self.seconds.append(time.perf_counter() - start)
            return
        seconds = time.perf_counter() - start
        self.seconds.append(seconds)
        self.evals.append(sum(result.circuit_evaluations))
        record = (result, hamiltonian, request)
        if len(self.kept) < self.traffic["checked_solves"]:
            self.kept.append((i, record))
        else:
            slot = workload.reservoir_slot(self.seed, i)
            if slot < len(self.kept):
                self.kept[slot] = (i, record)
        if self.longest is None or seconds > self.longest[0]:
            self.longest = (seconds, i, record)

    def done(self) -> int:
        return len(self.seconds)

    def answers(self) -> list[tuple]:
        """(request index, plain answer, (instance seed, instance)) of the
        solves sampled for the check and the longest one."""
        chosen = dict(self.kept)
        if self.longest is not None:
            chosen[self.longest[1]] = self.longest[2]
        out = []
        for i, (result, hamiltonian, request) in sorted(chosen.items()):
            out.append((i, self.program.solve_answer(result, hamiltonian,
                                                     self.traffic["leading_bitstrings"]),
                        request[:2]))
        return out

    def release(self) -> None:
        self.kept, self.longest, self.fixed = [], None, None

    def readings(self, answers, ref, truth=None) -> list[dict]:
        return [check.solve_gaps(answer, instance_seed, instance, ref, truth)
                for _, answer, (instance_seed, instance) in answers]

    numbers = check.SOLVE_NUMBERS


class EnergiesTraffic:
    """Closed-loop evaluator calls (``kind: energies``)."""

    kind = "energies"

    def __init__(self, config, traffic, seed, device, spans):
        from benchmark import program

        self.config, self.traffic, self.seed, self.spans = config, traffic, seed, spans
        family = config["instance"]
        self.instance = workload.instances_with_qubits(family, family["first_seed"], 1)[0][1]
        self.plan = workload.plan_energies(config, traffic, seed)
        hamiltonian = program.encode(self.instance, family["makespan_limit"])
        self.evaluate = program.Energies(hamiltonian, self.plan, device)
        self.outputs, self.failed = [], 0

    def warmup(self) -> None:
        for extra in range(2):
            self.evaluate(self.plan.warmup_angles(extra, self.evaluate.shape))

    def step(self, i: int, traced: bool) -> None:
        with self.spans.span("draw_angles"):
            angles = self.plan.angles(i, self.evaluate.shape)
        try:
            with self.spans.span("evaluate_packed"):
                self.outputs.append(self.evaluate(angles))
        except Exception:  # a call that raises is a failed request, and the loop goes on
            self.failed += 1
            self.outputs.append(None)
            say(f"call {i} failed:\n{traceback.format_exc()}")

    def done(self) -> int:
        return len(self.outputs)

    def answers(self) -> list[tuple]:
        rng = workload.stream(self.seed, 6)
        done = [i for i, out in enumerate(self.outputs) if out is not None]
        take = sorted(rng.choice(done, size=min(self.traffic["checked_calls"], len(done)),
                                 replace=False).tolist()) if done else []
        return [(i, self.outputs[i], self.evaluate.circuits(
            self.plan.angles(i, self.evaluate.shape))) for i in take]

    def release(self) -> None:
        self.evaluate = None

    def readings(self, answers, ref, truth=None) -> list[dict]:
        return [{"energy_gap": check.energy_gap(out, circuits, 0, self.instance, ref, truth)}
                for _, out, circuits in answers]

    numbers = check.ENERGY_NUMBERS


KINDS = {"solve": SolveTraffic, "energies": EnergiesTraffic}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run_cell(cell: dict, config: dict, traffic: dict, end_to_end: list, per_layer: list, *,
             seed: int, seconds: float, trace: bool, device: str | None = None,
             control: bool = False) -> dict:
    """Run ``cell`` once and return its result line.  ``device`` None means
    the cards (raises :class:`NoDevice` without them); ``"cpu"`` runs the
    port's plain versions, for tests.  ``control`` judges the reference in
    bfloat16 in the port's place, on the port's circuits, as well: ``correct``
    then judges the control, and ``port`` keeps the port's readings."""
    os.environ.update(config.get("env", {}))
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"the cell needs {cell['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    on_card = device is None
    where = "cuda" if on_card else device

    spans = Spans()
    load = KINDS[traffic["kind"]](config, traffic, seed, device, spans)
    load.warmup()
    entries = EntryWork() if trace else None
    if trace:
        entries.install()
    if on_card:
        torch.cuda.synchronize()
    spans.intervals.clear()
    setup_s = process_seconds()

    window = DeviceWindow() if (trace and on_card) else None
    if window is not None:
        window.start()
    if entries is not None:
        entries.recording = True
    launches_before = entries.launches() if entries else 0
    start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - start < seconds:
        load.step(i, traced=trace)
        i += 1
    end = time.perf_counter()
    if entries is not None:
        entries.recording = False
    if window is not None:
        window.stop()
    launches_total = entries.launches() - launches_before if entries else 0

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"loaded after the window: {', '.join(found)}")

    if load.kind == "solve":
        say("solve seconds: " + " ".join(f"{s:.4f}" for s in load.seconds))
    answers = load.answers()
    load.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    limit = config["instance"]["makespan_limit"]
    truth = check.Reference(limit, where)
    worst = check.worst(load.readings(answers, truth), load.numbers)
    ok, shown = check.verdict(worst, config["limits"])
    control_shown = None
    if control:
        lower = check.Reference(limit, where, torch.bfloat16)
        ok, control_shown = check.verdict(
            check.worst(load.readings(answers, lower, truth), load.numbers), config["limits"])
    attempted, failed = load.done(), load.failed
    correct = ok and failed == 0 and bool(answers)

    run = {"kind": load.kind, "setup_s": setup_s, "window_s": end - start,
           "done": attempted - failed, "attempted": attempted,
           "solve_s": getattr(load, "seconds", []), "evals": getattr(load, "evals", []),
           "population": getattr(getattr(load, "plan", None), "population", None),
           "trace": None}
    breakdown = None
    if trace:
        least, by_rule = entries.least_seconds()
        entries.uninstall()
        spans_total = {name: spans.total(name) for name in {n for _, _, n, _ in spans.intervals}}
        run["trace"] = {"least_s": least, "by_rule": by_rule, "spans": spans_total,
                        "encodes": spans.count("encode")}
        say(f"entry points (seconds, bound by bytes, by operations, calls): {by_rule}; "
            f"hand-written launches in the window {launches_total}, inside entry points "
            f"{entries.launches_inside}")
        if window is not None:
            reduced = reduce_window(window.device_events(), start, end, spans)
            run["trace"].update(reduced)
            breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
            say(f"device window: busy {reduced['busy_s']:.4f} s of {reduced['window_s']:.4f} s, "
                f"{reduced['kernels']} kernels, {reduced['kernel_s']:.4f} s in kernels, "
                f"longest gap {reduced['longest_gap_s'] * 1e3:.3f} ms")

    e2e, layer = cell_metrics(cell["name"], end_to_end, per_layer)
    chosen = layer if trace else e2e
    metrics = {}
    for entry in chosen:
        value = load_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    device_info = {"platform": "gpu" if on_card else where,
                   "kind": torch.cuda.get_device_name(0) if on_card else where,
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace and run["trace"] and "busy_s" in run["trace"]:
        device_info["busy_s"] = run["trace"]["busy_s"]
        device_info["window_s"] = run["trace"]["window_s"]
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if control_shown is not None:
        line["port"] = shown
    line["checked"] = {"answers": len(answers), **(control_shown or shown)}
    say(f"checked {len(answers)} answers of {attempted} ({failed} failed)"
        + (": the control, the reference in bfloat16 in the port's place" if control else ""))
    for name, entry in (control_shown or shown).items():
        say(f"{name} {entry['value']!r} limit {entry['limit']!r}")
    return line
