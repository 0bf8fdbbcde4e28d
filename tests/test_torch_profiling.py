"""The port's profiling helpers and plots.

``utils/profiling.trace`` writes a Chrome trace of the enclosed region on
the CPU, ``annotate`` names a region in the profiler's events, and the
convergence, Pareto-front and JSSP Gantt plots draw the same line, point
and bar data as the JAX package's on equal inputs.
"""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch

import queasars_tpu.problems.jssp as jax_jssp
import queasars_tpu.problems.jssp.visualization as jax_gantt
import queasars_tpu.solver.visualization as jax_plots
import queasars_tpu_torch.problems.jssp as jssp
import queasars_tpu_torch.problems.jssp.visualization as gantt
import queasars_tpu_torch.solver.visualization as plots
from queasars_tpu_torch.utils import annotate, trace
from tests.test_torch_serialization import JAX, PORT, solver_result


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir, label="unit"):
        with annotate("selection"):
            torch.ones(64).cumsum(0)
    (path,) = glob.glob(os.path.join(log_dir, "unit.*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(event.get("name") == "selection" for event in events)


def test_trace_without_a_directory_only_times(tmp_path):
    with trace(None):
        pass
    assert os.listdir(tmp_path) == []


def test_annotate_names_a_profiler_event():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("selection"):
            torch.arange(10).sum()
    assert "selection" in {event.key for event in prof.key_averages()}


def _lines(figure):
    return [(list(line.get_xdata()), list(line.get_ydata())) for line in figure.axes[0].lines]


def _bars(figure):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height(), p.get_facecolor())
            for p in figure.axes[0].patches]


def test_convergence_and_pareto_plots_equal_the_jax_package(tmp_path):
    import matplotlib.pyplot as plt

    ours, theirs = solver_result(PORT), solver_result(JAX)
    figures = [plots.plot_convergence(ours), jax_plots.plot_convergence(theirs)]
    assert _lines(figures[0]) == _lines(figures[1]) and len(_lines(figures[0])) == 3
    pareto = [plots.plot_pareto_front(ours), jax_plots.plot_pareto_front(theirs)]
    assert _lines(pareto[0]) == _lines(pareto[1])
    offsets = [fig.axes[0].collections[0].get_offsets().tolist() for fig in pareto]
    assert offsets[0] == offsets[1]
    path = str(tmp_path / "convergence.png")
    assert plots.plot_convergence(ours, path=path) is None and os.path.getsize(path) > 0
    for fig in figures + pareto:
        plt.close(fig)


def test_gantt_plots_equal_the_jax_package():
    import matplotlib.pyplot as plt

    args = dict(n_jobs=2, n_machines=2, relative_op_amount=1.0, op_duration=1, random_seed=0)
    ours = jssp.random_job_shop_scheduling_instance("g", **args)
    theirs = jax_jssp.random_job_shop_scheduling_instance("g", **args)
    figures = [gantt.plot_jssp_problem_instance_gantt(ours),
               jax_gantt.plot_jssp_problem_instance_gantt(theirs)]
    assert _bars(figures[0]) == _bars(figures[1]) and _bars(figures[0])
    encoders = [jssp.JSSPDomainWallHamiltonianEncoder(ours, makespan_limit=3),
                jax_jssp.JSSPDomainWallHamiltonianEncoder(theirs, makespan_limit=3)]
    valid = next(s for s in range(1 << encoders[0].n_qubits)
                 if encoders[0].translate_result_state(s).is_valid)
    schedules = [gantt.plot_jssp_problem_solution_gantt(encoders[0].translate_result_state(valid)),
                 jax_gantt.plot_jssp_problem_solution_gantt(
                     encoders[1].translate_result_state(valid))]
    assert _bars(schedules[0]) == _bars(schedules[1]) and _bars(schedules[0])
    invalid = next(s for s in range(1 << encoders[0].n_qubits)
                   if not encoders[0].translate_result_state(s).is_valid)
    with pytest.raises(jssp.JobShopSchedulingProblemException):
        gantt.plot_jssp_problem_solution_gantt(encoders[0].translate_result_state(invalid))
    for fig in figures + schedules:
        plt.close(fig)
