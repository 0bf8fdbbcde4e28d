"""Matplotlib Gantt-chart visualization for JSSP instances and results.

Counterpart of ``queasars_tpu/problems/jssp/visualization.py``, with
matplotlib imported when a plot is drawn, so that importing this module
does not need it.  API mirror of queasars/job_shop_scheduling/visualization.py:20-146:
instances plot as job rows colored by machine; valid results plot as
machine rows colored by job; both either save to a path or return the
figure.
"""

from __future__ import annotations

from typing import Optional

from queasars_tpu_torch.problems.jssp.problem_instances import (
    JobShopSchedulingProblemInstance,
    JobShopSchedulingProblemException,
    JobShopSchedulingResult,
)


def _pyplot():
    """matplotlib's pyplot on the Agg backend and the color cycle."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt, plt.rcParams["axes.prop_cycle"].by_key()["color"]


def _color_legend(axis, labels: list[str], colors: list[str]) -> None:
    """Attach a color legend for the given labels
    (reference: visualization.py:142-146)."""
    from matplotlib.patches import Patch

    handles = [
        Patch(facecolor=colors[i % len(colors)], label=label)
        for i, label in enumerate(labels)
    ]
    axis.legend(handles=handles, loc="upper right")


def plot_jssp_problem_instance_gantt(
    problem_instance: JobShopSchedulingProblemInstance,
    save_path: Optional[str] = None,
):
    """Gantt chart of an instance: one row per job, operations laid out
    back-to-back in job order, colored by machine.

    Reference: visualization.py:20-74.
    """
    plt, colors = _pyplot()
    machines = list(problem_instance.machines)
    machine_color = {m: colors[i % len(colors)] for i, m in enumerate(machines)}

    fig, axis = plt.subplots(figsize=(10, 0.8 * max(2, len(problem_instance.jobs))))
    yticks, ylabels = [], []
    for row, job in enumerate(problem_instance.jobs):
        start = 0
        for operation in job.operations:
            axis.barh(
                y=row,
                width=operation.processing_duration,
                left=start,
                height=0.6,
                color=machine_color[operation.machine],
                edgecolor="black",
            )
            start += operation.processing_duration
        yticks.append(row)
        ylabels.append(job.name)
    axis.set_yticks(yticks, labels=ylabels)
    axis.set_xlabel("time")
    axis.set_title(problem_instance.name)
    _color_legend(axis, [m.name for m in machines], colors)
    fig.tight_layout()

    if save_path is not None:
        fig.savefig(save_path)
        plt.close(fig)
        return None
    return fig


def plot_jssp_problem_solution_gantt(
    result: JobShopSchedulingResult,
    save_path: Optional[str] = None,
):
    """Gantt chart of a *valid* result: one row per machine, scheduled
    operations at their start times, colored by job.

    Raises for invalid results (the reference requires a valid schedule,
    visualization.py:77-139).
    """
    if not result.is_valid:
        raise JobShopSchedulingProblemException("Cannot plot the Gantt chart of an invalid result!")

    plt, colors = _pyplot()
    instance = result.problem_instance
    jobs = list(instance.jobs)
    job_color = {job: colors[i % len(colors)] for i, job in enumerate(jobs)}
    machine_rows = {m: i for i, m in enumerate(instance.machines)}

    fig, axis = plt.subplots(figsize=(10, 0.8 * max(2, len(instance.machines))))
    for job, scheduled_operations in result.valid_schedule.items():
        for scheduled in scheduled_operations:
            axis.barh(
                y=machine_rows[scheduled.operation.machine],
                width=scheduled.operation.processing_duration,
                left=scheduled.start_time,
                height=0.6,
                color=job_color[job],
                edgecolor="black",
            )
    axis.set_yticks(
        list(machine_rows.values()), labels=[m.name for m in machine_rows.keys()]
    )
    axis.set_xlabel("time")
    axis.set_title(f"{instance.name} (makespan {result.makespan})")
    _color_legend(axis, [job.name for job in jobs], colors)
    fig.tight_layout()

    if save_path is not None:
        fig.savefig(save_path)
        plt.close(fig)
        return None
    return fig
