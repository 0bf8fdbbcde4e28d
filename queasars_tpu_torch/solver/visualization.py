"""Solve-result visualization: convergence curves and Pareto fronts.

Counterpart of ``queasars_tpu/solver/visualization.py``.  Companion to the
JSSP Gantt plots (problems/jssp/visualization.py, the reference's only
plotting surface): render how a solve progressed.
Matplotlib is imported lazily; every function either saves to ``path`` or
returns the figure (the reference's save-or-return convention,
visualization.py:20,77).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from queasars_tpu_torch.solver.result import EvolvingAnsatzMinimumEigensolverResult


def plot_convergence(
    result: EvolvingAnsatzMinimumEigensolverResult,
    path: Optional[str] = None,
    title: str = "EVQE convergence",
):
    """Best / median / mean population energy per generation.

    :param path: save target (None = return the figure)
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    generations = range(len(result.population_evaluation_results))
    best, median, mean = [], [], []
    for evaluation in result.population_evaluation_results:
        values = [v for v in evaluation.expectation_values if v is not None]
        best.append(evaluation.best_expectation_value)
        median.append(float(np.median(values)))
        mean.append(float(np.mean(values)))

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(generations, best, marker="o", label="best")
    ax.plot(generations, median, marker="s", label="median")
    ax.plot(generations, mean, marker="^", label="mean")
    ax.set_xlabel("generation")
    ax.set_ylabel("expectation value")
    ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path)
        plt.close(fig)
        return None
    return fig


def plot_pareto_front(
    result: EvolvingAnsatzMinimumEigensolverResult,
    path: Optional[str] = None,
    title: str = "MoG-VQE Pareto front",
):
    """Energy vs two-qubit-gate count of the final population, with the
    non-dominated front highlighted (MoG-VQE's result surface,
    solver/mog_vqe.py).

    :param path: save target (None = return the figure)
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from queasars_tpu_torch.solver.mog_vqe import result_pareto_front

    final = result.final_population_evaluation_result
    energies = [v for v in final.expectation_values]
    gates = [individual.get_n_controlled_gates() for individual in final.population.individuals]
    front = result_pareto_front(result)

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.scatter(gates, energies, alpha=0.4, label="population")
    if front:
        front_sorted = sorted(front, key=lambda item: item[2])
        ax.plot(
            [g for _, _, g in front_sorted],
            [e for _, e, _ in front_sorted],
            marker="o", color="crimson", label="Pareto front",
        )
    ax.set_xlabel("two-qubit gates")
    ax.set_ylabel("energy")
    ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path)
        plt.close(fig)
        return None
    return fig
