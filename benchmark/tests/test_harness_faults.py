"""Runs at a small size on the CPU, with the harness's look for a card
skipped: the port's answers pass, and ``correct`` comes out false with the
control (the reference in bfloat16 in the port's place) and with each fault
these cells can have planted under the timed path: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, and an answer altered where it is produced.  (One card: there is no
exchange between cards to leave out.)  In a solve, half of the batch left
out shows in the energies it reports for its final generation."""

import numpy as np
import pytest

from benchmark.tests import small

SOLVE_CELLS = ["jssp20-exact.seeds", "jssp20-exact.instances", "jssp22-exact.seeds"]
CELLS = SOLVE_CELLS + ["jssp20-exact.energies"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_ports_answers_pass(cell):
    line = small.run(cell, trace=cell.endswith("instances"))
    assert line["correct"] is True, line["checked"]
    assert line["failed"] == 0 and line["checked"]["answers"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    assert small.run(cell, control=True)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_fails(cell, monkeypatch):
    from queasars_tpu_torch.sim import statevector

    monkeypatch.setattr(statevector, "apply_u3_pairs",
                        lambda state, *args, **kwargs: state)
    assert small.run(cell)["correct"] is False


def _half(energies):
    """Half of the batch left out: its energies are the mean of the rest."""
    import torch

    keep = max(energies.shape[0] // 2, 1)
    return torch.cat([energies[:keep], energies[:keep].mean().expand(energies.shape[0] - keep)])


def test_half_the_batch_left_out_fails(monkeypatch):
    from queasars_tpu_torch.sim import slot_kernels

    original = slot_kernels.energies_exact
    monkeypatch.setattr(slot_kernels, "energies_exact",
                        lambda *args, **kwargs: _half(original(*args, **kwargs)))
    assert small.run("jssp20-exact.energies")["correct"] is False


@pytest.mark.parametrize("cell", SOLVE_CELLS)
def test_half_the_batch_left_out_of_a_solve_fails(cell, monkeypatch):
    from queasars_tpu_torch.sim import slot_kernels

    energies, sweep = slot_kernels.energies_exact, slot_kernels.nft_layer_sweep

    def half_sweep(*args, **kwargs):
        layer_angles, final = sweep(*args, **kwargs)
        return layer_angles, _half(final)

    monkeypatch.setattr(slot_kernels, "energies_exact",
                        lambda *args, **kwargs: _half(energies(*args, **kwargs)))
    monkeypatch.setattr(slot_kernels, "nft_layer_sweep", half_sweep)
    line = small.run(cell)
    assert line["correct"] is False
    gap = line["checked"]["population_energy_gap"]
    assert gap["value"] is None or gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell", SOLVE_CELLS)
def test_an_altered_eigenvalue_fails(cell, monkeypatch):
    from queasars_tpu_torch.solver.driver import EvolvingAnsatzMinimumEigensolver

    original = EvolvingAnsatzMinimumEigensolver.compute_minimum_eigenvalue

    def altered(self, operator, aux_operators=None):
        result = original(self, operator, aux_operators)
        result.eigenvalue = result.eigenvalue + 10.0
        return result

    monkeypatch.setattr(EvolvingAnsatzMinimumEigensolver, "compute_minimum_eigenvalue", altered)
    assert small.run(cell)["correct"] is False


def test_an_altered_energy_fails(monkeypatch):
    from queasars_tpu_torch.sim.evaluators import StatevectorExpectationEvaluator

    original = StatevectorExpectationEvaluator.evaluate_packed

    def altered(self, packed, angles=None):
        out = np.array(original(self, packed, angles), dtype=np.float64)
        out[-1] += 10.0
        return out

    monkeypatch.setattr(StatevectorExpectationEvaluator, "evaluate_packed", altered)
    assert small.run("jssp20-exact.energies")["correct"] is False


def test_a_solve_that_raises_is_counted_failed(monkeypatch):
    from queasars_tpu_torch.solver.driver import EvolvingAnsatzMinimumEigensolver

    original = EvolvingAnsatzMinimumEigensolver.compute_minimum_eigenvalue
    calls = []

    def broken(self, operator, aux_operators=None):
        calls.append(1)
        if len(calls) > 2 and len(calls) % 2:
            raise RuntimeError("planted")
        return original(self, operator, aux_operators)

    monkeypatch.setattr(EvolvingAnsatzMinimumEigensolver, "compute_minimum_eigenvalue", broken)
    line = small.run("jssp20-exact.seeds")
    assert line["correct"] is False and line["attempted"] > line["failed"] >= 1
