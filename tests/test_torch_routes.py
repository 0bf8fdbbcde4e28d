"""The route policy of ``queasars_tpu_torch/sim/routes.py``, and its dispatch.

One table holds every rule that picks between the slot and the kron-fold
engines, and the fold kernels' capabilities the rules consult: each case is
a call under an environment and the answer it must give.  A device is only
named there (``fold_supported`` reads its type), so the CUDA cases run on
the CPU.  The dispatch cases force the fold route on the CPU by replacing
``fold_kernels.fold_supported``, as the solve tests do, and hold each
operation to the wrapper it must call.
"""

from __future__ import annotations

import pytest
import torch

from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation
from queasars_tpu_torch.sim import fold_kernels as fk
from queasars_tpu_torch.sim import fold_pipeline, routes
from queasars_tpu_torch.sim import slot_kernels as sk
from queasars_tpu_torch.sim.evaluators import packed_tensors
from queasars_tpu_torch.utils import prng

UNSET = {"QUEASARS_MXU": None}
MXU_OFF = {"QUEASARS_MXU": "0"}
ONE_LAUNCH = {"QUEASARS_GROUPED_ONE_LAUNCH": None}
SHARD = {"QUEASARS_SHARD_FOLD": None}


def _supported(path, device):
    return [n for n in range(4, 25) if fk.fold_supported(n, device, path)]


def _sampler_cases():
    """The in-kernel sampler at 13, 14, 20 and 21 qubits on each route:
    True the folded sampler, False the slot sampler, None neither."""
    want = {True: (None, True, True, True), False: (None, False, False, None)}
    return [
        (f"sampler-{'fold' if fold else 'slot'}-{n}", UNSET,
         lambda fold=fold, n=n: routes.sampler_route(fold, n, "cuda"), w)
        for fold, answers in want.items() for n, w in zip((13, 14, 20, 21), answers)
    ]


ROUTE_TABLE = [
    # the fold kernels' capabilities (exact 7-22, sampler 7-21, sweep 7-20; CUDA only)
    ("supported-exact-cuda", {}, lambda: _supported("exact", "cuda"), list(range(7, 23))),
    ("supported-sampler-cuda", {}, lambda: _supported("sampler", "cuda"), list(range(7, 22))),
    ("supported-sweep-cuda", {}, lambda: _supported("sweep", "cuda"), list(range(7, 21))),
    ("supported-exact-cpu", {}, lambda: _supported("exact", "cpu"), []),
    ("supported-sampler-cpu", {}, lambda: _supported("sampler", "cpu"), []),
    ("supported-sweep-cpu", {}, lambda: _supported("sweep", "cpu"), []),
    ("supported-unknown-path", {}, lambda: fk.fold_supported(10, "cuda", "grouped"), ValueError),
    # the optimizers' route: explicit use_mxu, else QUEASARS_MXU, and a path the kernels take
    ("mxu-unset-sweep-20", UNSET, lambda: routes.fold_enabled(None, 20, "sweep", "cuda"), True),
    ("mxu-unset-sweep-21", UNSET, lambda: routes.fold_enabled(None, 21, "sweep", "cuda"), False),
    ("mxu-unset-exact-21", UNSET, lambda: routes.fold_enabled(None, 21, device="cuda"), True),
    ("mxu-unset-exact-6", UNSET, lambda: routes.fold_enabled(None, 6, device="cuda"), False),
    ("mxu-unset-cpu", UNSET, lambda: routes.fold_enabled(None, 20, device="cpu"), False),
    ("mxu-on-cpu", UNSET, lambda: routes.fold_enabled(True, 20, device="cpu"), False),
    ("mxu-off", MXU_OFF, lambda: routes.fold_enabled(None, 20, device="cuda"), False),
    ("mxu-off-asked-on", MXU_OFF, lambda: routes.fold_enabled(True, 20, device="cuda"), True),
    ("mxu-off-asked-off", MXU_OFF, lambda: routes.fold_enabled(False, 20, device="cuda"), False),
    ("mxu-one", {"QUEASARS_MXU": "1"}, lambda: routes.fold_enabled(None, 20, device="cuda"),
     True),
    # frozen-prefix states: the fold route only at n = 21-22
    ("prefix-20", UNSET, lambda: routes.prefix_fold(20, "cuda"), False),
    ("prefix-21", UNSET, lambda: routes.prefix_fold(21, "cuda"), True),
    ("prefix-22-cpu", UNSET, lambda: routes.prefix_fold(22, "cpu"), False),
    ("prefix-22-mxu-off", MXU_OFF, lambda: routes.prefix_fold(22, "cuda"), False),
    *_sampler_cases(),
    # grouped measurement on the fold route: one launch for at most 64 groups
    ("grouped-64", ONE_LAUNCH, lambda: routes.grouped_one_launch(14, "cuda", 64), True),
    ("grouped-65", ONE_LAUNCH, lambda: routes.grouped_one_launch(14, "cuda", 65), False),
    ("grouped-64-off", {"QUEASARS_GROUPED_ONE_LAUNCH": "0"},
     lambda: routes.grouped_one_launch(14, "cuda", 64), False),
    # the amplitude-sharded evaluator: fold from n = 10 unless QUEASARS_SHARD_FOLD=0
    ("shard-9", SHARD, lambda: routes.shard_fold(None, 9), False),
    ("shard-10", SHARD, lambda: routes.shard_fold(None, 10), True),
    ("shard-10-off", {"QUEASARS_SHARD_FOLD": "0"}, lambda: routes.shard_fold(None, 10), False),
    ("shard-9-asked-on", {"QUEASARS_SHARD_FOLD": "0"}, lambda: routes.shard_fold(True, 9), True),
]


@pytest.mark.parametrize(
    "env, call, want", [case[1:] for case in ROUTE_TABLE], ids=[case[0] for case in ROUTE_TABLE]
)
def test_route_table(monkeypatch, env, call, want):
    for name, value in env.items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    if want is ValueError:
        with pytest.raises(ValueError):
            call()
    else:
        assert call() == want


def _genome(n, pop=2, layers=2, seed=4):
    population = EVQEPopulation.random_population(n, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals), min_layers=layers + 1)
    return packed_tensors(packed, device="cpu")


def _operations(n):
    """Per operation: the dispatch call, the fold wrapper it must reach on
    the fold route (given the absorbed pipeline) and the slot wrapper."""
    genome = _genome(n)
    table = torch.linspace(-1.0, 2.0, 1 << n)
    keys = prng.split(prng.PRNGKey(3), genome[0].shape[0])
    frac = prng.uniform(keys, (32,))
    return genome, {
        "states": (
            lambda fold: routes.states(*genome, n, fold=fold),
            lambda pipe: fk.population_states_folded(pipe, n),
            lambda: sk.population_states(*genome, n),
        ),
        "energies": (
            lambda fold: routes.energies(*genome, table, n, use_mxu=fold),
            lambda pipe: fk.energies_exact_folded(pipe, table, n),
            lambda: sk.energies_exact(*genome, table, n),
        ),
        "probs": (
            lambda fold: routes.probs(*genome, n, use_mxu=fold),
            lambda pipe: fk.population_probs_folded(pipe, n),
            lambda: sk.population_probs(*genome, n),
        ),
        "shot_indices": (
            lambda fold: routes.shot_indices(*genome, keys, n, 32, fold=fold),
            lambda pipe: fk.sampled_shot_indices_folded(pipe, frac, n),
            lambda: sk.sampled_shot_indices(*genome, frac, n),
        ),
    }


@pytest.mark.parametrize("operation", ["states", "energies", "probs", "shot_indices"])
@pytest.mark.parametrize("fold", [True, False])
def test_each_operation_runs_on_its_route_with_one_build(monkeypatch, operation, fold):
    """On the fold route an operation builds the absorbed pipeline once and
    gives the fold wrapper's answer; on the slot route it builds nothing
    and gives the slot wrapper's."""
    monkeypatch.setattr(
        fk, "fold_supported",
        lambda n, device, path="exact": fold_pipeline.LANE_BITS <= n <= fk._CAPS[path])
    monkeypatch.setattr(fold_pipeline, "build_counts", {"builds": 0, "host_ns": 0, "kernel": 0})
    n = 14
    genome, operations = _operations(n)
    dispatch, folded, slot = operations[operation]
    got = dispatch(fold)
    assert fold_pipeline.build_counts["builds"] == int(fold)
    if fold:
        want = folded(fold_pipeline.build_fold_pipeline(*genome, n, absorb_diag=True))
    else:
        want = slot()
    assert torch.equal(got, want)
