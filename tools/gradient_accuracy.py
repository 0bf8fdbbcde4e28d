#!/usr/bin/env python3
"""Accuracy of the port's float32 autograd gradients against float64.

At ``chip_smoke.py``'s use_fold inputs (config 4's 20-qubit JSSP table, a
seeded 16-individual population, every individual's last-layer
coordinates) this takes d(sum of energies)/d theta at theta = 0 through

- ``slot``: the slot engine (``sim/statevector.py``), the gradient
  optimizer's default objective (``optim/gradient.py``);
- ``fold``: its ``use_fold`` objective (``sim/fold_pipeline.py::
  simulate_circuits_folded``, each factor in real pair arithmetic);
- ``matmul-fold``: the fold pipeline through the fold kernels' plain
  version (``apply_fold_pipeline_plain``, complex matmuls per factor),

and prints each one's largest error against the slot engine's float64
gradient, over max|table|, per individual and at its worst coordinate.

    python3 tools/gradient_accuracy.py                 # on the card
    python3 tools/gradient_accuracy.py --device cpu --individuals 0 1 2 3
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from queasars_tpu_torch.optim.gradient import _Objective, energies_from_states  # noqa: E402
from queasars_tpu_torch.optim.objective import objective_operands  # noqa: E402
from queasars_tpu_torch.paulis import diagonal_energy_table  # noqa: E402
from queasars_tpu_torch.sim.evaluators import (  # noqa: E402
    StatevectorExpectationEvaluator,
    packed_tensors,
)
from queasars_tpu_torch.sim.fold_pipeline import (  # noqa: E402
    apply_fold_pipeline_plain,
    build_fold_pipeline,
    simulate_circuits_folded,
)
from queasars_tpu_torch.sim.statevector import simulate_circuits  # noqa: E402


def matmul_fold(gate_types, controls, angles, layer_mask, n_qubits, initial=None):
    return apply_fold_pipeline_plain(
        build_fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits), n_qubits, initial)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--individuals", type=int, nargs="*", default=None)
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("gradient_accuracy: no CUDA device", file=sys.stderr)
        return 2
    _, _, hamiltonian = chip_smoke.jssp_with_qubits(3, 3, 6, 20, {1: 0.5, 2: 0.5})
    n = hamiltonian.n_qubits
    table = diagonal_energy_table(hamiltonian, dtype=torch.float32, device=device)
    packed, coords, n_free = chip_smoke.last_layer_problem(n, chip_smoke.GRADIENT_CALL)
    keep = args.individuals or list(range(packed.n_individuals))
    gt, ctrl, ang, lm = (t[keep] for t in packed_tensors(packed, device=device))
    coords, n_free = coords[keep], n_free[keep]
    mask = torch.as_tensor(np.arange(coords.shape[1])[None] < n_free[:, None],
                           dtype=torch.float32, device=device)
    operands = objective_operands(StatevectorExpectationEvaluator(hamiltonian, device=device))
    objective = _Objective(operands, n, (gt, ctrl, lm), None,
                           torch.as_tensor(coords, dtype=torch.long, device=device), mask,
                           ang.shape)
    exact = chip_smoke.float64_gradient(objective, ang, table, n)

    def gradient_through(simulate):
        leaf = torch.zeros_like(mask).requires_grad_(True)
        states = simulate(gt, ctrl, objective.shifted(ang, leaf * mask), lm, n)
        energies_from_states(states, operands).sum().backward()
        return leaf.grad

    gradients = {label: gradient_through(simulate) for label, simulate in (
        ("slot", simulate_circuits), ("fold", simulate_circuits_folded),
        ("matmul-fold", matmul_fold))}
    scale = float(table.abs().max())
    card = chip_smoke.phase_device()[0] if device.type == "cuda" else "cpu"
    print(f"{card}; n={n}, individuals {keep}, max|table| {scale:.3f}")
    for label, grad in gradients.items():
        error = (grad.double() - exact).abs()
        worst = int(error.argmax())
        row, col = divmod(worst, error.shape[1])
        layer, qubit, angle = (int(v) for v in coords[row, col])
        per = error.max(dim=1).values.cpu().numpy() / scale
        print(f"{label}: largest error {float(error.max()):.4g} = {float(error.max()) / scale:.3e} "
              f"of max|table| at individual {keep[row]}, layer {layer}, qubit {qubit}, angle "
              f"{angle} (gate type {int(gt[row, layer, qubit])}, float64 gradient "
              f"{float(exact[row, col]):.4f}); per individual "
              f"{np.array2string(per, precision=2)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
