"""Batched statevector engine over tensor-encoded circuit genomes (PyTorch).

Counterpart of ``queasars_tpu/sim/statevector.py``: the same genome tensor
contract and gate semantics, written as plain population-batched PyTorch.
It is the plain version behind the slot kernels (``sim/slot_kernels.py``):
the CPU runs it, and on the card it is what every kernel is held against.

Genome encoding (one slot per qubit per layer):

- ``gate_types[P, L, n]`` int32 — GATE_ID=0 / GATE_ROT=1 / GATE_CTRL=2 /
  GATE_CROT=3 (the reference's EVQEGateType codes),
- ``controls[P, L, n]`` int32 — control qubit of a GATE_CROT slot, else -1,
- ``angles[P, L, n, 3]`` float32 — (theta, phi, lambda) of the U3/CU3,
- ``layer_mask[P, L]`` bool — real layers vs padding.

Gate semantics match qiskit's ``u``/``cu3``:

  U3(t, p, l) = [[cos(t/2),            -e^{il} sin(t/2)],
                 [e^{ip} sin(t/2),  e^{i(p+l)} cos(t/2)]]

States are stacked float32 re/im planes ``[P, 2, 2^n]``; basis index ``i``
holds qubit ``q`` in bit ``q`` (qiskit little-endian).
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.utils.batch_invariant import broadcast_rows

GATE_ID = 0
GATE_ROT = 1
GATE_CTRL = 2
GATE_CROT = 3


def init_states(pop: int, n_qubits: int, device=None) -> torch.Tensor:
    """|0...0> for a population: [P, 2, 2^n] float32."""
    state = torch.zeros((pop, 2, 1 << n_qubits), dtype=torch.float32, device=device)
    state[:, 0, 0] = 1.0
    return state


def u3_entries(angles: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """U3 entries (u00, u01, u10, u11) as (re, im) pairs from ``[..., 3]``
    angles, each entry shaped like ``angles[..., 0]``."""
    theta, phi, lam = angles[..., 0], angles[..., 1], angles[..., 2]
    cos = torch.cos(theta / 2)
    sin = torch.sin(theta / 2)
    pl = phi + lam
    return (
        (cos, torch.zeros_like(cos)),
        (-torch.cos(lam) * sin, -torch.sin(lam) * sin),
        (torch.cos(phi) * sin, torch.sin(phi) * sin),
        (torch.cos(pl) * cos, torch.sin(pl) * cos),
    )


def _apply_slot(state, q, gate_type, control, angles, layer_on, n_qubits):
    """Apply slot ``q`` of one layer to every state of the population.

    ``gate_type``/``control``/``layer_on`` are [P], ``angles`` [P, 3].  ID
    and CTRL slots and masked layers leave the state untouched; CROT acts
    where its (per-individual) control bit is 1.
    """
    has_gate = ((gate_type == GATE_ROT) | (gate_type == GATE_CROT)) & layer_on
    return apply_u3_pairs(
        state, q, u3_entries(angles), has_gate, gate_type == GATE_CROT, control, n_qubits
    )


def apply_u3_pairs(state, q, entries, has_gate, crot, control, n_qubits):
    """One U3 (or CU3) on target qubit ``q`` of each state [K, 2, 2^n], from
    its entries (``u3_entries`` of [K] angle triples): the slot engine's
    per-pair arithmetic, shared with the compacted-gate engine
    (``sim/compact_kernels.py``) so that both round alike.

    ``has_gate`` [K] bool leaves a state untouched where False; where
    ``crot`` [K] is True the gate acts only where bit ``control`` [K] is 1.
    """
    pop = state.shape[0]
    high = 1 << (n_qubits - 1 - q)
    low = 1 << q
    v = state.view(pop, 2, high, 2, low)
    r0, m0 = v[:, 0, :, 0, :], v[:, 1, :, 0, :]
    r1, m1 = v[:, 0, :, 1, :], v[:, 1, :, 1, :]
    shape = (pop, high, low)
    (u00r, u00i), (u01r, u01i), (u10r, u10i), (u11r, u11i) = (
        (broadcast_rows(re, shape), broadcast_rows(im, shape)) for re, im in entries
    )
    n0r = u00r * r0 - u00i * m0 + u01r * r1 - u01i * m1
    n0i = u00r * m0 + u00i * r0 + u01r * m1 + u01i * r1
    n1r = u11r * r1 - u11i * m1 + u10r * r0 - u10i * m0
    n1i = u11r * m1 + u11i * r1 + u10r * m0 + u10i * r0
    new = torch.stack([torch.stack([n0r, n1r], dim=2), torch.stack([n0i, n1i], dim=2)], dim=1)

    # control bit over the (high, low) grid of the bit-q-clear indices; a
    # CROT control is never its own target (genome validity)
    grid = (
        (torch.arange(high, device=state.device)[:, None] << (q + 1))
        | torch.arange(low, device=state.device)[None, :]
    )
    ctrl_bit = (grid[None] >> control.clamp(min=0).long()[:, None, None]) & 1
    active = has_gate[:, None, None] & ((~crot)[:, None, None] | (ctrl_bit == 1))
    return torch.where(active[:, None, :, None, :], new, v).reshape(state.shape)


def simulate_circuits(
    gate_types: torch.Tensor,
    controls: torch.Tensor,
    angles: torch.Tensor,
    layer_mask: torch.Tensor,
    n_qubits: int,
    initial_state: torch.Tensor | None = None,
) -> torch.Tensor:
    """Population-batched simulation: [P, L, n] genomes -> [P, 2, 2^n].

    ``initial_state`` may be a shared ``[2, 2^n]`` start state or a
    per-individual ``[P, 2, 2^n]`` batch (the layer-prefix cache).
    """
    pop, n_layers = gate_types.shape[0], gate_types.shape[1]
    if initial_state is None:
        state = init_states(pop, n_qubits, device=angles.device)
    else:
        state = initial_state.to(torch.float32).expand(pop, 2, 1 << n_qubits).clone()
    layer_mask = layer_mask.bool()
    for layer in range(n_layers):
        for q in range(n_qubits):
            state = _apply_slot(
                state, q, gate_types[:, layer, q], controls[:, layer, q],
                angles[:, layer, q], layer_mask[:, layer], n_qubits,
            )
    return state


def probabilities(
    gate_types, controls, angles, layer_mask, n_qubits: int, initial_state=None
) -> torch.Tensor:
    """Measurement probabilities |psi|^2 for a population: [P, 2^n]."""
    states = simulate_circuits(gate_types, controls, angles, layer_mask, n_qubits, initial_state)
    return states[:, 0, :] ** 2 + states[:, 1, :] ** 2


def apply_circuit(
    gate_types, controls, angles, layer_mask, n_qubits: int, initial_state=None
) -> torch.Tensor:
    """One genome ([L, n] tensors) -> complex64 statevector [2^n]."""
    init = None
    if initial_state is not None:
        init = torch.stack([initial_state.real, initial_state.imag]).to(torch.float32)
    state = simulate_circuits(
        gate_types[None], controls[None], angles[None], layer_mask[None], n_qubits, init
    )[0]
    return torch.complex(state[0], state[1])
