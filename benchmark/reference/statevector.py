"""A plain statevector simulator of EVQE genome circuits.

A circuit is plain data, as the benchmark serialises a genome:
``{"n_qubits": n, "layers": [[[gate, control], ...one per qubit], ...],
"angles": [[[theta, phi, lambda] or None, ...one per qubit], ...]}`` with
``gate`` one of ``"id"``, ``"u3"``, ``"ctrl"`` (the control half of a
controlled rotation) and ``"cu3"`` (the rotation half, whose ``control`` is
its control qubit).  Within one layer every gate acts on its own qubit and
no control qubit is the target of another gate, so the gates of a layer
commute.

``U3(t, p, l) = [[cos(t/2), -e^{il} sin(t/2)], [e^{ip} sin(t/2),
e^{i(p+l)} cos(t/2)]]``; a CU3 applies it where its control bit is 1.
Basis state ``x`` holds qubit ``q`` in bit ``q``.  The state is a pair of
real planes (real, imaginary) in one dtype, so the same code runs in
float64 and, for the control, in bfloat16.
"""

from __future__ import annotations

import math

import torch


def _u3(theta: float, phi: float, lam: float) -> list[tuple[float, float]]:
    """U3's entries u00, u01, u10, u11 as (re, im), in float64."""
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return [
        (c, 0.0),
        (-math.cos(lam) * s, -math.sin(lam) * s),
        (math.cos(phi) * s, math.sin(phi) * s),
        (math.cos(phi + lam) * c, math.sin(phi + lam) * c),
    ]


def _apply(re, im, n, q, entries, control):
    """One U3 on qubit ``q`` (where bit ``control`` is 1, if given)."""
    shape = (1 << (n - q - 1), 2, 1 << q)
    re, im = re.view(shape), im.view(shape)
    (a_re, a_im), (b_re, b_im) = (re[:, 0], im[:, 0]), (re[:, 1], im[:, 1])
    (u00, u01, u10, u11) = entries

    def mul_add(x, y):
        (x_re, x_im), (y_re, y_im) = x, y
        return (x_re * a_re - x_im * a_im + y_re * b_re - y_im * b_im,
                x_re * a_im + x_im * a_re + y_re * b_im + y_im * b_re)

    new0, new1 = mul_add(u00, u01), mul_add(u10, u11)
    if control is not None:
        index = torch.arange(1 << n, device=re.device).view(shape)[:, 0]
        on = ((index >> control) & 1).bool()
        new0 = (torch.where(on, new0[0], a_re), torch.where(on, new0[1], a_im))
        new1 = (torch.where(on, new1[0], b_re), torch.where(on, new1[1], b_im))
    out_re = torch.stack([new0[0], new1[0]], dim=1).reshape(-1)
    out_im = torch.stack([new0[1], new1[1]], dim=1).reshape(-1)
    return out_re, out_im


def final_state(circuit: dict, *, dtype=torch.float64, device="cpu", initial=None):
    """(re, im) planes [2^n] after the circuit, from |0...0> or from
    ``initial`` (re, im)."""
    n = circuit["n_qubits"]
    if initial is None:
        re = torch.zeros(1 << n, dtype=dtype, device=device)
        im = torch.zeros_like(re)
        re[0] = 1.0
    else:
        re, im = (t.to(dtype=dtype, device=device) for t in initial)
    for gates, angles in zip(circuit["layers"], circuit["angles"]):
        for q, (gate, control) in enumerate(gates):
            if gate not in ("u3", "cu3"):
                continue
            entries = [(torch.tensor(x, dtype=dtype).item(), torch.tensor(y, dtype=dtype).item())
                       for x, y in _u3(*angles[q])]
            re, im = _apply(re, im, n, q, entries, control if gate == "cu3" else None)
    return re, im


def probabilities(circuit: dict, *, dtype=torch.float64, device="cpu") -> torch.Tensor:
    re, im = final_state(circuit, dtype=dtype, device=device)
    return re * re + im * im


def energy(probs: torch.Tensor, table: torch.Tensor) -> float:
    """``sum_x p(x) table(x)`` in the dtype of the operands."""
    return float((probs * table.to(probs.dtype)).sum())
