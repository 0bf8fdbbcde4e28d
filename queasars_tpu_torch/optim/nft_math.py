"""The NFT sinusoid-fit update — single source of truth for the port.

Counterpart of ``queasars_tpu/optim/nft_math.py``.  The CUDA sweep kernels
(``sweep_update`` in ``csrc/slot_kernels.cu`` and ``csrc/fold_kernels.cu``)
restate the same expressions; the plain sweeps of both kernel families
step through :func:`layer_sweep_plain`.

Math (arXiv:1903.12166, matching qiskit's ``nakanishi_fujii_todo``): the
objective is an exact sinusoid in each U3 angle,
``f(theta) = c + a*cos(theta - b)``, so from ``z0 = f(x)``,
``z1 = f(x + pi/2)``, ``z3 = f(x - pi/2)``:

- ``c = (z1 + z3) / 2``
- ``b = x + atan2((z1 - z3)/2, z0 - c)``
- the minimum sits at ``b + pi`` with value ``c - a`` where
  ``a = sqrt((z0 - c)^2 + ((z1 - z3)/2)^2)``.
"""

from __future__ import annotations

import math

import torch


def nft_three_point_update(z0, z1, z3):
    """The 3-point sinusoid fit on tensors.

    :return: ``(shift, minimum_value)`` — add ``shift + pi`` to the current
        angle to land on the fitted minimum, whose fitted value is
        ``minimum_value`` (recycled as the next step's ``z0``)
    """
    mid = (z1 + z3) / 2
    d, e = z0 - mid, (z1 - z3) / 2
    shift = torch.atan2(e, d)
    minimum_value = mid - torch.sqrt(d * d + e * e)
    return shift, minimum_value


def layer_sweep_plain(energy, angles, coords, n_free, active, maxiter, reset_interval):
    """The last-layer NFT sweep's step rule in plain PyTorch: ``energy``
    maps layer angles [P, n, 3] to energies [P]; step k probes coordinate
    ``k mod n_free`` of every individual at +-pi/2 and moves the active ones
    to the fitted minimum; z0 is re-measured every ``reset_interval`` steps.

    :param coords: [P, K, 2] (qubit, angle) per free coordinate
    :return: (layer angles [P, n, 3], final energies [P])
    """
    pop = angles.shape[0]
    current = angles.clone()
    z = energy(current)
    apply = active.bool() & (n_free > 0)
    rows = torch.arange(pop, device=angles.device)
    for k in range(maxiter):
        if k > 0 and k % reset_interval == 0:
            z = energy(current)
        idx = torch.remainder(torch.full_like(n_free, k), n_free.clamp(min=1)).long()
        q = coords[rows, idx, 0].long()
        a = coords[rows, idx, 1].long()
        theta = current[rows, q, a]
        plus = current.clone()
        plus[rows, q, a] = theta + math.pi / 2
        minus = current.clone()
        minus[rows, q, a] = theta - math.pi / 2
        shift, minimum_value = nft_three_point_update(z, energy(plus), energy(minus))
        current[rows, q, a] = torch.where(apply, theta + shift + math.pi, theta)
        z = torch.where(apply, minimum_value, z)
    return current, z
