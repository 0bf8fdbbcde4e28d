"""The NFT sinusoid-fit update — single source of truth for the port.

Counterpart of ``queasars_tpu/optim/nft_math.py``.  The CUDA sweep kernel
(``csrc/slot_kernels.cu``, ``sweep_update``) and the plain sweep
(``sim/slot_kernels.nft_layer_sweep_plain``) restate the same expressions.

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
