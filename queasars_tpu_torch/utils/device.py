"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  With no card and no explicit
``"cpu"`` they raise: the port never falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as
    given (``"cpu"``, ``"cuda"``, ``"cuda:1"``, a ``torch.device``)."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return resolved
