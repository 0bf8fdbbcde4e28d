"""Arithmetic whose value for one row does not depend on the batch it is
computed in, inside :func:`scope`.

A population mesh (``parallel/mesh.py``) computes each individual in a block
of another size than the whole population, and its contract is that a
seeded solve gives the same bits on any number of blocks.  Some torch
kernels break that:

- on the CPU, some transcendental functions (``atan2`` among them) run
  vector code over whole chunks of a tensor and scalar code over the
  remainder, and the two round differently, so an element's value depends
  on where it falls in the tensor (:func:`atan2`);
- on a card, a row reduction picks its thread layout from the whole shape,
  the number of rows included, and with it each row's summation order
  (:func:`row_sum`, :func:`row_mean`, :func:`broadcast_rows` for the
  reductions autograd makes, and :func:`combine` for a small product whose
  GEMM may do the same).

Each function here is its plain torch counterpart outside :func:`scope`,
so the unsharded paths compute exactly as before; the mesh's blocks and
ADAPT-VQE's pool screen (which its sharded form must equal) run inside it.
The CPU's row reductions sum each row alone below torch's parallel grain
(2^15 elements per call), which covers the sizes the port's tests run;
there they stay ``torch.sum``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

#: the CPU operands are padded to a multiple of this many elements, a whole
#: number of the vector loop's chunks for every vector width torch uses
_CHUNK = 64
#: and computed in slices no longer than this, below the size at which
#: torch splits an elementwise loop over threads at other offsets
_SLICE = 16384
#: a card's fixed-order row reductions sum this many neighbours per level:
#: a 32-wide reduction is one warp per output whatever the number of rows
_FAN = 32

_ACTIVE = contextvars.ContextVar("batch_invariant", default=False)


@contextlib.contextmanager
def scope():
    """Compute every function of this module in its batch-invariant form."""
    token = _ACTIVE.set(True)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    return _ACTIVE.get()


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``torch.atan2(y, x)``; in :func:`scope` on the CPU every element
    takes the vector code, whatever the operands' size."""
    if y.device.type != "cpu" or not active():
        return torch.atan2(y, x)
    shape = torch.broadcast_shapes(y.shape, x.shape)
    flat_y = y.expand(shape).reshape(-1)
    flat_x = x.expand(shape).reshape(-1)
    count = flat_y.numel()
    pad = -count % _CHUNK
    if pad:
        flat_y = torch.cat([flat_y, flat_y.new_zeros(pad)])
        flat_x = torch.cat([flat_x, flat_x.new_ones(pad)])
    out = torch.cat([
        torch.atan2(flat_y[start:start + _SLICE], flat_x[start:start + _SLICE])
        for start in range(0, flat_y.numel(), _SLICE)
    ])
    return out[:count].reshape(shape)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and active()


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)``; in :func:`scope` on a card in levels of 32-value sums
    (zero-padded), whose order does not depend on the number of rows."""
    if not _on_card(x):
        return x.sum(dim=-1)
    while x.shape[-1] > _FAN:
        pad = -x.shape[-1] % _FAN
        if pad:
            x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
        x = x.unflatten(-1, (-1, _FAN)).sum(dim=-1)
    return x.sum(dim=-1)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(-1)``; in :func:`scope` on a card :func:`row_sum` over the
    row length."""
    if not _on_card(x):
        return x.mean(dim=-1)
    return row_sum(x) / x.shape[-1]


class _BroadcastRows(torch.autograd.Function):
    """``x`` [P] expanded to [P, *rest]; its gradient summed per row by
    :func:`row_sum` instead of autograd's own broadcast reduction."""

    @staticmethod
    def forward(ctx, x, shape):
        return x.reshape(x.shape[0], *([1] * (len(shape) - 1))).expand(shape)

    @staticmethod
    def backward(ctx, grad):
        with scope():
            return row_sum(grad.reshape(grad.shape[0], -1)), None


def broadcast_rows(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` [P] shaped to broadcast against ``shape`` [P, ...] (the values
    of ``x[:, None, ...]``); in :func:`scope` on a card under autograd,
    expanded to ``shape`` with a gradient that reduces each row in
    :func:`row_sum`'s order."""
    if _on_card(x) and x.requires_grad and torch.is_grad_enabled():
        return _BroadcastRows.apply(x, tuple(shape))
    return x.reshape(x.shape[0], *([1] * (len(shape) - 1)))


def combine(matrix: torch.Tensor, rows: list) -> torch.Tensor:
    """``matrix @ torch.stack(rows)`` ([M, K] by K rows [P]); in
    :func:`scope` on a card as elementwise products summed in row order."""
    if not _on_card(rows[0]):
        return matrix @ torch.stack(rows)
    out = matrix[:, 0, None] * rows[0]
    for k in range(1, len(rows)):
        out = out + matrix[:, k, None] * rows[k]
    return out
