"""The ``jax.random`` functions of the sampler path, in torch integer ops.

Counterpart of the threefry2x32 PRNG the JAX package draws its shots with
(``jax.random`` with ``jax_threefry_partitionable=True``, the default of
jax 0.9): :func:`PRNGKey`, :func:`fold_in`, :func:`split` and float32
:func:`uniform`.  They give the reference's keys and uniforms bit for bit,
so the port samples the same shots as the JAX package from the same seed.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words.  torch's
``uint32`` lacks arithmetic on some devices and a right shift of ``int32``
is arithmetic, so every word is computed in int64 and masked with
``& 0xFFFFFFFF``.  Each function returns tensors on the device of the key
it was given; no ``torch.Generator`` is involved.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of count words ``x0``, ``x1`` under
    key words ``k0``, ``k1``; every argument is an int64 tensor of uint32
    values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:  # noqa: N802 (jax.random's name)
    """The key of an integer seed in [0, 2^63): ``[0, seed mod 2^32]``, as
    ``jax.random.PRNGKey`` makes it with 64-bit types off (the JAX
    package's setting), which keeps a seed's low 32 bits only."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError("seed must lie in [0, 2^63)")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _words(key: torch.Tensor):
    if key.dtype != torch.int64 or key.shape[-1] != 2:
        raise ValueError("a key is an int64 tensor [..., 2]")
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """The key ``key`` [..., 2] with the uint32 ``data`` folded in."""
    k0, k1 = _words(key)
    zero = torch.zeros_like(k0)
    x0, x1 = threefry2x32(k0, k1, zero, zero + (int(data) & MASK))
    return torch.stack([x0, x1], dim=-1)


def _counts(shape, like: torch.Tensor):
    """The row-major flat index over ``shape`` as (high, low) words."""
    n = 1
    for d in shape:
        n *= int(d)
    flat = torch.arange(n, dtype=torch.int64, device=like.device).reshape(tuple(shape))
    return flat >> 32, flat & MASK


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    """Per key [..., 2], the words over ``shape`` ([..., *shape])."""
    k0, k1 = _words(key)
    hi, lo = _counts(shape, key)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(k0[expand], k1[expand], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key`` [..., 2]: [..., num, 2]."""
    b0, b1 = _bits(key, (num,))
    return torch.stack([b0, b1], dim=-1)


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval) of ``shape`` per key [..., 2]:
    the top 23 bits of each 32-bit word as the mantissa of a float in
    [1, 2), minus 1, then ``jax.random.uniform``'s scaling and clamp,
    ``max(minval, u * (maxval - minval) + minval)`` in float32 (it leaves
    [0, 1) draws as they are).  ``minval`` / ``maxval`` may be tensors with
    one value per key, which sets the result's device."""
    b0, b1 = _bits(key, tuple(shape))
    mantissa = ((b0 ^ b1) >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    if not isinstance(minval, torch.Tensor) and not isinstance(maxval, torch.Tensor) \
            and float(minval) == 0.0 and float(maxval) == 1.0:
        return floats
    bounds = [torch.as_tensor(v, dtype=torch.float32) for v in (minval, maxval)]
    device = next((b.device for b in bounds if b.device.type != "cpu"), floats.device)
    expand = (...,) + (None,) * len(tuple(shape))
    lo, hi = (b.to(device)[expand] if b.dim() else b.to(device) for b in bounds)
    return torch.maximum(lo, floats.to(device) * (hi - lo) + lo)
