"""Measurement shot sampling (PyTorch).

Counterpart of ``queasars_tpu/sim/sampling.py``: inverse-CDF sampling of
basis states from probability vectors with the reference's threefry
uniforms (``utils/prng.py``), so equal keys draw equal shots.  The flat
sampler is a running sum then ``torch.searchsorted``, as the reference
leaves it to XLA; the running sum (:func:`running_sum`) adds in the order
XLA's CPU backend does, so the port draws the JAX package's shots on the
CPU draw for draw, boundary draws included.

Also the plain version of the sampled kernels' epilogue,
:func:`hierarchical_sample_plain`: the same three-level inverse CDF the
in-kernel samplers run (``queasars_tpu/sim/pallas_kernels.py::
_sample_shots_from_probs``), in the summation order of the CUDA epilogue
(``csrc/sampler.cuh``), so the kernel and its plain version agree bit for
bit on equal probabilities.
"""

from __future__ import annotations

import numpy as np
import torch

from queasars_tpu_torch.utils import prng

#: lanes of a row and rows of a block in the hierarchical sampler
LANES = 128
#: chunk length of the two-level scan XLA's CPU backend turns a cumsum into
SCAN_CHUNK = 16


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 running sum along the last axis, one add after
    the other (``torch.cumsum`` accumulates float32 in float64 on the CPU,
    which rounds otherwise)."""
    out = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., j])
    return torch.stack(out, dim=-1)


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along the last axis in XLA's CPU order: up to
    16 values one after the other; longer axes in chunks of 16, each
    chunk's running sum plus the running sum of the chunk totals before
    it (recursively)."""
    length = x.shape[-1]
    if length <= SCAN_CHUNK:
        return _sequential_scan(x)
    pad = -length % SCAN_CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
    chunks = _sequential_scan(x.unflatten(-1, (-1, SCAN_CHUNK)))
    before = running_sum(chunks[..., -1])
    carry = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]], dim=-1)
    return (chunks + carry[..., None]).flatten(-2)[..., :length]


def sample_indices(keys: torch.Tensor, probs: torch.Tensor, shots: int) -> torch.Tensor:
    """Draw ``shots`` basis-state indices from ``probs`` [..., 2^n] with
    the keys [..., 2]: ``u = uniform * cdf[-1]``, the right-hand
    ``searchsorted`` of u in the running sum, clipped (int64 [..., shots])."""
    cdf = running_sum(probs)
    u = prng.uniform(keys, (shots,)).to(cdf.device) * cdf[..., -1:]
    samples = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    return samples.clamp(0, probs.shape[-1] - 1)


def sample_counts(keys: torch.Tensor, probs: torch.Tensor, shots: int) -> torch.Tensor:
    """Integer counts [..., 2^n] of ``shots`` draws (the stream of
    :func:`sample_indices`)."""
    samples = sample_indices(keys, probs, shots)
    counts = torch.zeros(probs.shape, dtype=torch.int64, device=probs.device)
    return counts.scatter_add_(-1, samples, torch.ones_like(samples))


def empirical_probs(keys: torch.Tensor, probs: torch.Tensor, shots: int) -> torch.Tensor:
    """Shot-noise distribution: counts / shots as float32 [..., 2^n],
    computed as counts times the float32 reciprocal of ``shots``, the
    reference's compiled arithmetic."""
    reciprocal = torch.tensor(1.0 / shots, dtype=torch.float32, device=probs.device)
    return sample_counts(keys, probs, shots).to(torch.float32) * reciprocal


def quasi_distribution(probs: np.ndarray, atol: float = 1e-12) -> dict[int, float]:
    """Dense probabilities -> sparse {basis_state: probability} dict (the
    reference's QuasiDistribution result surface)."""
    probs = np.asarray(probs)
    (nonzero,) = np.nonzero(probs > atol)
    return {int(i): float(probs[i]) for i in nonzero}


# ---------------------------------------------------------------------------
# the hierarchical inverse CDF of the sampled kernels
# ---------------------------------------------------------------------------


def _scan(x: torch.Tensor, width: int) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in log steps (position i
    adds position i - d for d = 1, 2, 4, ... < width), the order of the
    kernels' scans."""
    d = 1
    while d < width:
        x = torch.cat([x[..., :d], x[..., d:] + x[..., :-d]], dim=-1)
        d *= 2
    return x


def _row_sums(probs: torch.Tensor) -> torch.Tensor:
    """Sum of each 128-lane row [..., R, 128] -> [..., R], in the order of
    one warp: lane l adds its four values l, l+32, l+64, l+96 pairwise,
    then the lanes halve 16, 8, 4, 2, 1 (shuffle-down tree)."""
    v = probs.unflatten(-1, (4, 32))
    x = (v[..., 0, :] + v[..., 1, :]) + (v[..., 2, :] + v[..., 3, :])
    width = 32
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:2 * width]
    return x[..., 0]


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) by halving."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _level(prefix: torch.Tensor, u: torch.Tensor, cap: int):
    """One level of the search: (count of prefix values <= u, clamped to
    ``cap``; u minus the largest such value, or minus 0)."""
    below = prefix <= u[..., None]
    index = below.sum(dim=-1).clamp(max=cap)
    base = torch.where(below, prefix, torch.zeros_like(prefix)).amax(dim=-1)
    return index, u - base


def hierarchical_sample_plain(probs: torch.Tensor, u_frac: torch.Tensor) -> torch.Tensor:
    """Sampled indices int32 [P, S] of probabilities [P, 2^n] (n >= 14) at
    the uniforms ``u_frac`` [P, S] in [0, 1).

    The index space is B blocks x 128 rows x 128 lanes.  Row masses,
    in-block row prefixes, block totals (the largest row prefix), the block
    prefix ``cb`` and the total (block totals summed by halving) come
    first; then per shot ``u = frac * total`` is resolved level by level
    (block, row, lane) as a right-hand search with subtract-then-compare
    and clamps, as ``_sample_shots_from_probs`` does.
    """
    pop, dim = probs.shape
    rows = dim // LANES
    n_blocks = rows // LANES
    if n_blocks < 1 or rows * LANES != dim:
        raise ValueError("the hierarchical sampler needs 2^n probabilities with n >= 14")
    planes = probs.reshape(pop, rows, LANES)
    row_prefix = _scan(_row_sums(planes).reshape(pop, n_blocks, LANES), LANES)
    block_tot = row_prefix.amax(dim=-1)
    cb = _scan(block_tot, n_blocks)
    total = _halving_sum(block_tot)
    u = u_frac * total[:, None]
    block, u1 = _level(cb[:, None, :], u, n_blocks - 1)
    p_idx = torch.arange(pop, device=probs.device)[:, None]
    row, u2 = _level(row_prefix[p_idx, block], u1, LANES - 1)
    global_row = block * LANES + row
    lane, _ = _level(_scan(planes[p_idx, global_row], LANES), u2, LANES - 1)
    return (global_row * LANES + lane).to(torch.int32)
