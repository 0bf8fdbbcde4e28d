"""Expectation values: plain and CVaR over exact distributions, CVaR over
sampled shots, and the matrix-free expectation of a general Pauli sum
(PyTorch).

Counterpart of ``queasars_tpu/sim/expectation.py``.  The CVaR semantics match
the reference's ``_get_expectation``: sort states ascending by energy,
accumulate probability mass up to ``alpha`` (the boundary state contributes
only the remaining mass), divide by ``alpha``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from queasars_tpu_torch.utils.batch_invariant import row_sum


class PauliTerms(NamedTuple):
    """A Pauli sum's terms for :func:`general_pauli_expectation_real`:
    float32 ``coeffs_re`` / ``coeffs_im`` [K] on the device and the K
    integer Z / X masks as host ints (n <= 32)."""

    coeffs_re: torch.Tensor
    coeffs_im: torch.Tensor
    z_masks: tuple
    x_masks: tuple


def pauli_terms(operator, device="cpu") -> PauliTerms:
    """The :class:`PauliTerms` of a :class:`~queasars_tpu_torch.paulis.
    PauliSum` on ``device`` (its first mask word: n <= 32 for the masks'
    host ints to hold every qubit the term scan reads)."""
    return PauliTerms(
        torch.as_tensor(operator.coeffs.real.astype("float32"), device=device),
        torch.as_tensor(operator.coeffs.imag.astype("float32"), device=device),
        tuple(int(v) for v in operator.z[:, 0]),
        tuple(int(v) for v in operator.x[:, 0]),
    )


class DenseHermitian(NamedTuple):
    """A Hermitian operator's dense matrix as float32 planes [2^n, 2^n]."""

    h_re: torch.Tensor
    h_im: torch.Tensor


def expectation_from_probs(probs: torch.Tensor, energy_table: torch.Tensor) -> torch.Tensor:
    """Plain expectation  <E> = sum_i p_i e_i  over the last axis."""
    return row_sum(probs * energy_table)


def cvar_expectation_from_probs(
    probs: torch.Tensor,
    sorted_energies: torch.Tensor,
    energy_order: torch.Tensor,
    alpha: float,
) -> torch.Tensor:
    """CVaR over the lower-``alpha`` tail of each distribution [..., 2^n].

    ``energy_order`` is the ascending argsort of the energy table and
    ``sorted_energies`` the table in that order.  With ``cum_prev`` the
    exclusive prefix sum of sorted probabilities, each state contributes
    ``clip(alpha - cum_prev, 0, p)`` of its mass.
    """
    p_sorted = probs[..., energy_order]
    cum_prev = torch.cumsum(p_sorted, dim=-1) - p_sorted
    weights = torch.minimum((alpha - cum_prev).clamp(min=0.0), p_sorted)
    return row_sum(weights * sorted_energies) / alpha


def cvar_expectation_from_shot_energies(energies: torch.Tensor, alpha: float) -> torch.Tensor:
    """CVaR over the lower-``alpha`` tail of each shot multiset
    [..., shots]: sort the sampled energies and weight each shot's 1/shots
    mass against the cutoff (the boundary shot contributes only the
    remaining mass).  Equal to :func:`cvar_expectation_from_probs` over the
    counts distribution of the same shots, up to summation order."""
    shots = energies.shape[-1]
    sorted_e = torch.sort(energies, dim=-1).values
    mass = torch.tensor(1.0 / shots, dtype=torch.float32, device=energies.device)
    cum_prev = torch.arange(shots, dtype=torch.float32, device=energies.device) * mass
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=energies.device)
    weights = torch.minimum((alpha_t - cum_prev).clamp(min=0.0), mass)
    return row_sum(weights * sorted_e) / alpha_t


def _parity(v: torch.Tensor) -> torch.Tensor:
    """Bit parity of non-negative int64 values below 2^32 (a bit-fold:
    torch has no popcount)."""
    for shift in (16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def general_pauli_expectation_real(
    states: torch.Tensor,
    coeffs_re: torch.Tensor,
    coeffs_im: torch.Tensor,
    z_masks,
    x_masks,
) -> torch.Tensor:
    """<psi|H|psi> of a Pauli sum, matrix-free, on re/im planes.

    Per term t_k = sum_i conj(psi_i) sign_i psi_{i^x} with sign_i =
    (-1)^{popcount(i & z)}; the result is sum_k cr_k Re(t_k) - ci_k
    Im(t_k), accumulated term by term in float32 as the reference's scan
    does (``general_pauli_expectation_real``, sim/expectation.py:80).

    :param states: [..., 2, 2^n] float32 planes
    :param coeffs_re: [K] float32; ``coeffs_im`` likewise
    :param z_masks: K integer Z masks (host ints, n <= 32); ``x_masks``
        likewise
    :return: [...] float32 energies
    """
    dim = states.shape[-1]
    idx = torch.arange(dim, dtype=torch.int64, device=states.device)
    re, im = states[..., 0, :], states[..., 1, :]
    acc = torch.zeros(states.shape[:-2], dtype=torch.float32, device=states.device)
    for k, (z, x) in enumerate(zip(z_masks, x_masks)):
        signs = 1.0 - 2.0 * _parity(idx & int(z)).to(torch.float32)
        flip = idx ^ int(x)
        fr, fi = re[..., flip], im[..., flip]
        t_re = row_sum(signs * (re * fr + im * fi))
        t_im = row_sum(signs * (re * fi - im * fr))
        acc = acc + coeffs_re[k] * t_re - coeffs_im[k] * t_im
    return acc


def dense_expectation(states: torch.Tensor, operator: DenseHermitian) -> torch.Tensor:
    """<psi|H|psi> [P] of states [P, 2, 2^n] through a dense matvec in real
    pairs (only the real part of a Hermitian expectation is taken).  The
    products are full float32 (TF32 stays off on the card), as the
    reference's ``Precision.HIGHEST`` (``_energies_dense``,
    sim/evaluators.py:103-121)."""
    ar, ai = states[:, 0], states[:, 1]
    h_re_t, h_im_t = operator.h_re.T, operator.h_im.T
    out_re = ar @ h_re_t - ai @ h_im_t
    out_im = ai @ h_re_t + ar @ h_im_t
    return row_sum(ar * out_re + ai * out_im)
