"""Expectation values over exact distributions: plain and CVaR (PyTorch).

Counterpart of the exact forms of ``queasars_tpu/sim/expectation.py``.  The
CVaR semantics match the reference's ``_get_expectation``: sort states
ascending by energy, accumulate probability mass up to ``alpha`` (the
boundary state contributes only the remaining mass), divide by ``alpha``.
"""

from __future__ import annotations

import torch


def expectation_from_probs(probs: torch.Tensor, energy_table: torch.Tensor) -> torch.Tensor:
    """Plain expectation  <E> = sum_i p_i e_i  over the last axis."""
    return (probs * energy_table).sum(dim=-1)


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
    return (weights * sorted_energies).sum(dim=-1) / alpha
