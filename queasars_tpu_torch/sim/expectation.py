"""Expectation values: plain and CVaR over exact distributions, and CVaR
over sampled shots (PyTorch).

Counterpart of the diagonal forms of ``queasars_tpu/sim/expectation.py``.  The
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
    return (weights * sorted_e).sum(dim=-1) / alpha_t
