"""Population objectives for the batched optimizers.

Counterpart of ``queasars_tpu/optim/objective.py``: "angles -> energies" for
a population, exact or from sampled shots, on the route ``sim/routes.py``
picks (the kron-fold kernels by default, the slot kernels under
``QUEASARS_MXU=0`` or at a size or device the fold kernels do not take):
energies, probabilities for exact CVaR, or sampled shots.

With shots (``use_shots``), each individual draws ``shots`` uniforms from
its own threefry key (``keys`` [P, 2], ``utils/prng.py``); in the in-kernel
samplers' size range (``routes.sampler_route``) they go to the sampled
kernel, elsewhere the probabilities kernel and the flat sampler
(``sim/sampling.py``) draw the same shots.  The sampled states' energies are
gathered from the table and reduced to a mean or, with ``use_cvar``, a CVaR
over the shots.

A general (non-diagonal) operator (``use_general``) takes the reference's
general branches: with shots, QWC grouped measurement
(``sim/grouped_sampling.py``: on the in-kernel samplers, or the flat sampler
outside their sizes); exact, the slot states kernel and then a dense
Hermitian matvec (n <= 12, no mesh) or the matrix-free term scan.
:func:`population_probs` also gives the solve's final measurement
distribution.
"""

from __future__ import annotations

import torch

from queasars_tpu_torch.sim import grouped_sampling, routes
from queasars_tpu_torch.sim.expectation import (
    DenseHermitian,
    cvar_expectation_from_probs,
    cvar_expectation_from_shot_energies,
    dense_expectation,
    general_pauli_expectation_real,
)
from queasars_tpu_torch.sim.sampling import sample_indices
from queasars_tpu_torch.utils.batch_invariant import row_mean
from queasars_tpu_torch.utils.profiling import spanned


@spanned("evaluator.population_probs")
def population_probs(
    gate_types, controls, angles, layer_mask, *, n_qubits: int, initial_state=None, use_mxu=None
) -> torch.Tensor:
    """Measurement probabilities [P, 2^n] on the route ``use_mxu`` picks
    (None: ``routes.fold_enabled`` decides)."""
    return routes.probs(
        gate_types, controls, angles, layer_mask, n_qubits, initial_state, use_mxu=use_mxu
    )


def population_shot_indices(
    gate_types, controls, angles, layer_mask, keys, *, n_qubits: int, shots: int,
    initial_state=None, use_mxu=None,
) -> torch.Tensor:
    """Sampled basis indices [P, shots] of each individual's circuit, drawn
    with its key (``keys`` [P, 2]): the in-kernel sampler
    ``routes.sampler_route`` names, else the probabilities kernel and the
    flat sampler.  The draws are the reference's in every branch
    (``u = uniform * total``)."""
    fold = routes.sampler_route(use_mxu, n_qubits, angles.device)
    if fold is not None:
        return routes.shot_indices(
            gate_types, controls, angles, layer_mask, keys, n_qubits, shots, initial_state,
            fold=fold,
        )
    probs = population_probs(
        gate_types, controls, angles, layer_mask, n_qubits=n_qubits,
        initial_state=initial_state, use_mxu=use_mxu,
    )
    return sample_indices(keys, probs, shots)


@spanned("evaluator.population_energies")
def population_energies(
    gate_types,
    controls,
    angles,
    layer_mask,
    table,
    sorted_energies,
    energy_order,
    alpha,
    keys=None,
    *,
    n_qubits: int,
    use_cvar: bool,
    shots: int = 0,
    use_shots: bool = False,
    initial_state=None,
    use_mxu=None,
    use_general: bool = False,
) -> torch.Tensor:
    """Energies [P] for the population at the given angle tensor;
    ``initial_state`` is None (|0...0>) or per-individual [P, 2, 2^n].
    The operands are :func:`objective_operands`' fields; ``keys`` [P, 2]
    are the individuals' PRNG keys, read only with ``use_shots``;
    ``use_mxu`` picks the route (None: ``routes.fold_enabled`` decides).
    With ``use_general``, ``table`` is a general operator's operands:
    :class:`~queasars_tpu_torch.sim.grouped_sampling.GroupedOperands` with
    shots (``shots`` an int or a per-group tuple), else a
    :class:`~queasars_tpu_torch.sim.expectation.DenseHermitian` or
    :class:`~queasars_tpu_torch.sim.expectation.PauliTerms`."""
    if use_general:
        return _general_energies(
            gate_types, controls, angles, layer_mask, table, keys, n_qubits=n_qubits,
            shots=shots, use_shots=use_shots, initial_state=initial_state, use_mxu=use_mxu,
        )
    if use_shots:
        idx = population_shot_indices(
            gate_types, controls, angles, layer_mask, keys, n_qubits=n_qubits, shots=shots,
            initial_state=initial_state, use_mxu=use_mxu,
        )
        shot_energies = table[idx.long()]
        if use_cvar:
            return cvar_expectation_from_shot_energies(shot_energies, alpha)
        return row_mean(shot_energies)
    if use_cvar:
        probs = population_probs(
            gate_types, controls, angles, layer_mask, n_qubits=n_qubits,
            initial_state=initial_state, use_mxu=use_mxu,
        )
        return cvar_expectation_from_probs(probs, sorted_energies, energy_order, alpha)
    return routes.energies(
        gate_types, controls, angles, layer_mask, table, n_qubits, initial_state, use_mxu=use_mxu
    )


def _general_energies(
    gate_types, controls, angles, layer_mask, table, keys, *, n_qubits, shots, use_shots,
    initial_state, use_mxu,
):
    """The general-operator branches of :func:`population_energies`, chosen
    as the reference's are: grouped shots on the in-kernel sampler
    ``routes.sampler_route`` names, else simulate once and sample each group
    with the flat sampler; exact energies from the slot states kernel's
    states."""
    if use_shots:
        kwargs = dict(n_qubits=n_qubits, shots=shots, initial_state=initial_state)
        fold = routes.sampler_route(use_mxu, n_qubits, angles.device)
        if fold is not None:
            return grouped_sampling.grouped_shot_energies_kernels(
                gate_types, controls, angles, layer_mask, keys, table, fold=fold, **kwargs
            )
        return grouped_sampling.grouped_shot_energies(
            gate_types, controls, angles, layer_mask, keys, table, **kwargs
        )
    states = routes.states(
        gate_types, controls, angles, layer_mask, n_qubits, initial_state, fold=False
    )
    if isinstance(table, DenseHermitian):
        return dense_expectation(states, table)
    return general_pauli_expectation_real(states, *table)


def objective_operands(evaluator) -> dict:
    """The operands of an evaluator's objective, as keyword arguments of
    :func:`population_energies` (TypeError for unsupported evaluators).
    An estimator with ``precision > 0`` hands over its inner sampler's; a
    general operator hands over its grouped-measurement operands (sampler)
    or its dense matrix (n <= 12; Pauli terms under a mesh) or Pauli terms
    (estimator)."""
    from queasars_tpu_torch.sim.evaluators import (
        SamplerExpectationEvaluator,
        StatevectorExpectationEvaluator,
    )

    if isinstance(evaluator, StatevectorExpectationEvaluator):
        if evaluator._precision_sampler is not None:
            return objective_operands(evaluator._precision_sampler)
        if not evaluator._diagonal:
            # under a mesh, the term scan: the dense matvec's GEMM need not
            # round alike at every batch size, which would break the
            # trajectory identity across block counts (parallel/mesh.py)
            general = evaluator._general if evaluator.mesh is None else evaluator.general_terms()
            return dict(
                table=general, sorted_energies=None, energy_order=None, alpha=1.0,
                use_cvar=False, shots=0, use_shots=False, use_general=True,
            )
        shots, use_shots = 0, False
    elif isinstance(evaluator, SamplerExpectationEvaluator):
        if not evaluator._diagonal:
            group_shots = evaluator._group_shots
            return dict(
                table=evaluator._grouped, sorted_energies=None, energy_order=None, alpha=1.0,
                use_cvar=False, shots=evaluator.shots if group_shots is None else group_shots,
                use_shots=True, use_general=True,
            )
        shots, use_shots = evaluator.shots, True
    else:
        raise TypeError(f"unsupported evaluator type for batched optimization: {type(evaluator)!r}")
    return dict(
        table=evaluator._table,
        sorted_energies=evaluator._sorted,
        energy_order=evaluator._order,
        alpha=evaluator.alpha,
        use_cvar=evaluator.alpha < 1.0,
        shots=shots,
        use_shots=use_shots,
        use_general=False,
    )
