"""Amplitude-sharded population evaluator: EVQE past one device's memory.

Counterpart of ``queasars_tpu/sim/sharded_evaluator.py``.  Each individual's
statevector is split over the amplitude axis of a (pop, amp) mesh
(``parallel/amplitude.py``), the population over its rows, and the
evaluator keeps the ``evaluate_packed`` contract of the single-device
evaluators, so the whole solver stack runs on top.  It also owns the device
NFT sweeps (:meth:`AmplitudeShardedExpectationEvaluator.nft_minimize`,
:meth:`~AmplitudeShardedExpectationEvaluator.nft_minimize_slots`), which
``optim/nft.py`` hands the exact optimization to.

Every path is bit-identical across the (pop, amp) factorizations of a mesh:
energies reduce in the fixed tree (``AmpRow.tree_sum``), shots draw through
the blocked inverse CDF over fixed global-index blocks
(``sharded_statevector.blocked_shot_positions``), the population pads to
``lcm(n_pop, POPULATION_PAD)`` whatever the width, and each row runs inside
``utils/batch_invariant.scope``.

- The diagonal table is built shard by shard from the O(K) term data
  (``build_device_table``); ``table_mode="host"`` builds it on the host in
  float64 and ships each cell its shard.
- Exact energies take the fold route (``sim/sharded_fold.py``) for a
  diagonal operator where ``routes.shard_fold`` says (n >= 10 unless
  ``QUEASARS_SHARD_FOLD=0`` or ``use_fold=False``), else the per-gate route
  (``sharded_statevector.simulate_local``).
- Exact CVaR bisects the alpha-quantile energy level on the cumulative mass
  (one fixed-tree sum per step), with no sort and no gather of 2^n values.
- Shots (and ``precision``, as ceil(precision^-2) shots) sample through the
  blocked sampler; CVaR over the shot multiset.
- A general operator: exact energies by cross-shard X flips (one exchange
  per distinct global X mask, terms in order), shots by QWC groups, each
  group's rotation layer on the per-gate route and its shard-local table.
- An initial state (array or :class:`EVQEIndividual`) is prepared once as
  shards and every simulation re-enters it.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from queasars_tpu_torch.genome.individual import EVQEIndividual
from queasars_tpu_torch.genome.packing import PackedPopulation
from queasars_tpu_torch.optim.nft import _nft_steps
from queasars_tpu_torch.optim.nft_math import nft_three_point_update
from queasars_tpu_torch.parallel.amplitude import (
    AmpRow,
    amplitude_mesh,
    as_amplitude_mesh,
    as_pop_amp_mesh,
    pop_amp_mesh,
    run_rows,
)
from queasars_tpu_torch.paulis import PauliSum
from queasars_tpu_torch.paulis.diagonal import diagonal_energy_table, diagonal_terms
from queasars_tpu_torch.sim.evaluators import (
    BaseCircuitEvaluator,
    CircuitEvaluatorException,
    _prepare_initial_state,
    packed_tensors,
)
from queasars_tpu_torch.sim import routes
from queasars_tpu_torch.sim.expectation import cvar_expectation_from_shot_energies
from queasars_tpu_torch.sim.shard_kernels import _amp_bit
from queasars_tpu_torch.sim.sharded_fold import check_folded_bits, default_folded_bits
from queasars_tpu_torch.sim.sharded_fold import simulate_local_folded
from queasars_tpu_torch.sim.sharded_statevector import (
    AmpSharded,
    blocked_shot_positions,
    blockwise_energy,
    build_device_table,
    build_device_tables_batch,
    group_general_terms,
    general_energies,
    place_sharded,
    shard_probs,
    shot_values,
    simulate_local,
)
from queasars_tpu_torch.utils import prng
from queasars_tpu_torch.utils.batch_invariant import row_mean

__all__ = [
    "AmplitudeShardedExpectationEvaluator",
    "amplitude_mesh",
    "as_amplitude_mesh",
    "as_pop_amp_mesh",
    "pop_amp_mesh",
]


class AmplitudeShardedExpectationEvaluator(BaseCircuitEvaluator):
    """Expectation evaluator with each statevector sharded across a mesh.

    :param operator: any PauliSum; CVaR (alpha < 1) needs a diagonal one
    :param mesh: a :class:`~queasars_tpu_torch.parallel.amplitude.PopAmpMesh`
        (used as is) or a population mesh (factored per ``amp_devices``)
    :param alpha: CVaR lower-tail mass in (0, 1]
    :param shots: finite measurement shots (None: exact distributions)
    :param seed: seed of the shot stream
    :param precision: target standard error, realized as
        ``ceil(precision**-2)`` shots; exclusive with ``shots``
    :param initial_state: a [2^n] complex / [2, 2^n] real start state or an
        :class:`EVQEIndividual` preparing it; prepared once, sharded
    :param amp_devices: cells per amplitude row when ``mesh`` is a
        population mesh (None: all of them)
    :param table_mode: ``"device"`` (shard-local float32 term scan) or
        ``"host"`` (float64 on the host, each cell its shard)
    :param use_fold: route diagonal-operator simulations through the fold
        application (None: on for n >= 10 unless ``QUEASARS_SHARD_FOLD=0``)
    :param shot_allocation: a general operator's group budgets,
        ``"per_group"`` or ``"proportional"``
    """

    def __init__(
        self,
        operator: PauliSum,
        mesh,
        alpha: float = 1.0,
        shots: Optional[int] = None,
        seed: int = 0,
        precision: float = 0.0,
        initial_state: Union[np.ndarray, EVQEIndividual, None] = None,
        amp_devices: Optional[int] = None,
        table_mode: str = "device",
        use_fold: Optional[bool] = None,
        shot_allocation: str = "per_group",
    ):
        if not 0 < alpha <= 1:
            raise ValueError("alpha (the CVaR tail fraction) lies outside (0, 1]")
        if precision < 0:
            raise ValueError("precision must be non-negative")
        if table_mode not in ("device", "host"):
            raise ValueError("table_mode must be 'device' or 'host'")
        if shot_allocation not in ("per_group", "proportional"):
            raise ValueError("shot_allocation must be 'per_group' or 'proportional'")
        self.amp_mesh = as_pop_amp_mesh(mesh, amp_devices)
        first = AmpRow(self.amp_mesh.devices[self.amp_mesh.local_rows()[0]],
                       self.amp_mesh.ranks[self.amp_mesh.local_rows()[0]], operator.n_qubits)
        super().__init__(operator.n_qubits, first.home)
        self.local_bits = first.local_bits
        self.operator = operator
        self.n_pop_devices = self.amp_mesh.n_pop
        self.n_amp_devices = self.amp_mesh.n_amp
        self.alpha = float(alpha)
        self.shots = None if shots is None else int(shots)
        self.precision = float(precision)
        if self.precision > 0.0:
            if self.shots is not None:
                raise ValueError(
                    "precision and shots are mutually exclusive: precision IS a shot count "
                    "(ceil(precision**-2)) through the sampler"
                )
            self.shots = int(np.ceil(self.precision ** -2.0))

        self._diagonal = operator.is_diagonal
        self._table = None
        if self._diagonal:
            coeffs, z_masks = diagonal_terms(operator)
            if table_mode == "host":
                table = diagonal_energy_table(operator).to(torch.float32).numpy()
                self._table = place_sharded(self.amp_mesh, table, self.n_qubits)
            else:
                self._table = build_device_table(self.amp_mesh, coeffs, z_masks, self.n_qubits)
            # a strict bound on |energy| for the exact-CVaR bisection
            self._energy_bound = float(np.abs(coeffs).sum()) + 1.0
        else:
            if self.alpha < 1.0:
                raise CircuitEvaluatorException(
                    "CVaR (alpha<1) requires a diagonal operator: grouped measurements of "
                    "different bases do not form one empirical energy distribution to take a "
                    "tail of"
                )
            if self.shots is not None:
                from queasars_tpu_torch.sim.grouped_sampling import (
                    allocate_shots,
                    grouped_shard_operands,
                    grouped_weights,
                )

                rot_types, rot_angles, g_coeffs, g_masks, const = grouped_shard_operands(operator)
                self._rot_types = torch.as_tensor(rot_types, dtype=torch.int32)
                self._rot_angles = torch.as_tensor(rot_angles, dtype=torch.float32)
                self._grouped_const = float(np.float32(const))
                self._grouped_tables = build_device_tables_batch(
                    self.amp_mesh, g_coeffs, g_masks, self.n_qubits
                )
                self._group_shots = (
                    allocate_shots(grouped_weights(operator), self.shots)
                    if shot_allocation == "proportional" else None
                )
            else:
                self._xg_list, self._terms = group_general_terms(
                    operator.coeffs.real.astype(np.float32),
                    operator.coeffs.imag.astype(np.float32),
                    operator.z[:, 0], operator.x[:, 0], self.local_bits,
                )

        self._initial_state = initial_state
        self._initial_full: Optional[torch.Tensor] = None
        self._initial_shards = self._prepare_initial_sharded(initial_state)
        self._use_fold = routes.shard_fold(use_fold, self.n_qubits) and self._diagonal
        self.folded_bits = default_folded_bits(self.n_qubits)
        if self._use_fold:
            check_folded_bits(self.local_bits, self.folded_bits)
        self._key = prng.PRNGKey(seed)
        self._counter = 0

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        """Population-axis attach requests do not apply here (the mesh
        already factors both axes); ignore them."""

    def _prepare_initial_sharded(self, initial_state) -> Optional[AmpSharded]:
        """The start state as shards [2, 2^local] (None: |0...0>)."""
        if initial_state is None:
            return None
        if isinstance(initial_state, EVQEIndividual):
            if initial_state.n_qubits != self.n_qubits:
                raise CircuitEvaluatorException(
                    "the initial-state circuit acts on a different qubit count than the operator"
                )
            packed = PackedPopulation.pack([initial_state])
            genome = packed_tensors(packed, device="cpu")
            shards = {}
            for p in self.amp_mesh.local_rows():
                row = self.amp_mesh.row(p, self.n_qubits)
                states = simulate_local(row, *genome)
                for a in row.cells:
                    shards.setdefault(a, states[a][0])
            return AmpSharded(shards, self.n_amp_devices)
        stacked = _prepare_initial_state(initial_state, self.n_qubits, "cpu")
        return place_sharded(self.amp_mesh, stacked, self.n_qubits)

    def initial_states(self, pop: int) -> Optional[torch.Tensor]:
        """The whole start state [P, 2, 2^n] on :attr:`device` (the solver's
        final measurement runs unsharded, as the reference's does)."""
        if self._initial_state is None:
            return None
        if self._initial_full is None:
            self._initial_full = _prepare_initial_state(
                self._initial_state, self.n_qubits, self.device
            )
        return self._initial_full.expand(pop, *self._initial_full.shape).contiguous()

    def _start(self, row: AmpRow) -> Optional[dict]:
        return None if self._initial_shards is None else self._initial_shards.of(row)

    def _states(self, row: AmpRow, genome, initial_stack=None) -> dict:
        """The block's states on this process's cells, on the evaluator's
        route, from the start state or per-individual ``initial_stack``."""
        gate_types, controls, angles, layer_mask = genome
        start = None if initial_stack is not None else self._start(row)
        if self._use_fold:
            return simulate_local_folded(row, gate_types, controls, angles, layer_mask,
                                         self.folded_bits, start, initial_stack)
        return simulate_local(row, gate_types, controls, angles, layer_mask, start,
                              initial_stack)

    def _next_keys(self, pop: int) -> torch.Tensor:
        self._counter += 1
        return prng.split(prng.fold_in(self._key, self._counter), pop)

    # ------------------------------------------------------------------
    # the evaluate_packed contract
    # ------------------------------------------------------------------

    def evaluate_packed(self, packed, angles=None):
        genome = packed_tensors(packed, angles, "cpu")
        if not self._diagonal:
            if self.shots is not None:
                fn = self._grouped_block
                extra = (self._next_keys(packed.n_individuals),)
            else:
                fn = self._general_block
                extra = ()
        elif self.shots is not None:
            fn = self._sampled_block
            extra = (self._next_keys(packed.n_individuals),)
        elif self.alpha < 1.0:
            fn = self._exact_cvar_block
            extra = ()
        else:
            fn = self._exact_block
            extra = ()
        out = run_rows(self.amp_mesh, self.n_qubits, fn, (*genome, *extra))
        return out.numpy()

    def _exact_block(self, row, block, rep):
        return blockwise_energy(row, self._states(row, block), self._table)

    def _general_block(self, row, block, rep):
        return general_energies(row, self._states(row, block), self._xg_list, self._terms)

    def _sampled_block(self, row, block, rep):
        """Shot energies through the blocked sampler, then their mean or
        their CVaR."""
        *genome, keys = block
        states = self._states(row, genome)
        positions, owned = blocked_shot_positions(row, shard_probs(states), keys, self.shots)
        energies = shot_values(row, positions, owned, self._table.of(row))
        if self.alpha < 1.0:
            return cvar_expectation_from_shot_energies(energies, self.alpha)
        return row_mean(energies)

    def _grouped_block(self, row, block, rep):
        """QWC grouped shots: each individual simulates once; every group
        applies its rotation layer (per-gate route), draws with
        ``fold_in(key, g)`` and means its shots against its shard-local
        table; energy = constant + the groups' means in group order."""
        *genome, keys = block
        states = self._states(row, genome)
        rows = keys.shape[0]
        n = self.n_qubits
        n_groups = self._rot_types.shape[0]
        total = None
        for g in range(n_groups):
            rot = (self._rot_types[g].expand(rows, 1, n), torch.full((rows, 1, n), -1),
                   self._rot_angles[g].expand(rows, 1, n, 3), torch.ones(rows, 1, dtype=bool))
            rotated = simulate_local(row, *rot, initial_stack=states)
            shots = self.shots if self._group_shots is None else int(self._group_shots[g])
            positions, owned = blocked_shot_positions(
                row, shard_probs(rotated), prng.fold_in(keys, g), shots)
            tables = {a: t[g] for a, t in self._grouped_tables.of(row).items()}
            energy = row_mean(shot_values(row, positions, owned, tables))
            total = energy if total is None else total + energy
        return self._grouped_const + total

    def _exact_cvar_block(self, row, block, rep):
        """Exact CVaR: bisect each individual's alpha-quantile level V on
        ``M(tau) = sum p_i [E_i < tau]`` until no float32 lies between the
        ends (``M(lo) < alpha <= M(hi)``, so lo is an energy level), then
        ``(sum_{E<V} p E + (alpha - M(V)) V) / alpha``."""
        probs = shard_probs(self._states(row, block))
        tables = self._table.of(row)
        rows = block[0].shape[0]
        alpha = torch.tensor(self.alpha, dtype=torch.float32, device=row.home)
        bound = float(np.float32(self._energy_bound))
        lo = torch.full((rows,), -bound, dtype=torch.float32, device=row.home)
        hi = torch.full((rows,), bound, dtype=torch.float32, device=row.home)

        def below(tau, weight):
            return row.tree_sum({
                a: torch.where(tables[a] < tau.to(p.device)[:, None], weight(a, p),
                               torch.zeros_like(p))
                for a, p in probs.items()
            })

        while True:
            mid = 0.5 * (lo + hi)
            moving = (mid != lo) & (mid != hi)
            if not bool(moving.any()):
                break
            lower = below(mid, lambda a, p: p) < alpha
            lo = torch.where(moving & lower, mid, lo)
            hi = torch.where(moving & ~lower, mid, hi)
        m_below = below(lo, lambda a, p: p)
        s_below = below(lo, lambda a, p: p * tables[a])
        return (s_below + (alpha - m_below) * lo) / alpha

    # ------------------------------------------------------------------
    # device NFT sweeps
    # ------------------------------------------------------------------

    def _device_sweep_applies(self, config) -> bool:
        """The sweeps cover the exact diagonal estimator objective."""
        if not self._diagonal or self.alpha < 1.0 or self.shots is not None:
            return False
        return not getattr(config, "five_point", False)

    def _energies(self, row, genome, initial_stack=None):
        return blockwise_energy(row, self._states(row, genome, initial_stack), self._table)

    def nft_minimize(self, packed, coords, n_free, active, angles, config, seed, last_layer=None):
        """The whole NFT sweep over the mesh for ``BatchedNFT.minimize``;
        None where the host-stepped path is needed (general operators, CVaR,
        shots, precision, five-point).  With ``last_layer`` (and
        ``cache_prefix`` not False) the frozen prefix simulates once and
        every step works from it (:meth:`_prefix_sweep`)."""
        if not self._device_sweep_applies(config):
            return None
        cache_flag = getattr(config, "cache_prefix", None)
        use_prefix = last_layer is not None and (cache_flag is None or cache_flag)
        pop = packed.n_individuals
        a_full = np.asarray(angles, np.float32)
        genome = packed_tensors(packed, a_full, "cpu")
        coords_t = torch.as_tensor(np.asarray(coords), dtype=torch.long)
        n_free_t = torch.as_tensor(np.asarray(n_free), dtype=torch.int32)
        active_t = torch.as_tensor(np.asarray(active), dtype=torch.bool)
        maxiter, reset = config.maxiter, config.reset_interval
        if use_prefix:
            ll = np.asarray(last_layer, np.int64)
            prefix_mask = np.logical_and(
                packed.layer_mask, np.arange(packed.max_layers)[None, :] < ll[:, None])
            take = lambda arr: np.take_along_axis(arr, ll.reshape((-1,) + (1,) * (arr.ndim - 1)),
                                                  axis=1)
            coords1 = np.asarray(coords).copy()
            coords1[:, :, 0] = 0
            pop_args = (
                genome[0], genome[1], torch.as_tensor(prefix_mask), genome[2],
                torch.as_tensor(take(packed.gate_types), dtype=torch.int32),
                torch.as_tensor(take(packed.controls), dtype=torch.int32),
                torch.as_tensor(take(a_full)), torch.as_tensor(coords1, dtype=torch.long),
                n_free_t, active_t,
            )
            out_a1, energies = run_rows(
                self.amp_mesh, self.n_qubits,
                lambda row, block, rep: self._prefix_sweep(row, block, maxiter, reset),
                pop_args,
            )
            merged = a_full.copy()
            merged[np.arange(pop), ll] = out_a1.numpy()[:, 0]
            return merged, energies.numpy()

        def plain(row, block, rep):
            gt, ctrl, ang, lm, crd, nf, act = block
            home = row.home
            objective = lambda a, keys: self._energies(row, (gt, ctrl, a, lm))
            return _nft_steps(objective, ang.to(home), crd.to(home), nf.to(home), act.to(home),
                              maxiter, reset)

        out, energies = run_rows(self.amp_mesh, self.n_qubits, plain,
                                 (*genome, coords_t, n_free_t, active_t))
        return out.numpy(), energies.numpy()

    def nft_minimize_slots(self, packed, coords, n_free, active, slot_layers, angles, config,
                           seed):
        """The fused multi-slot search over the mesh (``BatchedNFT.
        minimize_slots``' hook): per slot the frozen prefix simulates once
        and the probes run the suffix from it; None where the host-stepped
        path is needed or ``cache_prefix`` is False."""
        if not self._device_sweep_applies(config):
            return None
        cache_flag = getattr(config, "cache_prefix", None)
        if cache_flag is not None and not cache_flag:
            return None
        genome = packed_tensors(packed, np.asarray(angles, np.float32), "cpu")
        maxiter, reset = config.maxiter, config.reset_interval

        def slots(row, block, rep):
            gt, ctrl, ang, lm, crd, nf, act, layers = block
            home = row.home
            ang = ang.to(home)
            layer_idx = torch.arange(lm.shape[1])
            z0 = torch.zeros(gt.shape[0], dtype=torch.float32, device=home)
            for s in range(layers.shape[1]):
                prefix = lm & (layer_idx[None, :] < layers[:, s, None])
                suffix = lm & (layer_idx[None, :] >= layers[:, s, None])
                states = self._states(row, (gt, ctrl, ang, prefix))
                objective = lambda a, keys: self._energies(row, (gt, ctrl, a, suffix), states)
                ang, z0 = _nft_steps(objective, ang, crd[:, s].to(home), nf[:, s].to(home),
                                     act[:, s].to(home), maxiter, reset)
            return ang, z0

        pop_args = (*genome, torch.as_tensor(np.asarray(coords), dtype=torch.long),
                    torch.as_tensor(np.asarray(n_free), dtype=torch.int32),
                    torch.as_tensor(np.asarray(active), dtype=torch.bool),
                    torch.as_tensor(np.asarray(slot_layers), dtype=torch.long))
        out, energies = run_rows(self.amp_mesh, self.n_qubits, slots, pop_args)
        return out.numpy(), energies.numpy()

    def _prefix_sweep(self, row: AmpRow, block, maxiter: int, reset_interval: int):
        """The rest-base pair-form sweep (``_nft_fn(prefix=True)``): within a
        layer the probed slot's gate G(q) commutes with the REST of the
        layer, so each step simulates BASE = REST|prefix> once (slot q
        blanked), builds the XOR-2^q partner of BASE and of the table (a
        local gather or an exchange) and reduces nine masked pair sums in
        the fixed tree; every probe energy is then a scalar form
        ``E(t) = F0 + sum_k c_k(U3(t)) F_k``."""
        gt, ctrl, prefix_mask, full_angles, gate1, ctrl1, angles, coords, n_free, active = block
        home = row.home
        lb = row.local_bits
        pop, n = gate1.shape[0], gate1.shape[2]
        rows = torch.arange(pop)
        tables = self._table.of(row)
        prefix = self._states(row, (gt, ctrl, full_angles, prefix_mask))
        ones_mask = torch.ones((pop, 1), dtype=torch.bool)
        idx = {a: torch.arange(row.shard_len, device=row.devices[a]) for a in row.cells}
        table_partners = [row.exchange(tables, 1 << b) for b in range(row.device_bits)]
        angles_c = angles.to(home).clone()
        n_free_h = n_free.long()
        apply = (active & (n_free > 0)).to(home)
        z0 = torch.zeros(pop, dtype=torch.float32, device=home)
        for k in range(maxiter):
            sel = torch.where(n_free_h > 0, k % n_free_h.clamp(min=1), torch.zeros_like(n_free_h))
            coord = coords[rows, sel]
            qv, av = coord[:, 1], coord[:, 2]
            gt_rest = torch.where(torch.arange(n)[None, None, :] == qv[:, None, None],
                                  torch.zeros_like(gate1), gate1)
            base = self._states(row, (gt_rest, ctrl1, angles_c, ones_mask), initial_stack=prefix)
            exchanged = [row.exchange(base, 1 << b) for b in range(row.device_bits)]
            gate_q = gate1[rows, 0, qv]
            ctrl_q = ctrl1[rows, 0, qv]
            planes = {}
            for a in row.cells:
                device = row.devices[a]
                q = qv.to(device)
                flip = idx[a][None, :] ^ (torch.ones_like(q) << q.clamp(max=lb - 1))[:, None]
                partner = torch.gather(base[a], 2, flip[:, None, :].expand(-1, 2, -1))
                tpart = tables[a][flip]
                for b in range(row.device_bits):
                    pick = (q - lb == b)
                    partner = torch.where(pick[:, None, None], exchanged[b][a], partner)
                    tpart = torch.where(pick[:, None], table_partners[b][a][None, :], tpart)
                m0 = _amp_bit(q, idx[a], lb, a) == 0
                cm = torch.where((gate_q.to(device) == 3)[:, None],
                                 _amp_bit(ctrl_q.to(device), idx[a], lb, a) == 1,
                                 torch.ones_like(m0))
                mask_pair = (m0 & cm).to(torch.float32)
                mask_f0 = (~cm).to(torch.float32)
                a_re, a_im = base[a][:, 0], base[a][:, 1]
                b_re, b_im = partner[:, 0], partner[:, 1]
                abs_a = a_re * a_re + a_im * a_im
                abs_b = b_re * b_re + b_im * b_im
                c_re = a_re * b_re + a_im * b_im
                c_im = a_im * b_re - a_re * b_im
                table = tables[a][None, :]
                t_a = table * mask_pair
                t_b = tpart * mask_pair
                planes[a] = torch.stack([
                    table * mask_f0 * abs_a,
                    t_a * abs_a, t_a * abs_b, t_a * c_re, t_a * c_im,
                    t_b * abs_a, t_b * abs_b, t_b * c_re, t_b * c_im,
                ], dim=1)
            sums = row.tree_sum(planes)  # [P, 9]
            qh, ah = qv.to(home), av.to(home)
            theta = angles_c[rows, 0, qh, ah]
            gated = ((gate_q == 1) | (gate_q == 3)).to(home)
            form = _pair_form(sums, angles_c[rows, 0, qh], ah, gated)
            if k % reset_interval == 0:
                z0 = form(theta)
            shift, minimum_value = nft_three_point_update(
                z0, form(theta + math.pi / 2), form(theta - math.pi / 2))
            updated = angles_c.clone()
            updated[rows, 0, qh, ah] = theta + (shift + math.pi)
            angles_c = torch.where(apply[:, None, None, None], updated, angles_c)
            z0 = torch.where(apply, minimum_value, z0)
        return angles_c, z0


def _pair_form(sums, angles_q, av, gated):
    """``form(t)`` of the prefix sweep: the energy with the probed angle
    ``av`` of U3(theta, phi, lambda) = ``angles_q`` [P, 3] set to t, from
    the nine pair sums [P, 9]."""
    th0, ph0, la0 = angles_q[:, 0], angles_q[:, 1], angles_q[:, 2]

    def form(tval):
        te = torch.where(av == 0, tval, th0)
        pe = torch.where(av == 1, tval, ph0)
        le = torch.where(av == 2, tval, la0)
        cos_h, sin_h = torch.cos(te * 0.5), torch.sin(te * 0.5)
        one, zero = torch.ones_like(tval), torch.zeros_like(tval)
        u00r = torch.where(gated, cos_h, one)
        u01r = torch.where(gated, -torch.cos(le) * sin_h, zero)
        u01i = torch.where(gated, -torch.sin(le) * sin_h, zero)
        u10r = torch.where(gated, torch.cos(pe) * sin_h, zero)
        u10i = torch.where(gated, torch.sin(pe) * sin_h, zero)
        u11r = torch.where(gated, torch.cos(pe + le) * cos_h, one)
        u11i = torch.where(gated, torch.sin(pe + le) * cos_h, zero)
        c1 = u00r * u00r
        c2 = u01r * u01r + u01i * u01i
        re01 = u00r * u01r
        im01 = -u00r * u01i
        c5 = u10r * u10r + u10i * u10i
        c6 = u11r * u11r + u11i * u11i
        re11 = u10r * u11r + u10i * u11i
        im11 = u10i * u11r - u10r * u11i
        e = sums[:, 0]
        e = e + c1 * sums[:, 1]
        e = e + c2 * sums[:, 2]
        e = e + 2.0 * re01 * sums[:, 3]
        e = e - 2.0 * im01 * sums[:, 4]
        e = e + c5 * sums[:, 5]
        e = e + c6 * sums[:, 6]
        e = e + 2.0 * re11 * sums[:, 7]
        e = e - 2.0 * im11 * sums[:, 8]
        return e

    return form
