"""The port's plain last-layer NFT sweep against the JAX package's
``pallas_nft_layer_sweep`` run in interpret mode on the CPU.

Sweeps are compared through energies, not raw angles: angles are ambiguous
by pi on flat coordinates, and the Pallas kernel's polynomial atan2
(~2e-6 error) against torch.atan2 can flip a branch there.  Tolerance:
1e-5 * max|table| on final energies, re-evaluated through the JAX engine.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from queasars_tpu.genome import EVQEPopulation
from queasars_tpu.genome.packing import PackedPopulation
from queasars_tpu.sim.pallas_kernels import pallas_nft_layer_sweep
from queasars_tpu.sim.statevector import probabilities, simulate_circuits
from queasars_tpu_torch.sim import slot_kernels as sk


def _sweep_problem(n_qubits=7, pop=5, layers=3, seed=4):
    population = EVQEPopulation.random_population(n_qubits, layers, pop, True, random_seed=seed)
    packed = PackedPopulation.pack(list(population.individuals))
    last = packed.layer_mask.sum(axis=1).astype(np.int32) - 1
    rows = np.arange(pop)
    coords = np.zeros((pop, 3 * n_qubits, 2), np.int32)
    n_free = np.zeros(pop, np.int32)
    for i in range(pop):
        c = packed.layer_param_coordinates(i, -1)[:, 1:3]
        coords[i, : len(c)] = c
        n_free[i] = len(c)
    active = n_free > 0
    active[1] = False
    prefix_mask = packed.layer_mask & (np.arange(packed.max_layers)[None, :] < last[:, None])
    prefix = np.array(
        simulate_circuits(packed.gate_types, packed.controls, packed.angles, prefix_mask, n_qubits)
    )
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=1 << n_qubits) * 10.0).astype(np.float32)
    layer = (
        packed.gate_types[rows, last], packed.controls[rows, last], packed.angles[rows, last],
    )
    return packed, last, layer, coords, n_free, active, prefix, table


def _energies(packed, last, layer_angles, table):
    angles = packed.angles.copy()
    angles[np.arange(len(last)), last] = layer_angles
    probs = np.asarray(
        probabilities(packed.gate_types, packed.controls, angles, packed.layer_mask, packed.n_qubits)
    )
    return probs @ table


def test_nft_layer_sweep_plain_matches_pallas():
    packed, last, layer, coords, n_free, active, prefix, table = _sweep_problem()
    n, maxiter, reset = packed.n_qubits, 9, 4
    assert (layer[0] == 3).any(), "the swept layers should hold a CU3 slot"
    a_ref, z_ref = pallas_nft_layer_sweep(
        *layer, coords, n_free, active, jnp.asarray(prefix), jnp.asarray(table),
        n, maxiter, reset, interpret=True,
    )
    a_got, z_got = sk.nft_layer_sweep(
        torch.from_numpy(layer[0]), torch.from_numpy(layer[1]), torch.from_numpy(layer[2]),
        torch.from_numpy(coords), torch.from_numpy(n_free), torch.from_numpy(active),
        torch.from_numpy(prefix), torch.from_numpy(table), n, maxiter, reset,
    )
    tol = 1e-5 * np.abs(table).max()
    e_ref = _energies(packed, last, np.asarray(a_ref), table)
    e_got = _energies(packed, last, a_got.numpy(), table)
    np.testing.assert_allclose(e_got, e_ref, atol=tol)
    np.testing.assert_allclose(z_got.numpy(), np.asarray(z_ref), atol=tol)
    # the recycled z is the exact energy at the final angles (last layer)
    np.testing.assert_allclose(z_got.numpy(), e_got, atol=tol)
    # an inactive individual keeps its angles; the sweep lowered the rest
    np.testing.assert_array_equal(a_got[1].numpy(), layer[2][1])
    start = _energies(packed, last, layer[2], table)
    assert np.all(e_got[active] <= start[active] + tol)


# ---------------------------------------------------------------------------
# the CUDA sweeps' step rule (csrc/sweep.cuh), modelled in torch on the CPU
# ---------------------------------------------------------------------------

N_DESIGN = 7


def _design_problem(seed=11):
    """Six hand-made swept layers at n=7 with random prefix states and table:
    0: U3s and CU3s with controls above (2 <- 5, 4 <- 6) and below (6 <- 3)
    their targets; 1: one U3 (n_free = 3, no transition); 2: gated but
    inactive; 3: a CU3 with its control below (5 <- 1) and a U3 (n_free =
    6, wraps before maxiter 12); 4: no gate (n_free = 0); 5: U3s and a CU3
    with its control above (4 <- 6)."""
    n, pop = N_DESIGN, 6
    gate_types = np.zeros((pop, n), np.int32)
    controls = np.full((pop, n), -1, np.int32)

    def u3(p, *qs):
        gate_types[p, list(qs)] = 1

    def cu3(p, target, control):
        gate_types[p, target], controls[p, target], gate_types[p, control] = 3, control, 2

    u3(0, 0)
    cu3(0, 2, 5)
    cu3(0, 6, 3)
    u3(0, 1)
    u3(1, 3)
    cu3(2, 1, 0)
    u3(2, 5)
    cu3(3, 5, 1)
    u3(3, 0)
    u3(5, 1, 3)
    cu3(5, 4, 6)
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, (pop, n, 3)).astype(np.float32)
    coords = np.zeros((pop, 3 * n, 2), np.int32)
    n_free = np.zeros(pop, np.int32)
    for p in range(pop):
        flat = [(q, a) for q in range(n) if gate_types[p, q] in (1, 3) for a in range(3)]
        if flat:
            coords[p, : len(flat)] = flat
        n_free[p] = len(flat)
    active = n_free > 0
    active[2] = False
    prefix = rng.normal(size=(pop, 2, 1 << n)).astype(np.float32)
    prefix /= np.sqrt((prefix**2).sum(axis=(1, 2), keepdims=True))
    table = (rng.normal(size=1 << n) * 10.0).astype(np.float32)
    assert list(n_free) == [12, 3, 6, 6, 0, 9]
    return tuple(torch.from_numpy(x) for x in (
        gate_types, controls, angles, coords, n_free, active, prefix, table))


def _layer_energies(gate_types, controls, layer_angles, prefix, table):
    """Plain energies [P] of the swept layer at ``layer_angles`` from the
    prefix states."""
    pop = gate_types.shape[0]
    return sk.energies_exact_plain(
        gate_types[:, None], controls[:, None], layer_angles[:, None],
        torch.ones((pop, 1), dtype=torch.bool), table, N_DESIGN, prefix,
    )


def _pair_sums(state, table, q, control, n):
    """The nine pair sums of one BASE state [2, 2^n] around qubit q
    (``sweep.cuh::sweep_pass``)."""
    idx = torch.arange(1 << n)
    re, im = state[0], state[1]
    off = ((idx >> control) & 1) == 0 if control >= 0 else torch.zeros_like(idx, dtype=torch.bool)
    f0 = (table * (re * re + im * im))[off].sum()
    i0 = idx[(((idx >> q) & 1) == 0) & ~off]
    i1 = i0 | (1 << q)
    ar, ai, br, bi = re[i0], im[i0], re[i1], im[i1]
    ta, tb = table[i0], table[i1]
    abs_a, abs_b = ar * ar + ai * ai, br * br + bi * bi
    cr, ci = ar * br + ai * bi, ai * br - ar * bi
    return torch.stack([f0] + [(t * v).sum() for t in (ta, tb) for v in (abs_a, abs_b, cr, ci)])


def _form_energy(f, angle, a_i, gated, t):
    """E(t) of the probed coordinate from the nine sums (``form_energy``)."""
    te, pe, le = (t if a_i == j else angle[j] for j in range(3))
    ch, sh = torch.cos(te * 0.5), torch.sin(te * 0.5)
    one, zero = torch.ones(()), torch.zeros(())
    u00 = (ch if gated else one, zero)
    u01 = ((-torch.cos(le) * sh, -torch.sin(le) * sh) if gated else (zero, zero))
    u10 = ((torch.cos(pe) * sh, torch.sin(pe) * sh) if gated else (zero, zero))
    u11 = ((torch.cos(pe + le) * ch, torch.sin(pe + le) * ch) if gated else (one, zero))

    def weights(x, y):
        return (x[0] * x[0] + x[1] * x[1], y[0] * y[0] + y[1] * y[1],
                x[0] * y[0] + x[1] * y[1], x[1] * y[0] - x[0] * y[1])

    c1, c2, re01, im01 = weights(u00, u01)
    c5, c6, re11, im11 = weights(u10, u11)
    return (f[0] + c1 * f[1] + c2 * f[2] + 2 * re01 * f[3] - 2 * im01 * f[4] + c5 * f[5]
            + c6 * f[6] + 2 * re11 * f[7] - 2 * im11 * f[8])


def design_sweep(gate_types, controls, angles, coords, n_free, active, prefix, table,
                 n, maxiter, reset_interval):
    """The CUDA sweeps' step rule in float32 torch: BASE = (layer without the
    probed qubit's gate) . prefix rebuilt on steps k % reset_interval == 0,
    otherwise updated where an individual the sweep moves probes another
    qubit than at k - 1 (its last qubit's gate redone at its new angles,
    the new one's undone with U3^dagger); nine pair sums; z0 from the sums
    on rebuilds; z1 and z3 from the sums on every step.  Returns (angles,
    z, the steps with a transition)."""
    from queasars_tpu_torch.sim.statevector import apply_u3_pairs, simulate_circuits, u3_entries

    pop = gate_types.shape[0]
    rows = torch.arange(pop)
    current = angles.clone()
    moves_on = active & (n_free > 0)
    gated = (gate_types == 1) | (gate_types == 3)
    ctrl_of = torch.where(gate_types == 3, controls, torch.full_like(controls, -1))

    def probe(k):
        idx = (k % n_free.clamp(min=1)).long()
        return coords[rows, idx, 0].long().clamp(0, n - 1), coords[rows, idx, 1].long()

    def gate(state, p, q, dagger):
        (u00, u01, u10, u11) = u3_entries(current[p, q][None])
        if dagger:
            conj = [(re, -im) for re, im in (u00, u10, u01, u11)]
            u00, u01, u10, u11 = conj
        crot = gate_types[p, q] == 3
        return apply_u3_pairs(state[None], int(q), (u00, u01, u10, u11), gated[p, q][None],
                              crot[None], controls[p, q].clamp(min=0)[None], n)[0]

    base, sums, z, transitions = None, torch.zeros((pop, 9)), torch.zeros(pop), []
    for k in range(max(maxiter, 1)):
        q, a = probe(k)
        rebuild = k % reset_interval == 0
        if rebuild:
            rest = gate_types.clone()
            rest[rows, q] = 0
            base = simulate_circuits(rest[:, None], controls[:, None], current[:, None],
                                     torch.ones((pop, 1), dtype=torch.bool), n, prefix)
            changed = torch.ones(pop, dtype=torch.bool)
        else:
            last, _ = probe(k - 1)
            changed = moves_on & (last != q)
            if changed.any():
                transitions.append(k)
            for p in torch.nonzero(changed).flatten().tolist():
                state = gate(base[p], p, last[p], dagger=False)
                base[p] = gate(state, p, q[p], dagger=True)
        for p in torch.nonzero(changed).flatten().tolist():
            sums[p] = _pair_sums(base[p], table, int(q[p]), int(ctrl_of[p, q[p]]), n)
        for p in range(pop):
            angle, a_i, g = current[p, q[p]], int(a[p]), bool(gated[p, q[p]])
            theta = angle[a_i].clone()
            z0 = _form_energy(sums[p], angle, a_i, g, theta) if rebuild else z[p]
            if k >= maxiter:
                z[p] = z0
                continue
            z1 = _form_energy(sums[p], angle, a_i, g, theta + np.float32(np.pi / 2))
            z3 = _form_energy(sums[p], angle, a_i, g, theta - np.float32(np.pi / 2))
            mid, half = (z1 + z3) * 0.5, (z1 - z3) * 0.5
            d = z0 - mid
            if moves_on[p]:
                current[p, q[p], a_i] = theta + torch.atan2(half, d) + np.float32(np.pi)
                z[p] = mid - torch.sqrt(d * d + half * half)
            else:
                z[p] = z0
    return current, z, transitions


def _check_design(args, maxiter, reset, others):
    """The design model at (maxiter, reset) against the angles of each sweep
    in ``others`` through plain energies, its recycled z against the
    energies at its angles, the inactive individual unmoved, and the CUDA
    wrappers' host schedule against the model's transition steps."""
    gate_types, controls, angles, coords, n_free, active, prefix, table = args
    a_model, z_model, steps = design_sweep(*args, N_DESIGN, maxiter, reset)
    tol = 1e-5 * float(table.abs().max())
    e_model = _layer_energies(gate_types, controls, a_model, prefix, table)
    torch.testing.assert_close(z_model, e_model, atol=tol, rtol=0)
    for name, other in others.items():
        e_other = _layer_energies(gate_types, controls, other, prefix, table)
        torch.testing.assert_close(e_model, e_other, atol=tol, rtol=0, msg=name)
    assert torch.equal(a_model[2], angles[2]) and torch.equal(a_model[4], angles[4])
    flags = sk.sweep_transitions(coords, n_free, active, N_DESIGN, maxiter)
    assert [k for k in np.flatnonzero(flags).tolist() if k % reset] == steps
    return steps


def _plain_sweeps(args, maxiter, reset):
    from queasars_tpu_torch.sim import fold_kernels as fk

    gate_types, controls, angles, coords, n_free, active, prefix, table = args
    meta = [torch.from_numpy(m) for m in fk.fold_sweep_metadata(
        gate_types.numpy(), controls.numpy(), N_DESIGN)]
    slot, _ = sk.nft_layer_sweep_plain(*args, N_DESIGN, maxiter, reset)
    fold, _ = fk.nft_layer_sweep_folded_plain(
        gate_types, angles, coords, n_free, active, prefix, table, *meta, N_DESIGN, maxiter,
        reset)
    return {"slot plain sweep": slot, "fold plain sweep": fold}


def test_design_step_rule_matches_pallas_and_the_plain_sweeps():
    """maxiter = 3 * reset_interval (two rebuilds after the first), past
    n_free for individuals 1 and 3 (wrap-around), against the Pallas kernel
    in interpret mode and the port's two plain sweeps."""
    args = _design_problem()
    gate_types, controls, angles, coords, n_free, active, prefix, table = args
    maxiter, reset = 12, 4
    a_ref, _ = pallas_nft_layer_sweep(
        *(jnp.asarray(t.numpy()) for t in args), N_DESIGN, maxiter, reset, interpret=True,
    )
    others = _plain_sweeps(args, maxiter, reset)
    others["pallas_nft_layer_sweep"] = torch.from_numpy(np.array(a_ref))
    steps = _check_design(args, maxiter, reset, others)
    # transitions at k = 3 mod 12 steps (individuals 0, 3, 5), none on a rebuild
    assert steps == [3, 6, 9]


@pytest.mark.parametrize("maxiter,reset", [(0, 4), (1, 4), (7, 32), (13, 5), (20, 3)])
def test_design_step_rule_matches_the_plain_sweeps(maxiter, reset):
    """No step, one step, transitions with no rebuild after the first,
    rebuilds that fall on transition steps and between them."""
    args = _design_problem(seed=maxiter)
    _check_design(args, maxiter, reset, _plain_sweeps(args, maxiter, reset))
