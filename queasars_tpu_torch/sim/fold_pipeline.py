"""Kron-fold circuit transform: genome circuits as kron layers plus phases.

Counterpart of ``queasars_tpu/sim/fold_pipeline.py``.  The transform is
exact algebra over the whole circuit:

1. every controlled rotation CU3(c, t) is eigendecomposed as

       CU3 = (I_c x V_t) . CDiag(c, t) . (I_c x Vdag_t)

   where ``V`` diagonalises the target U3 (a 2x2 eigenproblem in closed
   form) and ``CDiag`` applies pure phases on the |c=1, t=0/1> basis
   states: an elementwise pass with no partner exchange;
2. since a circuit layer touches every qubit at most once, its
   non-diagonal part is a tensor product of 2x2 factors, and layer k's
   Vdag factors merge into layer k-1's main factors by 2x2 products.

A circuit of L layers becomes

    [x_q F_{L,q}] . D_L . [x_q F_{L-1,q}] . ... . D_1 . [x_q F_{0,q}]

-- L+1 kron layers of per-qubit 2x2 factors and L diagonal-phase passes.
The fold kernels (``sim/fold_kernels.py``) apply each kron layer factor by
factor over tiles of the state; the 7-qubit axis groups (lane q<7, row
7<=q<14, top q>=14) mark which parts of a layer are active.  This module
builds the pipeline tensors on the tensors' device in
real float32 arithmetic and holds two plain appliers: a per-qubit one
(float32, any size; the plain version behind the kernels) and a dense kron
oracle (complex128, test sizes only).

On card tensors that want no gradient :func:`build_fold_pipeline` is one
launch of ``qt_fold_build`` (``csrc/fold_build.cu``), which writes every
field with no PyTorch operation and no host copy; anywhere else (the CPU,
and the gradient optimizer's autograd through the fold) it is
:func:`build_fold_pipeline_plain`, the PyTorch operations the kernel is held
to.  Every call is span ``fold.build`` inside a recording, and is counted in
``build_counts`` (calls, host nanoseconds, and the calls the kernel took)
whether or not one is open.
"""

from __future__ import annotations

import functools
import math
import time
from typing import NamedTuple

import torch

from queasars_tpu_torch.sim.statevector import GATE_CROT, GATE_ROT
from queasars_tpu_torch.utils import cuda_lib
from queasars_tpu_torch.utils.batch_invariant import atan2
from queasars_tpu_torch.utils.cuda_lib import on_cuda
from queasars_tpu_torch.utils.profiling import spanned

LANE_BITS = 7

#: :func:`build_fold_pipeline` calls, the host nanoseconds they took (two
#: clock reads a call) and the calls that launched ``qt_fold_build``
build_counts: dict[str, int] = {"builds": 0, "host_ns": 0, "kernel": 0}
#: the build kernel's largest size: one warp lane per qubit
BUILD_KERNEL_MAX_QUBITS = 32


class FoldPipeline(NamedTuple):
    """Tensor form of the kron-fold transform (leading axes [P, ...]).

    - ``factors`` [P, L+1, n, 2, 2, 2] float32: per kron layer, per qubit, a
      complex 2x2 (axis 3 = re/im).  Kron layer 0 is layer 0's Vdag
      factors; kron layer k (1 <= k <= L-1) is layer k's Vdag merged onto
      layer k-1's main factors; kron layer L is layer L-1's main factors.
    - ``diag_ctrl`` / ``diag_tgt`` [P, L, D] int32: control / target qubits
      of each controlled rotation, compacted to the front (D = max(n // 2,
      1); unused slots hold -1).
    - ``diag_phase`` [P, L, D, 2, 2] float32: per slot, the phase for
      target bit 0 / 1 (axis 3) as (re, im) (axis 4); (1, 0) when unused.
    - ``diag_count`` [P, L] int32: used slots per layer.
    - ``group_active`` [P, L+1, G] int32: 1 where the kron layer's group
      fold differs from the identity (G = :func:`n_axis_groups`).
    - ``abs_ctrl`` / ``abs_tgt`` / ``abs_phase`` / ``abs_count``: the same
      layout, holding the controlled-diagonal phases absorbed into kron
      layer ``l`` (a CDiag whose control and target share one active axis
      group; the reference row-scales that group's matrix with it, the
      port's kernels apply it with the layer's last pass).  Empty unless
      ``build_fold_pipeline(..., absorb_diag=True)``.
    """

    factors: torch.Tensor
    diag_ctrl: torch.Tensor
    diag_tgt: torch.Tensor
    diag_phase: torch.Tensor
    diag_count: torch.Tensor
    group_active: torch.Tensor
    abs_ctrl: torch.Tensor
    abs_tgt: torch.Tensor
    abs_phase: torch.Tensor
    abs_count: torch.Tensor


def n_axis_groups(n_qubits: int) -> int:
    """Number of axis groups: lane (q<7), row (7<=q<14), top (q>=14)."""
    return min((n_qubits + LANE_BITS - 1) // LANE_BITS, 3)


def group_bounds(n_qubits: int) -> list[tuple[int, int]]:
    """(first qubit, bit count) of every axis group; the top group takes
    every qubit from 14 up."""
    n_groups = n_axis_groups(n_qubits)
    return [
        (g * LANE_BITS, (n_qubits if g == n_groups - 1 else (g + 1) * LANE_BITS) - g * LANE_BITS)
        for g in range(n_groups)
    ]


def _eye(like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Identity 2x2 (re, im) broadcast to ``like[..., 2, 2]``'s shape."""
    eye = torch.eye(2, dtype=torch.float32, device=like.device)
    eye = eye.expand(*like.shape, 2, 2)
    return eye, torch.zeros_like(eye)


def _mat(e00, e01, e10, e11) -> torch.Tensor:
    """[..., 2, 2] from four [...] entries."""
    return torch.stack([torch.stack([e00, e01], -1), torch.stack([e10, e11], -1)], -2)


def slot_factors(gate_type: torch.Tensor, angles: torch.Tensor):
    """Per-slot factor matrices and CDiag phases, real arithmetic.

    ``gate_type`` [...] and ``angles`` [..., 3] give ``(main_re, main_im,
    vdag_re, vdag_im, ph)``: main/vdag [..., 2, 2], ``ph`` [..., 2, 2] =
    (target bit, re/im).  main is U3 for ROT, V for CROT, I otherwise; vdag
    is V^dagger for CROT, I otherwise; ph is (phase0, phase1) for CROT,
    (1, 1) otherwise.  Same formulas as the reference's ``_slot_factors``.
    """
    theta, phi, lam = angles[..., 0], angles[..., 1], angles[..., 2]
    s = (phi + lam) * 0.5
    a = (phi - lam) * 0.5
    half = theta * 0.5
    cos_half, sin_half = torch.cos(half), torch.sin(half)
    cos_s, sin_s = torch.cos(s), torch.sin(s)
    zero = torch.zeros_like(cos_half)

    u3_re = _mat(cos_half, -torch.cos(lam) * sin_half,
                 torch.cos(phi) * sin_half, torch.cos(phi + lam) * cos_half)
    u3_im = _mat(zero, -torch.sin(lam) * sin_half,
                 torch.sin(phi) * sin_half, torch.sin(phi + lam) * cos_half)

    # U3 = V diag(e^{i(s-d/2)}, e^{i(s+d/2)}) V^dag: W = e^{-is} U3 =
    # cos(d/2) I - i sin(d/2) (n.sigma), m = sin(d/2) n
    cos_d2 = cos_half * cos_s
    mz = cos_half * sin_s
    my = sin_half * torch.cos(a)
    mx = -sin_half * torch.sin(a)
    # the square roots are guarded for autograd (the gradient optimizer
    # differentiates through the fold): at degenerate angles -- a freshly
    # grown CROT's zeros -- the radicands are exact zeros, whose sqrt
    # cotangent is 0 * inf = NaN even in torch.where's dead branch.  The
    # guarded forms evaluate to the same floats (sqrt(0) = 0), as the
    # reference's do (fold_pipeline.py:146-159)
    xy_sq = mx * mx + my * my
    xy_zero = xy_sq == 0.0
    one = torch.ones_like(cos_half)
    nxy = torch.where(xy_zero, zero, torch.sqrt(torch.where(xy_zero, one, xy_sq)))
    s_sq = nxy * nxy + mz * mz
    s_zero = s_sq == 0.0
    sin_d2 = torch.where(s_zero, zero, torch.sqrt(torch.where(s_zero, one, s_sq)))
    d_half = atan2(sin_d2, cos_d2)
    ph0, ph1 = s - d_half, s + d_half
    ph = _mat(torch.cos(ph0), torch.sin(ph0), torch.cos(ph1), torch.sin(ph1))

    # V rotates z onto n: [[cos(b/2), -sin(b/2) e^{-ic}], [sin(b/2) e^{ic}, cos(b/2)]]
    mz_b = torch.where(xy_zero & (mz == 0.0), one, mz)
    b_half = atan2(nxy, mz_b) * 0.5
    c = atan2(torch.where(xy_zero, zero, my), torch.where(xy_zero, one, mx))
    cos_b, sin_b = torch.cos(b_half), torch.sin(b_half)
    cos_c, sin_c = torch.cos(c), torch.sin(c)
    v_re = _mat(cos_b, -sin_b * cos_c, sin_b * cos_c, cos_b)
    v_im = _mat(zero, sin_b * sin_c, sin_b * sin_c, zero)
    eye, zmat = _eye(cos_half)
    degenerate = (sin_d2 < 1e-7)[..., None, None]
    v_re = torch.where(degenerate, eye, v_re)
    v_im = torch.where(degenerate, zmat, v_im)

    is_rot = (gate_type == GATE_ROT)[..., None, None]
    is_crot = (gate_type == GATE_CROT)[..., None, None]
    main_re = torch.where(is_rot, u3_re, torch.where(is_crot, v_re, eye))
    main_im = torch.where(is_rot, u3_im, torch.where(is_crot, v_im, zmat))
    vdag_re = torch.where(is_crot, v_re.transpose(-1, -2), eye)
    vdag_im = torch.where(is_crot, -v_im.transpose(-1, -2), zmat)
    ident_ph = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float32, device=angles.device)
    ph = torch.where(is_crot, ph, ident_ph)
    return main_re, main_im, vdag_re, vdag_im, ph


def _group_activity(slot_active: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """[..., n] per-qubit activity -> [..., G] int32 per-group activity."""
    return torch.stack(
        [slot_active[..., lo:lo + m].any(dim=-1) for lo, m in group_bounds(n_qubits)], dim=-1
    ).to(torch.int32)


@spanned("fold.build")
def build_fold_pipeline(
    gate_types: torch.Tensor,
    controls: torch.Tensor,
    angles: torch.Tensor,
    layer_mask: torch.Tensor,
    n_qubits: int,
    absorb_diag: bool = False,
) -> FoldPipeline:
    """The kron-fold pipeline of a packed genome batch ([P, L, n] tensors,
    ``angles`` [P, L, n, 3], ``layer_mask`` [P, L]) on its device.

    ``absorb_diag`` moves every controlled-diagonal phase whose control and
    target share one axis group -- and whose kron layer is already active in
    that group -- out of the full-state diagonal pass into the ``abs_*``
    slots (the reference's kernels row-scale the group matrix with them).
    The top group absorbs only up to n=21 (as in the reference, whose n=22
    kernels split that group's matrix in two).

    Card tensors take ``qt_fold_build`` unless autograd is to differentiate
    through ``angles`` (:func:`_takes_kernel`); the rest take
    :func:`build_fold_pipeline_plain`.
    """
    if gate_types.shape[2] != n_qubits:
        raise ValueError("gate_types last axis must equal n_qubits")
    start = time.perf_counter_ns()
    if _takes_kernel(angles):
        pipeline = _build_on_card(gate_types, controls, angles, layer_mask, n_qubits, absorb_diag)
        build_counts["kernel"] = build_counts.get("kernel", 0) + 1
    else:
        pipeline = build_fold_pipeline_plain(
            gate_types, controls, angles, layer_mask, n_qubits, absorb_diag)
    build_counts["builds"] += 1
    build_counts["host_ns"] += time.perf_counter_ns() - start
    return pipeline


def _takes_kernel(angles) -> bool:
    """Whether a build of these angles is the kernel's: on the card, and
    with no gradient wanted through them (the kernel has no backward)."""
    return angles.is_cuda and not (torch.is_grad_enabled() and angles.requires_grad)


def _build_on_card(gate_types, controls, angles, layer_mask, n_qubits, absorb_diag):
    """:func:`build_fold_pipeline` as one launch of ``qt_fold_build`` on the
    tensors' card and its current stream: the outputs are views of one
    float32 and one int32 allocation, and nothing is copied from the host.
    Refuses n > 32, mixed devices and shapes the kernel does not read."""
    if not 1 <= n_qubits <= BUILD_KERNEL_MAX_QUBITS:
        raise ValueError(
            f"qt_fold_build takes 1 <= n_qubits <= {BUILD_KERNEL_MAX_QUBITS}, got {n_qubits}")
    if not on_cuda(gate_types, controls, angles, layer_mask):
        raise ValueError("qt_fold_build runs on the card; the CPU takes build_fold_pipeline_plain")
    pop, n_layers, n = gate_types.shape
    inputs = []
    for name, t, dtype, shape in (
        ("gate_types", gate_types, torch.int32, (pop, n_layers, n)),
        ("controls", controls, torch.int32, (pop, n_layers, n)),
        ("angles", angles, torch.float32, (pop, n_layers, n, 3)),
        ("layer_mask", layer_mask, torch.bool, (pop, n_layers)),
    ):
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            t = t.to(dtype)
        inputs.append(t if t.is_contiguous() else t.contiguous())
    device = angles.device
    pipeline = _outputs(pop, n_layers, n_qubits, device)
    with torch.cuda.device(device):
        status = cuda_lib.load().qt_fold_build(
            *(t.data_ptr() for t in pipeline), *(t.data_ptr() for t in inputs), pop, n_layers,
            n_qubits, int(absorb_diag), torch.cuda.current_stream(device).cuda_stream,
        )
    cuda_lib.check(status, "qt_fold_build")
    return pipeline


def _outputs(pop: int, n_layers: int, n_qubits: int, device) -> FoldPipeline:
    """Uninitialised pipeline tensors for the build kernel to write: views
    of one float32 and one int32 allocation (:func:`_layout`)."""
    n_float, n_int, fields = _layout(pop, n_layers, n_qubits)
    buffers = (torch.empty(n_float, dtype=torch.float32, device=device),
               torch.empty(n_int, dtype=torch.int32, device=device))
    return FoldPipeline(*(buffers[b].as_strided(shape, stride, offset)
                          for b, shape, stride, offset in fields))


@functools.lru_cache(maxsize=64)
def _layout(pop: int, n_layers: int, n_qubits: int):
    """Where each :class:`FoldPipeline` field lies in the build kernel's two
    output allocations: (float32 elements, int32 elements, per field in
    field order (buffer 0 or 1, shape, contiguous strides, offset))."""
    n_kron, d_slots = n_layers + 1, max(n_qubits // 2, 1)
    slots, phases = (pop, n_layers, d_slots), (pop, n_layers, d_slots, 2, 2)
    shapes = dict(factors=(pop, n_kron, n_qubits, 2, 2, 2), diag_ctrl=slots, diag_tgt=slots,
                  diag_phase=phases, diag_count=(pop, n_layers),
                  group_active=(pop, n_kron, n_axis_groups(n_qubits)), abs_ctrl=slots,
                  abs_tgt=slots, abs_phase=phases, abs_count=(pop, n_layers))
    ends, fields = [0, 0], []
    for name in FoldPipeline._fields:
        shape = shapes[name]
        buffer = int(name not in ("factors", "diag_phase", "abs_phase"))
        strides = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        fields.append((buffer, shape, strides, ends[buffer]))
        ends[buffer] += math.prod(shape)
    return ends[0], ends[1], tuple(fields)


def build_fold_pipeline_plain(
    gate_types: torch.Tensor,
    controls: torch.Tensor,
    angles: torch.Tensor,
    layer_mask: torch.Tensor,
    n_qubits: int,
    absorb_diag: bool = False,
) -> FoldPipeline:
    """Plain version of :func:`build_fold_pipeline` in PyTorch operations on
    the tensors' device, differentiable through ``angles``; neither a span
    nor counted."""
    pop, n_layers, n = gate_types.shape
    if n != n_qubits:
        raise ValueError("gate_types last axis must equal n_qubits")
    device = angles.device
    mask = layer_mask.bool()
    gate_types = gate_types.to(torch.int32)
    controls = controls.to(torch.int32)
    masked_types = torch.where(mask[:, :, None], gate_types, torch.zeros_like(gate_types))
    main_re, main_im, vdag_re, vdag_im, ph = slot_factors(masked_types, angles.float())

    # kron layers: K[0] = vdag[0]; K[k] = vdag[k] @ main[k-1]; K[L] = main[L-1]
    eye, zmat = _eye(main_re[:, :1, :, 0, 0])
    m_re = torch.cat([eye, main_re], dim=1)
    m_im = torch.cat([zmat, main_im], dim=1)
    d_re = torch.cat([vdag_re, eye], dim=1)
    d_im = torch.cat([vdag_im, zmat], dim=1)
    k_re = d_re @ m_re - d_im @ m_im
    k_im = d_re @ m_im + d_im @ m_re
    factors = torch.stack([k_re, k_im], dim=3).contiguous()

    eye_b = torch.eye(2, dtype=torch.float32, device=device)
    dev = (k_re - eye_b) ** 2 + k_im**2
    slot_active = dev.amax(dim=(-2, -1)) > 1e-14
    group_active = _group_activity(slot_active, n_qubits).contiguous()

    d_slots = max(n_qubits // 2, 1)
    is_crot = (gate_types == GATE_CROT) & mask[:, :, None]
    ident_ph = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float32, device=device)

    def compact(flags):
        order = torch.argsort((~flags).to(torch.int8), dim=2, stable=True)
        sorted_f = torch.gather(flags, 2, order)
        minus = torch.full_like(order, -1)
        tgt = torch.where(sorted_f, order, minus)[:, :, :d_slots]
        ctrl = torch.where(sorted_f, torch.gather(controls.long(), 2, order), minus)
        phases = torch.where(flags[..., None, None], ph, ident_ph)
        index = order[..., None, None].expand(*order.shape, 2, 2)
        ph_sorted = torch.gather(phases, 2, index)[:, :, :d_slots]
        count = flags.sum(dim=2, dtype=torch.int32)
        return (
            ctrl[:, :, :d_slots].to(torch.int32).contiguous(),
            tgt.to(torch.int32).contiguous(),
            ph_sorted.contiguous(),
            count.contiguous(),
        )

    if absorb_diag:
        tgt_q = torch.arange(n_qubits, device=device).expand_as(is_crot)
        g_t = torch.clamp(tgt_q // LANE_BITS, max=2)
        g_c = torch.clamp(controls.clamp(min=0).long() // LANE_BITS, max=2)
        group_ok = (g_t < 2) | (n_qubits <= 3 * LANE_BITS)
        kron_act = torch.gather(group_active[:, :n_layers].bool(), 2, g_t)
        absorbed = is_crot & (g_t == g_c) & group_ok & kron_act
    else:
        absorbed = torch.zeros_like(is_crot)
    ctrl, tgt, ph_sorted, count = compact(is_crot & ~absorbed)
    a_ctrl, a_tgt, a_ph, a_count = compact(absorbed)
    return FoldPipeline(
        factors=factors, diag_ctrl=ctrl, diag_tgt=tgt, diag_phase=ph_sorted,
        diag_count=count, group_active=group_active, abs_ctrl=a_ctrl, abs_tgt=a_tgt,
        abs_phase=a_ph, abs_count=a_count,
    )


def rotation_layer_factors(rot_types: torch.Tensor, rot_angles: torch.Tensor, n_qubits: int):
    """Kron-layer form of measurement basis-rotation layers ([G, n] ID/ROT
    slots, [G, n, 3] angles): ``(factors [G, n, 2, 2, 2] float32 with re/im
    at axis 2, activity [G, n_axis_groups] float32 0/1)``, the extra kron
    layer per group of the one-launch grouped sampler.  A group is active
    where a factor deviates from the identity by more than 1e-14, the
    reference's rule (``rotation_layer_factors``, fold_pipeline.py:402)."""
    main_re, main_im, _, _, _ = slot_factors(rot_types.to(torch.int32), rot_angles.float())
    factors = torch.stack([main_re, main_im], dim=2).contiguous()
    eye_b = torch.eye(2, dtype=torch.float32, device=main_re.device)
    dev = (main_re - eye_b) ** 2 + main_im**2
    slot_active = dev.amax(dim=(-2, -1)) > 1e-14
    return factors, _group_activity(slot_active, n_qubits).to(torch.float32)


def extend_fold_pipeline_with_rotation(
    pipeline: FoldPipeline, rot_type: torch.Tensor, rot_angle: torch.Tensor, n_qubits: int
) -> FoldPipeline:
    """Append one measurement basis-rotation layer ([n] ID/ROT slots, [n, 3]
    angles) to a built pipeline.

    A rotation layer holds single-qubit U3s only, so its Vdag factors are
    identities: the base kron layers stay as they are, the appended kron
    layer is the rotation's own U3 factors, and its diagonal pass is empty.
    Equal in value to :func:`build_fold_pipeline` of the genome with the
    layer appended (the reference's ``extend_fold_pipeline_with_rotation``,
    fold_pipeline.py:334)."""
    pop, _, _, _, _, _ = pipeline.factors.shape
    d_slots = pipeline.diag_ctrl.shape[2]
    device = pipeline.factors.device
    factors, activity = rotation_layer_factors(rot_type[None], rot_angle[None], n_qubits)
    new_factors = factors.expand(pop, 1, *factors.shape[1:])
    new_active = activity.to(torch.int32).expand(pop, 1, activity.shape[1])
    empty_idx = torch.full((pop, 1, d_slots), -1, dtype=torch.int32, device=device)
    empty_phase = torch.tensor(
        [[1.0, 0.0], [1.0, 0.0]], dtype=torch.float32, device=device
    ).expand(pop, 1, d_slots, 2, 2)
    empty_count = torch.zeros((pop, 1), dtype=torch.int32, device=device)

    def cat(old, new):
        return torch.cat([old, new], dim=1).contiguous()

    return FoldPipeline(
        factors=cat(pipeline.factors, new_factors),
        diag_ctrl=cat(pipeline.diag_ctrl, empty_idx),
        diag_tgt=cat(pipeline.diag_tgt, empty_idx),
        diag_phase=cat(pipeline.diag_phase, empty_phase),
        diag_count=cat(pipeline.diag_count, empty_count),
        group_active=cat(pipeline.group_active, new_active),
        abs_ctrl=cat(pipeline.abs_ctrl, empty_idx),
        abs_tgt=cat(pipeline.abs_tgt, empty_idx),
        abs_phase=cat(pipeline.abs_phase, empty_phase),
        abs_count=cat(pipeline.abs_count, empty_count),
    )


def cu3_slot_factors_reference(theta: float, phi: float, lam: float):
    """Complex (V, phase0, phase1) of a CU3's eigendecomposition -- test
    convenience over :func:`slot_factors`."""
    main_re, main_im, _, _, ph = slot_factors(
        torch.tensor(GATE_CROT), torch.tensor([theta, phi, lam], dtype=torch.float32)
    )
    v = torch.complex(main_re, main_im).to(torch.complex128)
    return v, complex(ph[0, 0], ph[0, 1]), complex(ph[1, 0], ph[1, 1])


# ---------------------------------------------------------------------------
# plain appliers
# ---------------------------------------------------------------------------


def _apply_factors(state: torch.Tensor, factors: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """One kron layer, qubit by qubit: complex ``state`` [P, 2^n] and
    ``factors`` [P, n, 2, 2, 2] (re/im at axis 2)."""
    pop = state.shape[0]
    mats = torch.complex(factors[:, :, 0], factors[:, :, 1])  # [P, n, 2, 2]
    for q in range(n_qubits):
        v = state.view(pop, 1 << (n_qubits - 1 - q), 2, 1 << q)
        state = torch.einsum("pab,phbl->phal", mats[:, q], v).reshape(pop, -1)
    return state


def _phase_weights(ctrl, tgt, phase, count, basis) -> torch.Tensor:
    """Diagonal of one layer's CDiag slots: ``ctrl``/``tgt`` [P, D],
    ``phase`` [P, D, 2, 2], ``count`` [P] used slots -> complex [P, 2^n]
    (unused slots hold -1)."""
    weights = torch.ones((ctrl.shape[0], basis.shape[0]), dtype=torch.complex64, device=basis.device)
    ph = torch.complex(phase[..., 0], phase[..., 1])  # [P, D, 2]
    for j in range(int(count.max()) if count.numel() else 0):
        c, t = ctrl[:, j].long(), tgt[:, j].long()
        cbit = (basis[None] >> c.clamp(min=0)[:, None]) & 1
        tbit = (basis[None] >> t.clamp(min=0)[:, None]) & 1
        value = torch.where(tbit == 1, ph[:, j, 1:2], ph[:, j, 0:1])
        on = (c[:, None] >= 0) & (cbit == 1)
        weights = weights * torch.where(on, value, torch.ones_like(value))
    return weights


def apply_fold_pipeline_plain(
    pipeline: FoldPipeline, n_qubits: int, initial: torch.Tensor | None = None
) -> torch.Tensor:
    """Apply the pipeline in float32 (complex64), factor by factor:
    [P, 2, 2^n] planes from |0...0> or per-individual ``initial`` planes.
    Absorbed phases apply right after their kron layer, as the kernels
    apply them."""
    factors = pipeline.factors
    pop, n_kron = factors.shape[0], factors.shape[1]
    dim = 1 << n_qubits
    device = factors.device
    if initial is None:
        state = torch.zeros((pop, dim), dtype=torch.complex64, device=device)
        state[:, 0] = 1.0
    else:
        initial = initial.float().expand(pop, 2, dim)
        state = torch.complex(initial[:, 0], initial[:, 1])
    basis = torch.arange(dim, device=device)
    for k in range(n_kron):
        state = _apply_factors(state, factors[:, k], n_qubits)
        if k < n_kron - 1:
            for prefix in ("diag", "abs"):
                ctrl, tgt, phase, count = (
                    getattr(pipeline, f"{prefix}_{field}")[:, k]
                    for field in ("ctrl", "tgt", "phase", "count")
                )
                state = state * _phase_weights(ctrl, tgt, phase, count, basis)
    return torch.stack([state.real, state.imag], dim=1).contiguous()


def simulate_circuits_folded(
    gate_types, controls, angles, layer_mask, n_qubits: int, initial_state=None
) -> torch.Tensor:
    """[P, L, n] genomes -> [P, 2, 2^n] states through the kron-fold
    transform, differentiable (the gradient optimizer's ``use_fold``
    objective); ``initial_state`` shared [2, 2^n] or per-individual
    [P, 2, 2^n].

    Each 2x2 factor applies with the slot engine's real pair arithmetic
    (``statevector.apply_u3_pairs``), so autograd sums each factor's
    gradient over its 2^(n-1) pairs with torch's reductions.  Through
    :func:`apply_fold_pipeline_plain`'s complex matmuls that sum is a
    GEMM's float32 accumulation over the pairs, which on the card left
    errors of 3e-4 * max|table| in gradients that are exactly zero (a final
    phase under a diagonal operator; n=20, P=16)."""
    from queasars_tpu_torch.sim.statevector import apply_u3_pairs

    pipeline = build_fold_pipeline(gate_types, controls, angles, layer_mask, n_qubits)
    factors = pipeline.factors
    pop, n_kron = factors.shape[0], factors.shape[1]
    dim = 1 << n_qubits
    device = factors.device
    if initial_state is None:
        state = torch.zeros((pop, 2, dim), dtype=torch.float32, device=device)
        state[:, 0, 0] = 1.0
    else:
        state = initial_state.float().expand(pop, 2, dim).clone()
    on = torch.ones(pop, dtype=torch.bool, device=device)
    basis = torch.arange(dim, device=device)
    for k in range(n_kron):
        for q in range(n_qubits):
            f = factors[:, k, q]  # [P, re/im, 2, 2]
            entries = tuple((f[:, 0, a, b], f[:, 1, a, b]) for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)))
            state = apply_u3_pairs(state, q, entries, on, ~on, on.long(), n_qubits)
        if k < n_kron - 1:
            weights = _phase_weights(pipeline.diag_ctrl[:, k], pipeline.diag_tgt[:, k],
                                     pipeline.diag_phase[:, k], pipeline.diag_count[:, k], basis)
            re, im, wr, wi = state[:, 0], state[:, 1], weights.real, weights.imag
            state = torch.stack([re * wr - im * wi, re * wi + im * wr], dim=1)
    return state


def _kron_chain(mats: torch.Tensor) -> torch.Tensor:
    """complex [m, 2, 2] -> [2^m, 2^m] with qubit j = bit j (little-endian)."""
    out = mats[0]
    for j in range(1, mats.shape[0]):
        out = torch.kron(mats[j], out)
    return out


def apply_fold_pipeline_reference(
    pipeline: FoldPipeline, n_qubits: int, initial: torch.Tensor | None = None
) -> torch.Tensor:
    """Apply the pipeline with dense kron matrices in complex128 (oracle):
    [P, 2, 2^n] float32 planes.  O(4^n) per kron layer -- test sizes only."""
    fac = pipeline.factors.double().cpu()
    fac = torch.complex(fac[:, :, :, 0], fac[:, :, :, 1])  # [P, L+1, n, 2, 2]
    pop, n_kron = fac.shape[0], fac.shape[1]
    dim = 1 << n_qubits
    basis = torch.arange(dim)
    out = torch.zeros((pop, 2, dim), dtype=torch.float32)
    for p in range(pop):
        if initial is None:
            state = torch.zeros(dim, dtype=torch.complex128)
            state[0] = 1.0
        else:
            init = initial[p].double().cpu()
            state = torch.complex(init[0], init[1])
        for k in range(n_kron):
            state = _kron_chain(fac[p, k]) @ state
            if k < n_kron - 1:
                for ctrl, tgt, phase in (
                    (pipeline.diag_ctrl, pipeline.diag_tgt, pipeline.diag_phase),
                    (pipeline.abs_ctrl, pipeline.abs_tgt, pipeline.abs_phase),
                ):
                    ph = phase[p, k].double().cpu()
                    for j in range(ctrl.shape[2]):
                        c, t = int(ctrl[p, k, j]), int(tgt[p, k, j])
                        if c < 0:
                            continue
                        on = ((basis >> c) & 1) == 1
                        value = torch.where(
                            ((basis >> t) & 1) == 1,
                            torch.complex(ph[j, 1, 0], ph[j, 1, 1]),
                            torch.complex(ph[j, 0, 0], ph[j, 0, 1]),
                        )
                        state = torch.where(on, state * value, state)
        out[p, 0] = state.real.float()
        out[p, 1] = state.imag.float()
    return out
