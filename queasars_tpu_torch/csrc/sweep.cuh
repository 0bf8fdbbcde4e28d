// The last-layer NFT sweep's step, shared by the slot and fold sweeps
// (slot_kernels.cu::qt_nft_layer_sweep, fold_kernels.cu::qt_fold_nft_sweep).
//
// Both compute the function of pallas_nft_layer_sweep: per step k every
// individual probes coordinate k mod n_free of its swept layer at +-pi/2,
// fits the sinusoid and, where it is active, moves to the minimum.  The
// energy of the circuit with the probed qubit q's gate at angle t is a
// scalar combination of nine pair sums of BASE = (the layer without q's
// gate) . prefix, weighted by q's U3 entries at t (form_energy).  The gates
// of one layer commute (a control qubit holds no rotation), so BASE moves
// only when the probed qubit does: from step k-1 to k it loses q_k's gate
// and gains q_{k-1}'s with its new angles.  Coordinates come three per gate,
// so most steps probe the qubit of the step before, and the sums stay valid.
//
// Per step on the host (launches only, no synchronisation):
//   * rebuild (k % reset_interval == 0, k = 0 included): sweep_select writes
//     q_k per individual, the route's own engine builds BASE from the prefix
//     with q_k's gate left out (the caller's ``rebuild``), and sweep_pass
//     reads BASE once for the nine sums; z0 is measured from them.  This
//     also bounds the float32 drift of the undo and redo below.
//   * transition (some individual's probed qubit changed, the host flag
//     ``transitions[k]``): one sweep_pass reads and writes BASE once,
//     re-applying q_{k-1}'s U3 or CU3 at its updated angles, undoing q_k's
//     with U3^dagger (where the control bit is 1 for a CU3) and summing the
//     nine pair sums for q_k.  Each individual decides on the card, from
//     coords and n_free, whether its own qubit changed; the others return at
//     once, and their partials stay as they were.
//   * every step: sweep_update, one thread per individual, forms z1, z3
//     (and z0 on a rebuild) from the sums and applies the 3-point update.
//     A step with no transition launches no pass over the state.
//
// Layout of a pass: a warp owns units of 128 amplitudes, 32 lanes x 4
// registers.  The lanes run along bits 0-4, so every warp access is one
// contiguous 128-byte line of a plane; the two register bits are the pass's
// gate bits where those are 5 or above (the lowest free bits otherwise) and
// the unit index fills the remaining bits.  A gate on a register bit pairs
// two registers of a thread; a gate on a lane bit pairs two lanes through
// __shfl_xor_sync, each lane computing its own output with common.cuh's
// u3_apply expressions.  So low gate bits cost shuffles, never uncoalesced
// lines, and no shared-memory tile is staged.  The sums: per thread in a
// fixed order, a fixed butterfly per warp, the block's warps in order, one
// partial per block, finished by energy_finish (no float atomics): equal
// inputs give equal bits, as an EVQE trajectory branches on energy order.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kHalfPi = 1.57079632679489662f;
constexpr float kPi = 3.14159265358979324f;
constexpr int kPairSums = 9;
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSweepUnits = 4;  // units per warp and block
constexpr int kUnitBits = 7;    // a unit: 2^5 lanes x 2^2 registers

// What the shared step reads and writes ([P, ...] per individual).
struct SweepArgs {
  float* angles;                // [P, n, 3] current angles (the output)
  float* z;                     // [P] recycled energies (the output)
  float* base;                  // [P, 2, 2^n] BASE planes
  float* partial;               // [P, 9, sweep_blocks(n)] pair-sum partials
  float* sums;                  // [P, 9] pair sums of the current BASE
  int* probe;                   // [P] the probed qubit of the last rebuild
  const int* gate_types;        // [P, n] the swept layer
  const int* controls;          // [P, n] a CU3's control (read for CU3 only)
  const int* coords;            // [P, K, 2] (qubit, angle)
  const int* n_free;            // [P]
  const unsigned char* active;  // [P]
  const float* table;           // [2^n]
  int pop, n_qubits, k_max;
};

// First-pass blocks of a sweep pass per individual.
__host__ __device__ int sweep_blocks(int n) {
  const int units = n > kUnitBits ? 1 << (n - kUnitBits) : 1;
  return (units + kSweepWarps * kSweepUnits - 1) / (kSweepWarps * kSweepUnits);
}

__device__ __forceinline__ bool is_gated(int type) { return type == kGateRot || type == kGateCrot; }

// Coordinate k mod n_free of individual p: (qubit, angle).
__device__ __forceinline__ int2 probed_coord(const SweepArgs& w, int p, int k) {
  const int idx = k % max(w.n_free[p], 1);
  const int* c = w.coords + ((long long)p * w.k_max + idx) * 2;
  return make_int2(min(max(c[0], 0), w.n_qubits - 1), min(max(c[1], 0), 2));
}

__global__ void sweep_select(SweepArgs w, int k) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < w.pop) w.probe[p] = probed_coord(w, p, k).x;
}

__device__ __forceinline__ U3 u3_dagger(const U3& u) {
  return U3{u.u00r, -u.u00i, u.u10r, -u.u10i, u.u01r, -u.u01i, u.u11r, -u.u11i};
}

// A gate of a pass: U on bit ``bit`` where bit ``ctrl`` is 1 (ctrl < 0:
// everywhere); bit < 0: no gate.
struct PassGate {
  U3 u;
  int bit, ctrl;
};

// Gate g on a unit's four registers per plane; idx[j] is register j's
// amplitude index, REG the register mask of g's bit (0: a lane bit).  REG
// is a template argument so that every register index is a constant and
// the arrays stay in registers.
template <int REG>
__device__ __forceinline__ void unit_gate(const PassGate& g, float (&xr)[4], float (&xi)[4],
                                          const unsigned (&idx)[4], int lane) {
  if constexpr (REG != 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((j & REG) != 0 || (g.ctrl >= 0 && ((idx[j] >> g.ctrl) & 1u) == 0)) continue;
      u3_apply(g.u, xr[j], xi[j], xr[j | REG], xi[j | REG]);
    }
  } else {
    const int m = 1 << g.bit;
    const bool high = (lane & m) != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pr = __shfl_xor_sync(0xffffffffu, xr[j], m);
      const float pi = __shfl_xor_sync(0xffffffffu, xi[j], m);
      if (g.ctrl >= 0 && ((idx[j] >> g.ctrl) & 1u) == 0) continue;
      const float r = xr[j], i = xi[j];
      const U3& u = g.u;
      if (high) {
        xr[j] = sum4(u.u11r, r, -u.u11i, i, u.u10r, pr, -u.u10i, pi);
        xi[j] = sum4(u.u11r, i, u.u11i, r, u.u10r, pi, u.u10i, pr);
      } else {
        xr[j] = sum4(u.u00r, r, -u.u00i, i, u.u01r, pr, -u.u01i, pi);
        xi[j] = sum4(u.u00r, i, u.u00i, r, u.u01r, pi, u.u01i, pr);
      }
    }
  }
}

__device__ __forceinline__ void unit_gate(const PassGate& g, int reg, float (&xr)[4],
                                          float (&xi)[4], const unsigned (&idx)[4], int lane) {
  if (reg == 1) {
    unit_gate<1>(g, xr, xi, idx, lane);
  } else if (reg == 2) {
    unit_gate<2>(g, xr, xi, idx, lane);
  } else {
    unit_gate<0>(g, xr, xi, idx, lane);
  }
}

// A unit's share of the nine pair sums around qubit q (sweep_pass), REG the
// register mask of q's bit (0: a lane bit); cs is q's CU3 control (-1:
// none).
template <int REG>
__device__ __forceinline__ void unit_sums(float (&acc)[kPairSums], const float (&xr)[4],
                                          const float (&xi)[4], const float (&tv)[4],
                                          const unsigned (&idx)[4], const bool (&in)[4], int q,
                                          int cs) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float br, bi, tb;
    if constexpr (REG != 0) {
      br = xr[j ^ REG], bi = xi[j ^ REG], tb = tv[j ^ REG];
    } else {
      br = __shfl_xor_sync(0xffffffffu, xr[j], 1 << q);
      bi = __shfl_xor_sync(0xffffffffu, xi[j], 1 << q);
      tb = __shfl_xor_sync(0xffffffffu, tv[j], 1 << q);
    }
    if (!in[j]) continue;
    const float ar = xr[j], ai = xi[j], ta = tv[j];
    const float abs_a = ar * ar + ai * ai;
    if (cs >= 0 && ((idx[j] >> cs) & 1u) == 0) {
      acc[0] += ta * abs_a;
      continue;
    }
    if (((idx[j] >> q) & 1u) != 0) continue;
    const float abs_b = br * br + bi * bi;
    const float cr = ar * br + ai * bi, ci = ai * br - ar * bi;
    acc[1] += ta * abs_a;
    acc[2] += ta * abs_b;
    acc[3] += ta * cr;
    acc[4] += ta * ci;
    acc[5] += tb * abs_a;
    acc[6] += tb * abs_b;
    acc[7] += tb * cr;
    acc[8] += tb * ci;
  }
}

// One pass over BASE of every individual that acts at step k (rebuild:
// all, sums only; otherwise those whose probed qubit changed: redo the last
// qubit's gate, undo this one's, write BASE) and its nine pair sums around
// the probed qubit q into partial: f0 = sum T |x|^2 where q's CU3 control
// bit is 0, and where the gate acts (control bit 1, or a U3) over pairs
// (i0 with bit q clear, i1 = i0 | 2^q; a = x[i0], b = x[i1]):
// f1..f4 = sum T(i0) (|a|^2, |b|^2, Re a b*, Im a b*), f5..f8 with T(i1).
__global__ void __launch_bounds__(kSweepThreads)
    sweep_pass(SweepArgs w, int k, int rebuild) {
  __shared__ PassGate gate_s[2];  // redo, undo
  __shared__ int meta_s[3];       // acts, probed qubit, its sums control
  __shared__ float warp_s[kSweepWarps][kPairSums];
  const int p = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = w.n_qubits;
  if (t == 0) {
    const int* types = w.gate_types + (long long)p * n;
    const int* ctrls = w.controls + (long long)p * n;
    const int q = probed_coord(w, p, k).x;
    int acts = 1;
    PassGate redo{U3{}, -1, -1}, undo{U3{}, -1, -1};
    if (!rebuild) {
      const int last = probed_coord(w, p, k - 1).x;
      acts = w.active[p] && w.n_free[p] > 0 && last != q;
      if (acts && is_gated(types[last])) {
        const float* a = w.angles + ((long long)p * n + last) * 3;
        redo = PassGate{u3_entries(a[0], a[1], a[2]), last,
                        types[last] == kGateCrot ? ctrls[last] : -1};
      }
      if (acts && is_gated(types[q])) {
        const float* a = w.angles + ((long long)p * n + q) * 3;
        undo = PassGate{u3_dagger(u3_entries(a[0], a[1], a[2])), q,
                        types[q] == kGateCrot ? ctrls[q] : -1};
      }
    }
    gate_s[0] = redo;
    gate_s[1] = undo;
    meta_s[0] = acts;
    meta_s[1] = q;
    meta_s[2] = types[q] == kGateCrot ? ctrls[q] : -1;
  }
  __syncthreads();
  if (!meta_s[0]) return;
  const PassGate redo = gate_s[0], undo = gate_s[1];
  const int q = meta_s[1], cs = meta_s[2];
  const bool write = redo.bit >= 0 || undo.bit >= 0;

  // register bits r0 < r1: the pass's gate bits >= 5, then the lowest
  // other bits >= 5 (past n - 1 below 7 qubits: those registers lie
  // outside the state)
  const int a = redo.bit >= 5 ? redo.bit : -1, b = q >= 5 ? q : -1;
  const int lone = max(a, b), spare = lone == 5 ? 6 : 5;  // lone: the one gate bit >= 5
  const int r0 = a >= 0 && b >= 0 ? min(a, b) : lone < 0 ? 5 : min(lone, spare);
  const int r1 = a >= 0 && b >= 0 ? max(a, b) : lone < 0 ? 6 : max(lone, spare);
  const auto reg_of = [&](int bit) { return bit == r0 ? 1 : bit == r1 ? 2 : 0; };
  const int redo_reg = reg_of(redo.bit), undo_reg = reg_of(undo.bit), q_reg = reg_of(q);

  const unsigned dim = 1u << n;
  const unsigned units = n > kUnitBits ? 1u << (n - kUnitBits) : 1u;
  float* re = w.base + (long long)p * 2 * (1LL << n);
  float* im = re + (1LL << n);
  float acc[kPairSums];
#pragma unroll
  for (int s = 0; s < kPairSums; ++s) acc[s] = 0.0f;

  for (int i = 0; i < kSweepUnits; ++i) {
    const unsigned u = (blockIdx.x * kSweepUnits + i) * kSweepWarps + warp;
    if (u >= units) break;
    unsigned base = u << 5;
    base = ((base >> r0) << (r0 + 1)) | (base & ((1u << r0) - 1));
    base = ((base >> r1) << (r1 + 1)) | (base & ((1u << r1) - 1));
    unsigned idx[4];
    bool in[4];
    float xr[4], xi[4], tv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      idx[j] = base | lane | ((unsigned)(j & 1) << r0) | ((unsigned)(j >> 1) << r1);
      in[j] = idx[j] < dim;
      xr[j] = in[j] ? re[idx[j]] : 0.0f;
      xi[j] = in[j] ? im[idx[j]] : 0.0f;
      tv[j] = in[j] ? w.table[idx[j]] : 0.0f;
    }
    if (redo.bit >= 0) unit_gate(redo, redo_reg, xr, xi, idx, lane);
    if (undo.bit >= 0) unit_gate(undo, undo_reg, xr, xi, idx, lane);
    if (write) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (in[j]) re[idx[j]] = xr[j], im[idx[j]] = xi[j];
      }
    }
    if (q_reg == 1) {
      unit_sums<1>(acc, xr, xi, tv, idx, in, q, cs);
    } else if (q_reg == 2) {
      unit_sums<2>(acc, xr, xi, tv, idx, in, q, cs);
    } else {
      unit_sums<0>(acc, xr, xi, tv, idx, in, q, cs);
    }
  }
#pragma unroll
  for (int s = 0; s < kPairSums; ++s) {
    float v = acc[s];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (lane == 0) warp_s[warp][s] = v;
  }
  __syncthreads();
  if (t < kPairSums) {
    float total = 0.0f;
    for (int v = 0; v < kSweepWarps; ++v) total += warp_s[v][t];
    w.partial[((long long)p * kPairSums + t) * gridDim.x + blockIdx.x] = total;
  }
}

// E(t) of the probed coordinate at value t from the nine pair sums: the
// probed gate's U3 entries at t weight the sums (the reference's
// form_energy, pallas_fold_kernels.py:1545-1579).
__device__ float form_energy(const float* f, const float* angle, int a_i, bool gated, float t) {
  const float te = a_i == 0 ? t : angle[0];
  const float pe = a_i == 1 ? t : angle[1];
  const float le = a_i == 2 ? t : angle[2];
  const float ch = cosf(te * 0.5f), sh = sinf(te * 0.5f);
  const float u00r = gated ? ch : 1.0f, u00i = 0.0f;
  const float u01r = gated ? -cosf(le) * sh : 0.0f, u01i = gated ? -sinf(le) * sh : 0.0f;
  const float u10r = gated ? cosf(pe) * sh : 0.0f, u10i = gated ? sinf(pe) * sh : 0.0f;
  const float u11r = gated ? cosf(pe + le) * ch : 1.0f;
  const float u11i = gated ? sinf(pe + le) * ch : 0.0f;
  const float c1 = u00r * u00r + u00i * u00i, c2 = u01r * u01r + u01i * u01i;
  const float re01 = u00r * u01r + u00i * u01i, im01 = u00i * u01r - u00r * u01i;
  const float c5 = u10r * u10r + u10i * u10i, c6 = u11r * u11r + u11i * u11i;
  const float re11 = u10r * u11r + u10i * u11i, im11 = u10i * u11r - u10r * u11i;
  return f[0] + c1 * f[1] + c2 * f[2] + 2.0f * re01 * f[3] - 2.0f * im01 * f[4] + c5 * f[5] +
         c6 * f[6] + 2.0f * re11 * f[7] - 2.0f * im11 * f[8];
}

// One NFT step per individual: z0 (measured from the sums on a rebuild),
// z1 and z3 from the sums, and the 3-point update with atan2f in place of
// the reference's polynomial (_nft_layer_sweep_kernel, pallas_kernels.py:
// 809-818).  step == 0: only z0 (a sweep of no step).
__global__ void sweep_update(SweepArgs w, int k, int measure, int step) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= w.pop) return;
  const int n = w.n_qubits;
  const int2 c = probed_coord(w, p, k);
  const int q = c.x, a_i = c.y;
  const bool gated = is_gated(w.gate_types[(long long)p * n + q]);
  float* angle = w.angles + ((long long)p * n + q) * 3;
  const float* f = w.sums + (long long)p * kPairSums;
  const float theta = angle[a_i];
  const float z0 = measure ? form_energy(f, angle, a_i, gated, theta) : w.z[p];
  if (!step) {
    w.z[p] = z0;
    return;
  }
  const float z1 = form_energy(f, angle, a_i, gated, theta + kHalfPi);
  const float z3 = form_energy(f, angle, a_i, gated, theta - kHalfPi);
  const float mid = (z1 + z3) * 0.5f;
  const float half_diff = (z1 - z3) * 0.5f;
  const float d = z0 - mid;
  const bool apply = w.active[p] && w.n_free[p] > 0;
  if (apply) angle[a_i] = theta + atan2f(half_diff, d) + kPi;
  w.z[p] = apply ? mid - sqrtf(d * d + half_diff * half_diff) : z0;
}

// The sweep's step loop (enqueues only).  angles must already hold the start
// angles.  rebuild() enqueues the route's BASE = (layer without probe[p]'s
// gate) . prefix into w.base and returns its launch status; transitions is
// a HOST array of maxiter flags, 1 where some individual that the sweep
// moves probes another qubit than at the step before.
template <class Rebuild>
cudaError_t run_sweep(const SweepArgs& w, const unsigned char* transitions, int maxiter,
                      int reset_interval, Rebuild rebuild, cudaStream_t s) {
  if (w.n_qubits < 1 || w.n_qubits > 31 || reset_interval < 1 || maxiter < 0 ||
      (maxiter > 0 && transitions == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int blocks = sweep_blocks(w.n_qubits);
  const unsigned int small = blocks_for(w.pop, 128);
  const dim3 grid(blocks, w.pop);
  for (int k = 0; k < (maxiter > 0 ? maxiter : 1); ++k) {
    const int reset = k % reset_interval == 0;
    if (reset) {
      sweep_select<<<small, 128, 0, s>>>(w, k);
      const cudaError_t err = rebuild();
      if (err != cudaSuccess) return err;
    }
    if (reset || transitions[k]) {
      sweep_pass<<<grid, kSweepThreads, 0, s>>>(w, k, reset);
      energy_finish<<<w.pop * kPairSums, kReduceThreads, 0, s>>>(w.partial, w.sums, blocks);
    }
    sweep_update<<<small, 128, 0, s>>>(w, k, reset, k < maxiter);
  }
  return cudaGetLastError();
}

}  // namespace
