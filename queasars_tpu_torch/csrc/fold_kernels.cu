// Kron-fold circuit kernels for Hopper (sm_90a) behind a plain C interface.
//
// Counterparts of the six fold kernels of queasars_tpu/sim/
// pallas_fold_kernels.py (pallas_energies_exact_folded,
// pallas_population_states_folded, pallas_nft_layer_sweep_folded,
// pallas_population_probs_folded, pallas_sampled_shot_energies_folded,
// pallas_grouped_shot_energies_folded).
// Built with the slot kernels by one nvcc call and bound with ctypes
// (queasars_tpu_torch/utils/cuda_lib.py); every entry point takes raw device
// pointers plus the caller's stream, launches on that stream, never
// synchronises, allocates nothing and returns cudaGetLastError().
//
// Input: the FoldPipeline tensors of queasars_tpu_torch/sim/fold_pipeline.py
// read as they are (no packing): a circuit is L+1 kron layers of per-qubit
// complex 2x2 factors and L controlled-diagonal phase passes.  States are
// [P, 2, 2^n] float32 planes in device memory; basis index i holds qubit q in
// bit q.
//
// Design.  A TPU program holds a whole state in VMEM and applies a kron layer
// as one MXU matmul per 7-qubit axis group.  Here a state (8 MB at n=20) lives
// in device memory and a group apply is a batched complex GEMM in fp32 on the
// CUDA cores (no TF32: the 1e-5 gate):
//   * group apply: for the group's bits [q0, q0+m) (S = 2^m <= 128), out[hi, i,
//     lo] = sum_j U[i, j] x[hi, j, lo] with U[i, j] = d_i prod_q A_q[bit_q(i),
//     bit_q(j)] (d_i: the absorbed same-group phases, a row scale).  A block
//     owns TC whole columns (hi, lo) of one individual: it streams them in
//     chunks of JC rows through shared memory next to the matching U chunk,
//     which it builds from the 2x2 factors itself (about 1/(2 TC) of its FMAs),
//     keeps a 32-entry complex register tile per thread, and writes the
//     columns back in place once every row has been read.  A block whose
//     group is inactive in that kron layer returns at once.  Bound: FP32 FMAs
//     (2^n * S complex multiply-adds per active group and individual, ~1 GFLOP
//     at n=20, S=128), not bytes (two passes over 16 MB per group).
//   * diagonal pass: one thread per amplitude applies the layer's compacted
//     CDiag phases where the control bit is set (bytes-bound).
//   * epilogues: probabilities, the planes themselves, the energy through
//     the fixed-order two-pass reduction of common.cuh (no float atomics), or
//     sampled shot indices through the hierarchical inverse CDF of
//     sampler.cuh.  The TPU ran its sampled kernel at single-pass bf16
//     (precision="default"); here it runs in fp32 like every fold kernel,
//     closer to the exact state.
//   * grouped sampler: the circuit runs once into a work buffer; then, per QWC
//     measurement group, the work planes are copied into a second buffer, the
//     group's rotation kron layer is applied there by the same apply_group<M>
//     launches a circuit's kron layer uses (inactive axis groups exit at
//     once), and the epilogue samples that group's shots.  A group with no
//     rotation (a Z-basis group) samples the work planes themselves.  The
//     arithmetic per group is that of the sampled kernel on the circuit with
//     the rotation layer appended, so both give equal bits.  The TPU kernel
//     keeps the base state in VMEM and restores it per group; here the copy
//     costs one more pass over the planes per rotated group.
//   * NFT sweep: the step loop runs on the host side of this library and only
//     enqueues launches.  Per step: BASE = REST . prefix (the swept layer with
//     the probed qubit's factors and CDiag slot replaced by the identity), nine
//     pair sums over (base[i], base[i ^ 2^q], table[i], table[i ^ 2^q]) in a
//     fixed order, then one thread per individual forms z1 and z3 (and z0 on
//     reset steps) as scalar combinations of the sums, applies the 3-point
//     update with atan2f and rebuilds that qubit's factors.
//
// Tensor cores (3xTF32 wgmma), TMA staging and shared-memory-resident low
// groups are later work.

#include <cuda_runtime.h>

#include "common.cuh"
#include "sampler.cuh"

namespace {

constexpr int kGateRot = 1;
constexpr int kGateCrot = 3;
constexpr int kLaneBits = 7;
constexpr int kGroupThreads = 256;
constexpr int kPairSums = 9;
constexpr float kHalfPi = 1.57079632679489662f;
constexpr float kPi = 3.14159265358979324f;

// The pipeline tensors of one population (FoldPipeline field by field).
struct Fold {
  const float* factors;       // [P, K, n, 2 (re/im), 2, 2], K = n_kron
  const int* group_active;    // [P, K, G]
  const int* diag_ctrl;       // [P, K-1, D]
  const int* diag_tgt;        // [P, K-1, D]
  const float* diag_phase;    // [P, K-1, D, 2 (target bit), 2 (re/im)]
  const int* diag_count;      // [P, K-1]
  const int* abs_ctrl;        // absorbed slots, same layout; null = none
  const int* abs_tgt;
  const float* abs_phase;
  const int* abs_count;
  const int* exclude;         // [P] qubit whose factors and CDiag slot act as
                              // the identity (the sweep's REST); null = none
  int n_kron;
  int n_qubits;
  int d_slots;
  int n_groups;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Tile shape of a group apply with S = 2^M rows: RT x CT threads, each with
// RPT rows x CPT columns of accumulators (32 complex values), TC columns per
// block, JC rows per shared-memory chunk.
template <int M>
struct GroupShape {
  static constexpr int S = 1 << M;
  static constexpr int RT = S < 16 ? S : 16;
  static constexpr int CT = kGroupThreads / RT;
  static constexpr int RPT = S / RT;
  static constexpr int CPT = (32 / RPT) < (512 / CT) ? (32 / RPT) : (512 / CT);
  static constexpr int TC = CT * CPT;
  static constexpr int JC0 = S < 16 ? S : 16;
  static constexpr int JC = JC0 < (2048 / TC) ? JC0 : (2048 / TC);
};

// One kron layer's group apply on bits [q0, q0 + M) of every active
// individual's state, in place.  ``absorb`` row-scales U by the layer's
// absorbed CDiag phases (set only when [q0, q0 + M) is the whole group).
// Semantics of _build_group_fold / _absorb_group_rows / _apply_kron_layer
// (pallas_fold_kernels.py:110-316).
template <int M>
__global__ void __launch_bounds__(kGroupThreads)
    apply_group(float* state, Fold f, int k, int g, int q0, int absorb) {
  using Shape = GroupShape<M>;
  constexpr int S = Shape::S, RT = Shape::RT, CT = Shape::CT, RPT = Shape::RPT;
  constexpr int CPT = Shape::CPT, TC = Shape::TC, JC = Shape::JC;
  const int p = blockIdx.y;
  if (f.group_active[((long long)p * f.n_kron + k) * f.n_groups + g] == 0) return;

  __shared__ float2 fac_s[M][4];
  __shared__ float2 row_s[S];
  __shared__ float2 u_s[JC][S];
  __shared__ float2 x_s[JC][TC + 1];

  const int n = f.n_qubits;
  const int t = threadIdx.x;
  const long long dim = 1LL << n;
  const long long low = 1LL << q0;
  const long long n_cols = dim >> M;
  const long long c0 = (long long)blockIdx.x * TC;
  float* re = state + (long long)p * 2 * dim;
  float* im = re + dim;

  const int excl = f.exclude != nullptr ? f.exclude[p] : -1;
  if (t < M * 4) {
    const int jq = t >> 2, e = t & 3;  // e = bi * 2 + bj
    const int q = q0 + jq;
    const float* a = f.factors + (((long long)p * f.n_kron + k) * n + q) * 8;
    float2 v = make_float2(a[e], a[4 + e]);
    if (q == excl) v = make_float2((e == 0 || e == 3) ? 1.0f : 0.0f, 0.0f);
    fac_s[jq][e] = v;
  }
  for (int i = t; i < S; i += kGroupThreads) {
    float2 d = make_float2(1.0f, 0.0f);
    if (absorb) {
      const long long base = (long long)p * (f.n_kron - 1) + k;
      const int count = f.abs_count[base];
      for (int j = 0; j < count; ++j) {
        const long long slot = base * f.d_slots + j;
        const int c = f.abs_ctrl[slot], tq = f.abs_tgt[slot];
        if (c < q0 || c >= q0 + M || ((i >> (c - q0)) & 1) == 0) continue;
        const int tl = min(max(tq - q0, 0), M - 1);
        const float* ph = f.abs_phase + (slot * 2 + ((i >> tl) & 1)) * 2;
        d = cmul(d, make_float2(ph[0], ph[1]));
      }
    }
    row_s[i] = d;
  }
  __syncthreads();

  // lane group (low == 1): a column is S contiguous amplitudes, so threads
  // run along rows; otherwise neighbouring columns are neighbouring lo.
  const bool lane_major = low == 1;
  const int tr = lane_major ? t % RT : t / CT;
  const int tc = lane_major ? t / RT : t % CT;

  float2 acc[RPT][CPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int b = 0; b < CPT; ++b) acc[a][b] = make_float2(0.0f, 0.0f);

  for (int j0 = 0; j0 < S; j0 += JC) {
    for (int e = t; e < JC * S; e += kGroupThreads) {
      const int i = e % S, j = j0 + e / S;
      float2 u = fac_s[0][((i & 1) << 1) | (j & 1)];
#pragma unroll
      for (int jq = 1; jq < M; ++jq) {
        u = cmul(u, fac_s[jq][(((i >> jq) & 1) << 1) | ((j >> jq) & 1)]);
      }
      u_s[e / S][i] = cmul(u, row_s[i]);
    }
    for (int e = t; e < JC * TC; e += kGroupThreads) {
      const int jj = lane_major ? e % JC : e / TC;
      const int cc = lane_major ? e / JC : e % TC;
      const long long c = c0 + cc;
      float2 x = make_float2(0.0f, 0.0f);
      if (c < n_cols) {
        const long long idx = ((c >> q0) << (q0 + M)) + ((long long)(j0 + jj) << q0) + (c & (low - 1));
        x = make_float2(re[idx], im[idx]);
      }
      x_s[jj][cc] = x;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      float2 u[RPT], x[CPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a) u[a] = u_s[jj][tr + RT * a];
#pragma unroll
      for (int b = 0; b < CPT; ++b) x[b] = x_s[jj][tc + CT * b];
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
#pragma unroll
        for (int b = 0; b < CPT; ++b) {
          acc[a][b].x = fmaf(u[a].x, x[b].x, fmaf(-u[a].y, x[b].y, acc[a][b].x));
          acc[a][b].y = fmaf(u[a].x, x[b].y, fmaf(u[a].y, x[b].x, acc[a][b].y));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int b = 0; b < CPT; ++b) {
    const long long c = c0 + tc + CT * b;
    if (c >= n_cols) continue;
    const long long col = ((c >> q0) << (q0 + M)) + (c & (low - 1));
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const long long idx = col + ((long long)(tr + RT * a) << q0);
      re[idx] = acc[a][b].x;
      im[idx] = acc[a][b].y;
    }
  }
}

template <int M>
void launch_group(float* state, const Fold& f, int pop, int k, int g, int q0, int absorb,
                  cudaStream_t s) {
  const long long n_cols = (1LL << f.n_qubits) >> M;
  const dim3 grid(blocks_for(n_cols, GroupShape<M>::TC), pop);
  apply_group<M><<<grid, kGroupThreads, 0, s>>>(state, f, k, g, q0, absorb);
}

void launch_group_bits(float* state, const Fold& f, int pop, int k, int g, int q0, int m,
                       int absorb, cudaStream_t s) {
  switch (m) {
    case 1: launch_group<1>(state, f, pop, k, g, q0, absorb, s); break;
    case 2: launch_group<2>(state, f, pop, k, g, q0, absorb, s); break;
    case 3: launch_group<3>(state, f, pop, k, g, q0, absorb, s); break;
    case 4: launch_group<4>(state, f, pop, k, g, q0, absorb, s); break;
    case 5: launch_group<5>(state, f, pop, k, g, q0, absorb, s); break;
    case 6: launch_group<6>(state, f, pop, k, g, q0, absorb, s); break;
    default: launch_group<7>(state, f, pop, k, g, q0, absorb, s); break;
  }
}

// Kron layer k: one group apply per axis group (lane q<7, row 7<=q<14, top
// q>=14).  A top group of 8 bits (n=22) applies as two sub-kron factors of 4
// bits; the pipeline absorbs no phase into it at that size.
void apply_kron_layer(float* state, const Fold& f, int pop, int k, cudaStream_t s) {
  const int absorb = (k < f.n_kron - 1 && f.abs_count != nullptr) ? 1 : 0;
  for (int g = 0; g < f.n_groups; ++g) {
    const int q0 = g * kLaneBits;
    const int m = (g == f.n_groups - 1 ? f.n_qubits : q0 + kLaneBits) - q0;
    if (m <= kLaneBits) {
      launch_group_bits(state, f, pop, k, g, q0, m, absorb, s);
    } else {
      const int half = m / 2;
      launch_group_bits(state, f, pop, k, g, q0, half, 0, s);
      launch_group_bits(state, f, pop, k, g, q0 + half, m - half, 0, s);
    }
  }
}

// Layer k's controlled-diagonal phases: for each compacted slot, where the
// control bit is 1, multiply by the phase the target bit selects
// (_apply_diag_pass, pallas_fold_kernels.py:318-383).
__global__ void diag_pass(float* state, Fold f, int k, long long dim) {
  const int p = blockIdx.y;
  const long long base = (long long)p * (f.n_kron - 1) + k;
  const int count = f.diag_count[base];
  if (count == 0) return;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= dim) return;
  const int excl = f.exclude != nullptr ? f.exclude[p] : -1;
  float* re = state + (long long)p * 2 * dim;
  float* im = re + dim;
  float2 v = make_float2(re[i], im[i]);
  bool changed = false;
  for (int j = 0; j < count; ++j) {
    const long long slot = base * f.d_slots + j;
    const int c = f.diag_ctrl[slot], tq = f.diag_tgt[slot];
    if (tq == excl || ((i >> c) & 1) == 0) continue;
    const float* ph = f.diag_phase + (slot * 2 + ((i >> tq) & 1)) * 2;
    v = cmul(make_float2(ph[0], ph[1]), v);
    changed = true;
  }
  if (changed) {
    re[i] = v.x;
    im[i] = v.y;
  }
}

// Start from |0...0> or initial, then every kron layer and diagonal pass.
cudaError_t run_folded(float* state, const float* initial, int pop, const Fold& f,
                       cudaStream_t s) {
  const long long dim = 1LL << f.n_qubits;
  cudaError_t err = init_states(state, initial, pop, dim, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks_for(dim, kPairThreads), pop);
  for (int k = 0; k < f.n_kron; ++k) {
    apply_kron_layer(state, f, pop, k, s);
    if (k < f.n_kron - 1) diag_pass<<<grid, kPairThreads, 0, s>>>(state, f, k, dim);
  }
  return cudaGetLastError();
}

Fold make_fold(const float* factors, const int* diag_ctrl, const int* diag_tgt,
               const float* diag_phase, const int* diag_count, const int* group_active,
               const int* abs_ctrl, const int* abs_tgt, const float* abs_phase,
               const int* abs_count, int n_kron, int n_qubits, int d_slots) {
  const int groups = (n_qubits + kLaneBits - 1) / kLaneBits;
  const int n_groups = groups < 3 ? groups : 3;
  return Fold{factors, group_active, diag_ctrl, diag_tgt, diag_phase, diag_count, abs_ctrl,
              abs_tgt, abs_phase, abs_count, nullptr, n_kron, n_qubits, d_slots, n_groups};
}

// ---------------------------------------------------------------------------
// folded NFT sweep
// ---------------------------------------------------------------------------

// A slot's kron factors from its angles (fold_pipeline.slot_factors; the
// reference's _refresh_layer_slot): main = U3 (ROT) / V (CROT) / I and
// vdag = V^dagger (CROT) / I, each [2 (re/im), 2, 2]; for a CROT also the
// CDiag phases (phase0 re, im, phase1 re, im).
__device__ void slot_factors(int gate, const float* angle, float* main, float* vdag,
                             float* phase) {
  const float theta = angle[0], phi = angle[1], lam = angle[2];
  const float half = theta * 0.5f, s = (phi + lam) * 0.5f, a = (phi - lam) * 0.5f;
  const float ch = cosf(half), sh = sinf(half), cs = cosf(s), ss = sinf(s);
  const bool rot = gate == kGateRot, crot = gate == kGateCrot;
  float m[8] = {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float d[8] = {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (rot) {
    const float u[8] = {ch, -cosf(lam) * sh, cosf(phi) * sh, cosf(phi + lam) * ch,
                        0.0f, -sinf(lam) * sh, sinf(phi) * sh, sinf(phi + lam) * ch};
    for (int e = 0; e < 8; ++e) m[e] = u[e];
  }
  if (crot) {
    const float cos_d2 = ch * cs, mz = ch * ss, my = sh * cosf(a), mx = -sh * sinf(a);
    const float xy_sq = mx * mx + my * my;
    const bool xy_zero = xy_sq == 0.0f;
    const float nxy = sqrtf(xy_sq);
    const float sin_d2 = sqrtf(nxy * nxy + mz * mz);
    const float d_half = atan2f(sin_d2, cos_d2);
    const float ph0 = s - d_half, ph1 = s + d_half;
    phase[0] = cosf(ph0);
    phase[1] = sinf(ph0);
    phase[2] = cosf(ph1);
    phase[3] = sinf(ph1);
    if (!(sin_d2 < 1e-7f)) {
      const float mz_b = (xy_zero && mz == 0.0f) ? 1.0f : mz;
      const float b_half = atan2f(nxy, mz_b) * 0.5f;
      const float c = atan2f(xy_zero ? 0.0f : my, xy_zero ? 1.0f : mx);
      const float cb = cosf(b_half), sb = sinf(b_half), cc = cosf(c), sc = sinf(c);
      const float v[8] = {cb, -sb * cc, sb * cc, cb, 0.0f, sb * sc, sb * sc, 0.0f};
      for (int e = 0; e < 8; ++e) m[e] = v[e];
      // V^dagger: transpose, conjugate
      const float w[8] = {v[0], v[2], v[1], v[3], -v[4], -v[6], -v[5], -v[7]};
      for (int e = 0; e < 8; ++e) d[e] = w[e];
    }
  }
  for (int e = 0; e < 8; ++e) {
    main[e] = m[e];
    vdag[e] = d[e];
  }
}

struct Sweep {
  float* factors;             // [P, 2, n, 8]: kron 0 = vdag, kron 1 = main
  float* phase;               // [P, 1, D, 4]
  int* exclude;               // [P] probed qubit of the current step
  const int* gate_types;      // [P, n]
  const int* coords;          // [P, K, 2] (qubit, angle)
  const int* n_free;          // [P]
  const unsigned char* active;  // [P]
  const int* diag_ctrl;       // [P, 1, D]
  const int* slot_of_q;       // [P, 1, n]
  int pop, n_qubits, k_max, d_slots;
};

__device__ void refresh_qubit(const Sweep& w, const float* angles, int p, int q) {
  const int n = w.n_qubits;
  float* fac = w.factors + (long long)p * 2 * n * 8;
  float phase[4];
  slot_factors(w.gate_types[p * n + q], angles + (p * n + q) * 3, fac + (n + q) * 8, fac + q * 8,
               phase);
  const int slot = w.slot_of_q[p * n + q];
  if (slot >= 0) {
    for (int e = 0; e < 4; ++e) w.phase[((long long)p * w.d_slots + slot) * 4 + e] = phase[e];
  }
}

__global__ void sweep_refresh_all(Sweep w, const float* angles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= w.pop * w.n_qubits) return;
  refresh_qubit(w, angles, e / w.n_qubits, e % w.n_qubits);
}

__device__ int probed_index(const Sweep& w, int p, int k) {
  return k % max(w.n_free[p], 1);
}

__global__ void sweep_select(Sweep w, int k) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= w.pop) return;
  w.exclude[p] = w.coords[(p * w.k_max + probed_index(w, p, k)) * 2];
}

// The nine pair sums of BASE around the probed qubit q, per block over a
// fixed chunk of amplitude pairs (i0 with bit q clear, i1 = i0 | 2^q):
// f0 = sum T |psi|^2 where a CU3's control bit is 0, and where it acts
// (control bit 1, or a U3): f1..f4 = sum T(i0) (|a|^2, |b|^2, Re a b*,
// Im a b*), f5..f8 the same with T(i1); a = base[i0], b = base[i1].
__global__ void pair_sums(const float* base, const float* table, Sweep w, float* partial,
                          long long chunk) {
  __shared__ float shared[kReduceThreads];
  const int p = blockIdx.y;
  const int n = w.n_qubits;
  const long long dim = 1LL << n;
  const int q = w.exclude[p];
  const int gate = w.gate_types[p * n + q];
  const int slot = w.slot_of_q[p * n + q];
  const int control = gate == kGateCrot ? w.diag_ctrl[(long long)p * w.d_slots + max(slot, 0)] : -1;
  const float* re = base + (long long)p * 2 * dim;
  const float* im = re + dim;
  float acc[kPairSums];
  for (int s = 0; s < kPairSums; ++s) acc[s] = 0.0f;
  const long long begin = blockIdx.x * chunk;
  const long long low_mask = (1LL << q) - 1;
  for (long long j = begin + threadIdx.x; j < begin + chunk; j += blockDim.x) {
    const long long i0 = ((j >> q) << (q + 1)) | (j & low_mask);
    const long long i1 = i0 | (1LL << q);
    const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
    const float ta = table[i0], tb = table[i1];
    const float abs_a = ar * ar + ai * ai, abs_b = br * br + bi * bi;
    if (control >= 0 && ((i0 >> control) & 1) == 0) {
      acc[0] += ta * abs_a + tb * abs_b;
      continue;
    }
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
  for (int s = 0; s < kPairSums; ++s) {
    const float total = block_sum(acc[s], shared);
    if (threadIdx.x == 0) partial[((long long)p * kPairSums + s) * gridDim.x + blockIdx.x] = total;
    __syncthreads();
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

// One NFT step per individual: z0 (re-measured from the sums on reset
// steps), z1 and z3 from the sums, the 3-point update with atan2f, and the
// probed qubit's factors rebuilt from its new angle.
__global__ void sweep_update(Sweep w, float* angles, float* z, const float* sums, int k,
                             int reset_interval) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= w.pop) return;
  const int n = w.n_qubits;
  const int idx = probed_index(w, p, k);
  const int q = w.coords[(p * w.k_max + idx) * 2];
  const int a_i = w.coords[(p * w.k_max + idx) * 2 + 1];
  const int gate = w.gate_types[p * n + q];
  const bool gated = gate == kGateRot || gate == kGateCrot;
  float* angle = angles + (p * n + q) * 3;
  const float* f = sums + (long long)p * kPairSums;
  const float theta = angle[a_i];
  const float z0 = (k > 0 && k % reset_interval == 0) ? form_energy(f, angle, a_i, gated, theta)
                                                      : z[p];
  const float z1 = form_energy(f, angle, a_i, gated, theta + kHalfPi);
  const float z3 = form_energy(f, angle, a_i, gated, theta - kHalfPi);
  const float mid = (z1 + z3) * 0.5f;
  const float half_diff = (z1 - z3) * 0.5f;
  const float d = z0 - mid;
  const bool apply = w.active[p] && w.n_free[p] > 0;
  if (apply) {
    angle[a_i] = theta + atan2f(half_diff, d) + kPi;
    refresh_qubit(w, angles, p, q);
  }
  z[p] = apply ? mid - sqrtf(d * d + half_diff * half_diff) : z0;
}

}  // namespace

extern "C" {

// Replaces pallas_population_states_folded (pallas_fold_kernels.py:1195):
// out [P, 2, 2^n] from |0...0> or initial [P, 2, 2^n] (null = |0...0>).
// The ten pipeline pointers are the FoldPipeline fields in order; abs_* may
// be null (nothing absorbed).
int qt_fold_states(float* out, const float* initial, const float* factors, const int* diag_ctrl,
                   const int* diag_tgt, const float* diag_phase, const int* diag_count,
                   const int* group_active, const int* abs_ctrl, const int* abs_tgt,
                   const float* abs_phase, const int* abs_count, int pop, int n_kron,
                   int n_qubits, int d_slots, void* stream) {
  const Fold f = make_fold(factors, diag_ctrl, diag_tgt, diag_phase, diag_count, group_active,
                           abs_ctrl, abs_tgt, abs_phase, abs_count, n_kron, n_qubits, d_slots);
  cudaError_t err = run_folded(out, initial, pop, f, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Replaces pallas_population_probs_folded (pallas_fold_kernels.py:699):
// probs [P, 2^n]; work [P, 2, 2^n] is scratch.
int qt_fold_probs(float* probs, float* work, const float* initial, const float* factors,
                  const int* diag_ctrl, const int* diag_tgt, const float* diag_phase,
                  const int* diag_count, const int* group_active, const int* abs_ctrl,
                  const int* abs_tgt, const float* abs_phase, const int* abs_count, int pop,
                  int n_kron, int n_qubits, int d_slots, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Fold f = make_fold(factors, diag_ctrl, diag_tgt, diag_phase, diag_count, group_active,
                           abs_ctrl, abs_tgt, abs_phase, abs_count, n_kron, n_qubits, d_slots);
  cudaError_t err = run_folded(work, initial, pop, f, s);
  if (err != cudaSuccess) return (int)err;
  write_probabilities(work, probs, pop, 1LL << n_qubits, s);
  return (int)cudaGetLastError();
}

// Replaces pallas_energies_exact_folded (pallas_fold_kernels.py:743): out [P]
// = sum |psi|^2 * table.  work [P, 2, 2^n] and partial
// [P, qt_energy_partials(n)] are scratch.
int qt_fold_energies(float* out, float* work, float* partial, const float* initial,
                     const float* table, const float* factors, const int* diag_ctrl,
                     const int* diag_tgt, const float* diag_phase, const int* diag_count,
                     const int* group_active, const int* abs_ctrl, const int* abs_tgt,
                     const float* abs_phase, const int* abs_count, int pop, int n_kron,
                     int n_qubits, int d_slots, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Fold f = make_fold(factors, diag_ctrl, diag_tgt, diag_phase, diag_count, group_active,
                           abs_ctrl, abs_tgt, abs_phase, abs_count, n_kron, n_qubits, d_slots);
  cudaError_t err = run_folded(work, initial, pop, f, s);
  if (err != cudaSuccess) return (int)err;
  reduce_energies(work, table, partial, out, pop, 1LL << n_qubits, s);
  return (int)cudaGetLastError();
}

// Replaces pallas_sampled_shot_energies_folded (pallas_fold_kernels.py:795)
// up to its energy gather: sampled indices out [P, S] at the uniforms u_frac
// [P, S] after each pipeline's circuit from |0...0> or initial [P, 2, 2^n]
// (null = |0...0>); 14 <= n <= 21.  work [P, 2, 2^n] and scratch
// [P, qt_sampler_scratch(n)] are scratch.
int qt_sampled_shot_indices_folded(int* out, float* work, float* scratch, const float* u_frac,
                                   const float* initial, const float* factors,
                                   const int* diag_ctrl, const int* diag_tgt,
                                   const float* diag_phase, const int* diag_count,
                                   const int* group_active, const int* abs_ctrl,
                                   const int* abs_tgt, const float* abs_phase,
                                   const int* abs_count, int pop, int n_kron, int n_qubits,
                                   int d_slots, int shots, void* stream) {
  if (n_qubits < 14 || n_qubits > 21) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Fold f = make_fold(factors, diag_ctrl, diag_tgt, diag_phase, diag_count, group_active,
                           abs_ctrl, abs_tgt, abs_phase, abs_count, n_kron, n_qubits, d_slots);
  cudaError_t err = run_folded(work, initial, pop, f, s);
  if (err != cudaSuccess) return (int)err;
  err = sample_planes(work, u_frac, scratch, out, pop, n_qubits, shots, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Replaces pallas_grouped_shot_energies_folded (pallas_fold_kernels.py:1043)
// up to its energy gathers: the pipeline's circuit once from |0...0> or
// initial [P, 2, 2^n] (null = |0...0>), then per measurement group g its
// rotation kron layer (rot_factors [G, P, 1, n, 2, 2, 2] and rot_active
// [G, P, 1, n_axis_groups]: one-kron-layer pipelines of the population) and
// group_shots[g] sampled indices at the uniforms u_frac.  u_frac and out hold
// the groups one after another, group g as [P, group_shots[g]].
// group_shots and group_rotate are HOST arrays of G ints; a group with
// group_rotate[g] == 0 samples the circuit's planes as they are.  work
// [P, 2, 2^n], rotated [P, 2, 2^n] (null when no group rotates) and scratch
// [P, qt_sampler_scratch(n)] are scratch; 14 <= n <= 21.
int qt_grouped_shot_indices_folded(int* out, float* work, float* rotated, float* scratch,
                                   const float* u_frac, const float* initial,
                                   const float* factors, const int* diag_ctrl,
                                   const int* diag_tgt, const float* diag_phase,
                                   const int* diag_count, const int* group_active,
                                   const int* abs_ctrl, const int* abs_tgt,
                                   const float* abs_phase, const int* abs_count,
                                   const float* rot_factors, const int* rot_active,
                                   const int* group_shots, const int* group_rotate, int n_meas,
                                   int pop, int n_kron, int n_qubits, int d_slots,
                                   void* stream) {
  if (n_qubits < 14 || n_qubits > 21 || n_meas < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Fold f = make_fold(factors, diag_ctrl, diag_tgt, diag_phase, diag_count, group_active,
                           abs_ctrl, abs_tgt, abs_phase, abs_count, n_kron, n_qubits, d_slots);
  cudaError_t err = run_folded(work, initial, pop, f, s);
  if (err != cudaSuccess) return (int)err;
  const long long dim = 1LL << n_qubits;
  const long long layer_floats = (long long)pop * n_qubits * 8;
  const long long layer_groups = (long long)pop * f.n_groups;
  long long offset = 0;
  for (int g = 0; g < n_meas; ++g) {
    const float* planes = work;
    if (group_rotate[g] != 0) {
      if (rotated == nullptr) return (int)cudaErrorInvalidValue;
      err = cudaMemcpyAsync(rotated, work, (size_t)pop * 2 * dim * sizeof(float),
                            cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) return (int)err;
      const Fold r = make_fold(rot_factors + g * layer_floats, nullptr, nullptr, nullptr, nullptr,
                               rot_active + g * layer_groups, nullptr, nullptr, nullptr, nullptr,
                               1, n_qubits, d_slots);
      apply_kron_layer(rotated, r, pop, 0, s);
      planes = rotated;
    }
    err = sample_planes(planes, u_frac + offset, scratch, out + offset, pop, n_qubits,
                        group_shots[g], s);
    if (err != cudaSuccess) return (int)err;
    offset += (long long)pop * group_shots[g];
  }
  return (int)cudaGetLastError();
}

// First-pass blocks of the sweep's pair sums per individual.
int qt_fold_pair_partials(int n_qubits) {
  const long long pairs = 1LL << (n_qubits - 1);
  return (int)(pairs / reduce_chunk(pairs));
}

// Replaces pallas_nft_layer_sweep_folded (pallas_fold_kernels.py:1623).
// Inputs: the swept layer's gate_types [P, n], start angles [P, n, 3],
// coords [P, K, 2] (qubit, angle), n_free [P], active [P], prefix states
// [P, 2, 2^n], table [2^n], and fold_sweep_metadata's diag_ctrl [P, 1, D],
// diag_tgt [P, 1, D], slot_of_q [P, 1, n], diag_count [P, 1, 1],
// group_active [P, 2, G].  Outputs: angles_out [P, n, 3], z [P].
// Scratch: factors [P, 2, n, 8], phase [P, 1, D, 4], exclude [P] int32,
// base [P, 2, 2^n], partial [P, qt_energy_partials(n)],
// pair_partial [P, 9, qt_fold_pair_partials(n)], sums [P, 9].
int qt_fold_nft_sweep(float* angles_out, float* z, float* factors, float* phase, int* exclude,
                      float* base, float* partial, float* pair_partial, float* sums,
                      const int* gate_types, const float* angles, const int* coords,
                      const int* n_free, const unsigned char* active, const float* prefix,
                      const float* table, const int* diag_ctrl, const int* diag_tgt,
                      const int* slot_of_q, const int* diag_count, const int* group_active,
                      int pop, int n_qubits, int k_max, int d_slots, int maxiter,
                      int reset_interval, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long dim = 1LL << n_qubits;
  cudaError_t err = cudaMemcpyAsync(angles_out, angles, (size_t)pop * n_qubits * 3 * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(exclude, 0xff, (size_t)pop * sizeof(int), s);  // -1: nothing excluded
  if (err != cudaSuccess) return (int)err;
  const Sweep w{factors, phase, exclude, gate_types, coords, n_free, active, diag_ctrl, slot_of_q,
                pop, n_qubits, k_max, d_slots};
  Fold f = make_fold(factors, diag_ctrl, diag_tgt, phase, diag_count, group_active, nullptr,
                     nullptr, nullptr, nullptr, 2, n_qubits, d_slots);
  f.exclude = exclude;
  const unsigned int small = blocks_for(pop, 128);
  sweep_refresh_all<<<blocks_for((long long)pop * n_qubits, 128), 128, 0, s>>>(w, angles_out);

  err = run_folded(base, prefix, pop, f, s);
  if (err != cudaSuccess) return (int)err;
  reduce_energies(base, table, partial, z, pop, dim, s);
  const long long pairs = dim / 2;
  const long long chunk = reduce_chunk(pairs);
  const int n_partials = (int)(pairs / chunk);
  for (int k = 0; k < maxiter; ++k) {
    sweep_select<<<small, 128, 0, s>>>(w, k);
    err = run_folded(base, prefix, pop, f, s);
    if (err != cudaSuccess) return (int)err;
    pair_sums<<<dim3(n_partials, pop), kReduceThreads, 0, s>>>(base, table, w, pair_partial, chunk);
    energy_finish<<<pop * kPairSums, kReduceThreads, 0, s>>>(pair_partial, sums, n_partials);
    sweep_update<<<small, 128, 0, s>>>(w, angles_out, z, sums, k, reset_interval);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
