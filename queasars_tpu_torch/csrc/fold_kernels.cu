// Kron-fold circuit kernels for Hopper (sm_90a) behind a plain C interface.
//
// Counterparts of the six fold kernels of queasars_tpu/sim/
// pallas_fold_kernels.py (pallas_energies_exact_folded,
// pallas_population_states_folded, pallas_nft_layer_sweep_folded,
// pallas_population_probs_folded, pallas_sampled_shot_energies_folded,
// pallas_grouped_shot_energies_folded).
// Built with the slot kernels and bound with ctypes
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
// as one dense MXU matmul per 7-qubit axis group, which the MXU makes cheap.
// In fp32 on the H100's CUDA cores (no TF32: the 1e-5 gate) that dense form
// costs 2^n * S complex multiply-adds per group, ~10x the layer's 2x2
// factors.  So one circuit engine (run_folded) applies every kron layer
// factor by factor, in the plain version's qubit order (qubit 0 first), as
// passes over tiles of 2^13 amplitudes (64 KB of re/im planes in dynamic
// shared memory; 256 threads; two tiles per SM, so one loads or stores
// while the other computes):
//   * pass A, the low tile: a block owns 2^min(n, 13) contiguous amplitudes
//     of one individual (bits 0-12) and applies their factors.  At n <= 13
//     the tile is the whole state: one launch applies every kron layer and
//     every phase with the state resident in shared memory.
//   * pass B, the top tile (n > 13): a tile holds the 2^(n-13) values of
//     bits 13..n-1 (the 8-bit top group of n=22 natively, with bit 13) for
//     a contiguous run of 2^(26-n) >= 16 low amplitudes (64 bytes, whole
//     sectors).  It applies those factors, then every phase of the layer:
//     the absorbed slots and the diagonal pass (each CDiag slot whose control
//     bit is set, with the phase its target bit selects).  Phases are
//     diagonal and come after all of the layer's factors.
//   * rounds: thread t holds 32 amplitudes in registers, the 2^5 values of
//     five consecutive tile bits, and applies those bits' 2x2 factors there
//     (8 FMAs per amplitude and factor); threads exchange through shared
//     memory between rounds (3 rounds for 13 bits, 1-2 for a top).  The
//     rounds' indexing, the XOR swizzle and the loads and stores are
//     tile.cuh's, shared with the slot engine; the tile geometry is this
//     engine's own (its top window always reaches bit n-1, and the slot
//     engine's general map measured 1.3-2.7% slower here, PERF.md).  A
//     launch's first round loads from device memory and its last stores
//     there directly; a one-round pass (a top of at most 5 bits) uses no
//     shared memory at all.
//   * skips: a pass whose axis groups are inactive in that kron layer and
//     that has no phase to apply returns at once, as does a round whose
//     factors are all the identity.  The first pass with work reads the
//     start state (initial, or |0...0> made in registers) and the later ones
//     work in place, so no copy-in pass runs; if no pass has work, the last
//     one copies.  The sweep's exclude (its REST) turns the probed qubit's
//     factors into the identity and skips its CDiag slot.  Nothing is
//     absorbed into the 8-bit top group at n=22 (the pipeline's rule).
//   * bound: device-memory bytes and fp32 instructions about equally: each
//     pass reads and writes the planes once (16 MB per individual at n=20),
//     and a layer's 20 factors cost 160 FMAs per amplitude.  Running every
//     pass of a few individuals while their planes sit in L2 measured slower
//     than the plain pass order (PERF.md), so passes run layer by
//     layer over the whole population.  Loads go straight to registers:
//     staging a tile with cp.async measured no faster, and a second
//     buffer to prefetch the next tile leaves room for one block per SM,
//     which measured slower (PERF.md).
//   * epilogues: probabilities, the planes themselves, the energy through
//     the fixed-order two-pass reduction of common.cuh (no float atomics), or
//     sampled shot indices through the hierarchical inverse CDF of
//     sampler.cuh.  The TPU ran its sampled kernel at single-pass bf16
//     (precision="default"); here it runs in fp32 like every fold kernel,
//     closer to the exact state.
//   * grouped sampler: the circuit runs once into a work buffer; then, per
//     rotated QWC measurement group, the group's rotation kron layer runs
//     through the same passes out of place, from the work planes into a
//     second buffer, and the epilogue samples that group's shots.  A group
//     with no rotation (a Z-basis group) samples the work planes themselves.
//     The sampled kernel on the pipeline extended by that rotation layer
//     runs the same rounds on the same values, so both give equal bits.
//   * NFT sweep (sweep.cuh's step, shared with the slot sweep): BASE = REST .
//     prefix (the swept layer with the probed qubit's factors and CDiag slot
//     replaced by the identity) comes from this engine on rebuild steps (the
//     first, then every reset_interval), with the layer's factors rebuilt on
//     the card from the current angles; between rebuilds one fused pass per
//     transition redoes the last probed gate, undoes the next and writes the
//     nine pair sums over (base[i], base[i ^ 2^q], table[i], table[i ^ 2^q]),
//     and one thread per individual takes z1, z3 and the 3-point update from
//     the sums.

#include <cuda_runtime.h>

#include "common.cuh"
#include "sampler.cuh"
#include "sweep.cuh"
#include "tile.cuh"

namespace {

constexpr int kLaneBits = 7;
constexpr int kMaxSlots = 11;  // CDiag slots of one layer (absorbed and not): at most n / 2

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

// One pass of the engine over tiles of every individual's planes.  Local bit
// l of a tile is global bit l below low_bits and global bit l + mid_bits
// above; the tile index fills the mid_bits global bits in between.
struct Pass {
  int which;              // 0: the low tile (the whole state when n <= 13); 1: the top
  int tile_bits;          // a tile holds 2^tile_bits amplitudes
  int low_bits, mid_bits;
  int lb_first, lb_last;  // local bits of the qubits the pass applies
  int g_first, g_last;    // their axis groups
  int phases;             // 1: it applies the layer's phases (absorbed slots, diagonal pass)
};

__host__ __device__ Pass make_pass(int n, int which) {
  Pass ps{};
  ps.which = which;
  ps.tile_bits = n < kTileBits ? n : kTileBits;
  if (which == 0) {
    ps.low_bits = ps.tile_bits;
    ps.mid_bits = n - ps.tile_bits;
    ps.lb_first = 0;
    ps.lb_last = ps.tile_bits;
    ps.g_first = 0;
    ps.g_last = (ps.tile_bits - 1) / kLaneBits;
    ps.phases = n <= kTileBits ? 1 : 0;
  } else {
    ps.mid_bits = n - kTileBits;
    ps.low_bits = kTileBits - ps.mid_bits;
    ps.lb_first = ps.low_bits;
    ps.lb_last = kTileBits;
    ps.g_first = kTileBits / kLaneBits;
    ps.g_last = 2;
    ps.phases = 1;
  }
  return ps;
}

// True when pass ps has work in kron layer k of individual p: an active axis
// group of its own, or a phase to apply after the layer.
__device__ bool pass_work(const Fold& f, const Pass& ps, int p, int k) {
  const int* active = f.group_active + ((long long)p * f.n_kron + k) * f.n_groups;
  for (int g = ps.g_first; g <= ps.g_last && g < f.n_groups; ++g) {
    if (active[g] != 0) return true;
  }
  if (!ps.phases || k >= f.n_kron - 1) return false;
  const long long layer = (long long)p * (f.n_kron - 1) + k;
  return f.diag_count[layer] > 0 || (f.abs_count != nullptr && f.abs_count[layer] > 0);
}

// A CDiag slot as a pass applies it: where bit ctrl is 1, multiply by
// (ph[0], ph[1]) or, where bit tgt is 1, by (ph[2], ph[3]).
struct Slot {
  int ctrl, tgt;
  float ph[4];
};

__device__ __forceinline__ int global_index(const Pass& ps, int tile, int li) {
  return (li & ((1 << ps.low_bits) - 1)) | (tile << ps.low_bits) |
         ((li >> ps.low_bits) << (ps.low_bits + ps.mid_bits));
}

// Bit q (a global qubit) of amplitude j of a round over [s, s + 5) whose
// amplitude 0 is local index base.
__device__ __forceinline__ BitOf bit_of(const Pass& ps, int tile, int base, int s, int q) {
  int l = q;
  if (q >= ps.low_bits) {
    if (q < ps.low_bits + ps.mid_bits) return BitOf{-1, (tile >> (q - ps.low_bits)) & 1};
    l = q - ps.mid_bits;
  }
  if (l >= s && l < s + kRegBits) return BitOf{l - s, 0};
  return BitOf{-1, (base >> l) & 1};
}

// The 2x2 factor m ([re 00 01 10 11, im 00 01 10 11]) on register bit B.
template <int B>
__device__ __forceinline__ void apply_factor(float (&xr)[kRegs], float (&xi)[kRegs],
                                             const float* m) {
  const float ar = m[0], br = m[1], cr = m[2], dr = m[3];
  const float ai = m[4], bi = m[5], ci = m[6], di = m[7];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    if (j & (1 << B)) continue;
    const int j1 = j | (1 << B);
    const float r0 = xr[j], i0 = xi[j], r1 = xr[j1], i1 = xi[j1];
    xr[j] = ar * r0 - ai * i0 + br * r1 - bi * i1;
    xi[j] = ar * i0 + ai * r0 + br * i1 + bi * r1;
    xr[j1] = cr * r0 - ci * i0 + dr * r1 - di * i1;
    xi[j1] = cr * i0 + ci * r0 + dr * i1 + di * r1;
  }
}

// Tile bit s + B's factor when that bit is in [lo, hi) and active.
template <int B>
__device__ __forceinline__ void round_factor(float (&xr)[kRegs], float (&xi)[kRegs], int s,
                                             int lo, int hi, const int* qact, const float* fac) {
  const int l = s + B;
  if (l >= lo && l < hi && qact[l] != 0) apply_factor<B>(xr, xi, fac + 8 * l);
}

__device__ __forceinline__ void apply_phases(float (&xr)[kRegs], float (&xi)[kRegs],
                                             const Slot* slots, int n_slots, const Pass& ps,
                                             int tile, int base, int s) {
  for (int k = 0; k < n_slots; ++k) {
    const Slot& slot = slots[k];
    const BitOf c = bit_of(ps, tile, base, s, slot.ctrl);
    if (c.shift < 0 && c.value == 0) continue;
    const BitOf tb = bit_of(ps, tile, base, s, slot.tgt);
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      if (c.shift >= 0 && ((j >> c.shift) & 1) == 0) continue;
      const int sel = tb.shift >= 0 ? (j >> tb.shift) & 1 : tb.value;
      const float pr = sel ? slot.ph[2] : slot.ph[0], pi = sel ? slot.ph[3] : slot.ph[1];
      const float r = xr[j], m = xi[j];
      xr[j] = pr * r - pi * m;
      xi[j] = pr * m + pi * r;
    }
  }
}

// Kron layers [k_begin, k_end) of pass ps on tile blockIdx.x of individual
// blockIdx.y: each layer's factors round by round, then the phases the pass
// carries (semantics of _apply_kron_layer and _apply_diag_pass,
// pallas_fold_kernels.py:202-383).  The planes go from src (null: |0...0>)
// to dst when no earlier pass of the run had work for this individual, else
// dst is updated in place; ``last`` marks the run's last launch.
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    fold_pass(float* dst, const float* src, Fold f, Pass ps, int k_begin, int k_end, int last) {
  extern __shared__ float tile_s[];  // re then im, 2^tile_bits each, swizzled
  __shared__ float fac_s[kTileBits][8];
  __shared__ int qact_s[kTileBits];
  __shared__ Slot slot_s[kMaxSlots];
  __shared__ int n_slots_s, mode_s;

  const int p = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n = f.n_qubits;
  const long long dim = 1LL << n;
  const int excl = f.exclude != nullptr ? f.exclude[p] : -1;
  if (t == 0) {
    const Pass low = make_pass(n, 0), top = make_pass(n, 1);
    const bool split = n > kTileBits;
    bool earlier = false;
    for (int k = 0; k < k_begin && !earlier; ++k) {
      earlier = pass_work(f, low, p, k) || (split && pass_work(f, top, p, k));
    }
    if (ps.which == 1 && !earlier) earlier = pass_work(f, low, p, k_begin);
    bool work = false;
    for (int k = k_begin; k < k_end && !work; ++k) work = pass_work(f, ps, p, k);
    const bool fill = !earlier && last != 0 && src != dst;
    mode_s = (work || fill ? 1 : 0) | (earlier ? 0 : 2);
  }
  __syncthreads();
  const int mode = mode_s;
  if ((mode & 1) == 0) return;
  const float* in = (mode & 2) != 0 ? src : dst;
  const float* in_re = in != nullptr ? in + (long long)p * 2 * dim : nullptr;
  const float* in_im = in != nullptr ? in_re + dim : nullptr;
  float* out_re = dst + (long long)p * 2 * dim;
  float* out_im = out_re + dim;
  float* s_re = tile_s;
  float* s_im = tile_s + (1 << ps.tile_bits);
  const auto index = [&](int li) { return global_index(ps, tile, li); };

  const int n_chunks = (ps.lb_last - ps.lb_first + kRegBits - 1) / kRegBits;
  float xr[kRegs], xi[kRegs];
  bool first = true;
  for (int k = k_begin; k < k_end; ++k) {
    if (k > k_begin) __syncthreads();  // the last layer's rounds are done with its setup
    const float* fk = f.factors + ((long long)p * f.n_kron + k) * n * 8;
    const int* active = f.group_active + ((long long)p * f.n_kron + k) * f.n_groups;
    for (int l = ps.lb_first + t; l < ps.lb_last; l += blockDim.x) {
      const int q = l < ps.low_bits ? l : l + ps.mid_bits;
      const float* a = fk + q * 8;
      bool on = active[min(q / kLaneBits, f.n_groups - 1)] != 0 && q != excl;
      on = on && !(a[0] == 1.0f && a[1] == 0.0f && a[2] == 0.0f && a[3] == 1.0f &&
                   a[4] == 0.0f && a[5] == 0.0f && a[6] == 0.0f && a[7] == 0.0f);
      for (int e = 0; e < 8; ++e) fac_s[l][e] = a[e];
      qact_s[l] = on ? 1 : 0;
    }
    if (t == 0) {
      int count = 0;
      if (ps.phases && k < f.n_kron - 1) {
        const long long layer = (long long)p * (f.n_kron - 1) + k;
        const int abs_n = f.abs_count != nullptr ? f.abs_count[layer] : 0;
        const int diag_n = f.diag_count[layer];
        for (int j = 0; j < abs_n + diag_n && count < kMaxSlots; ++j) {
          const bool absorbed = j < abs_n;
          const long long slot = layer * f.d_slots + (absorbed ? j : j - abs_n);
          const int c = absorbed ? f.abs_ctrl[slot] : f.diag_ctrl[slot];
          const int tq = absorbed ? f.abs_tgt[slot] : f.diag_tgt[slot];
          if (!absorbed && tq == excl) continue;
          const float* ph = (absorbed ? f.abs_phase : f.diag_phase) + slot * 4;
          slot_s[count] = Slot{c, tq, {ph[0], ph[1], ph[2], ph[3]}};
          ++count;
        }
      }
      n_slots_s = count;
    }
    __syncthreads();
    const int n_slots = n_slots_s;
    for (int c = 0; c < n_chunks; ++c) {
      const int lo = ps.lb_first + c * kRegBits;
      const int hi = min(lo + kRegBits, ps.lb_last);
      const int s = min(lo, ps.tile_bits - kRegBits);
      const bool carrier = c == n_chunks - 1 && n_slots > 0;
      const bool final_round = k == k_end - 1 && c == n_chunks - 1;
      bool has = carrier;
      for (int l = lo; l < hi; ++l) has = has || qact_s[l] != 0;
      if (!has && !first && !final_round) continue;
      const int base = round_index(t, s, 0);
      if (first) {
        load_global(xr, xi, in_re, in_im, index, base, s);
      } else {
        load_shared(xr, xi, s_re, s_im, base, s);
      }
      round_factor<0>(xr, xi, s, lo, hi, qact_s, &fac_s[0][0]);
      round_factor<1>(xr, xi, s, lo, hi, qact_s, &fac_s[0][0]);
      round_factor<2>(xr, xi, s, lo, hi, qact_s, &fac_s[0][0]);
      round_factor<3>(xr, xi, s, lo, hi, qact_s, &fac_s[0][0]);
      round_factor<4>(xr, xi, s, lo, hi, qact_s, &fac_s[0][0]);
      if (carrier) apply_phases(xr, xi, slot_s, n_slots, ps, tile, base, s);
      if (final_round) {
        store_global(xr, xi, out_re, out_im, index, base, s);
      } else {
        store_shared(xr, xi, s_re, s_im, base, s);
        __syncthreads();
      }
      first = false;
    }
  }
}

cudaError_t launch_pass(float* dst, const float* src, int pop, const Fold& f, int which,
                        int k_begin, int k_end, int last, cudaStream_t s) {
  const Pass ps = make_pass(f.n_qubits, which);
  const int chunks = (ps.lb_last - ps.lb_first + kRegBits - 1) / kRegBits;
  const size_t smem = (k_end - k_begin) * chunks > 1 ? (2 * sizeof(float)) << ps.tile_bits : 0;
  const dim3 grid(1u << ps.mid_bits, pop);
  fold_pass<<<grid, 1 << (ps.tile_bits - kRegBits), smem, s>>>(dst, src, f, ps, k_begin, k_end,
                                                                 last);
  return cudaGetLastError();
}

// The engine: every kron layer and diagonal pass of the pipeline f, from src
// (initial planes [P, 2, 2^n], or null: |0...0>) into dst.  n <= 13: one
// launch; otherwise passes A and B per kron layer.
cudaError_t run_folded(float* dst, const float* src, int pop, const Fold& f, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(fold_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kTileSmem);
  if (err != cudaSuccess) return err;
  if (f.n_qubits <= kTileBits) return launch_pass(dst, src, pop, f, 0, 0, f.n_kron, 1, s);
  for (int k = 0; k < f.n_kron && err == cudaSuccess; ++k) {
    err = launch_pass(dst, src, pop, f, 0, k, k + 1, 0, s);
    if (err == cudaSuccess) err = launch_pass(dst, src, pop, f, 1, k, k + 1, k == f.n_kron - 1, s);
  }
  return err;
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

// The swept layer's two kron layers and CDiag phases, as the fold engine
// reads them, and what rebuilds them from the angles.
struct LayerFactors {
  float* factors;         // [P, 2, n, 8]: kron 0 = vdag, kron 1 = main
  float* phase;           // [P, 1, D, 4]
  const int* gate_types;  // [P, n]
  const int* slot_of_q;   // [P, 1, n]
  int pop, n_qubits, d_slots;
};

// Every qubit's factors (and CDiag phases) of the swept layer at angles.
__global__ void sweep_refresh_all(LayerFactors w, const float* angles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= w.pop * w.n_qubits) return;
  const int n = w.n_qubits, p = e / n, q = e % n;
  float* fac = w.factors + (long long)p * 2 * n * 8;
  float phase[4];
  slot_factors(w.gate_types[e], angles + (long long)e * 3, fac + (n + q) * 8, fac + q * 8, phase);
  const int slot = w.slot_of_q[e];
  if (slot >= 0) {
    for (int k = 0; k < 4; ++k) w.phase[((long long)p * w.d_slots + slot) * 4 + k] = phase[k];
  }
}

// [P, n] controls of the swept layer from its metadata (-1 where a qubit
// holds no CU3), for the shared step's passes.
__global__ void layer_controls(int* controls, const int* diag_ctrl, const int* slot_of_q, int pop,
                               int n, int d_slots) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pop * n) return;
  const int slot = slot_of_q[e];
  controls[e] = slot >= 0 ? diag_ctrl[(long long)(e / n) * d_slots + slot] : -1;
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
  const long long layer_floats = (long long)pop * n_qubits * 8;
  const long long layer_groups = (long long)pop * f.n_groups;
  long long offset = 0;
  for (int g = 0; g < n_meas; ++g) {
    const float* planes = work;
    if (group_rotate[g] != 0) {
      if (rotated == nullptr) return (int)cudaErrorInvalidValue;
      const Fold r = make_fold(rot_factors + g * layer_floats, nullptr, nullptr, nullptr, nullptr,
                               rot_active + g * layer_groups, nullptr, nullptr, nullptr, nullptr,
                               1, n_qubits, d_slots);
      err = run_folded(rotated, work, pop, r, s);  // out of place: work stays the circuit's
      if (err != cudaSuccess) return (int)err;
      planes = rotated;
    }
    err = sample_planes(planes, u_frac + offset, scratch, out + offset, pop, n_qubits,
                        group_shots[g], s);
    if (err != cudaSuccess) return (int)err;
    offset += (long long)pop * group_shots[g];
  }
  return (int)cudaGetLastError();
}

// Replaces pallas_nft_layer_sweep_folded (pallas_fold_kernels.py:1623).
// Inputs: the swept layer's gate_types [P, n], start angles [P, n, 3],
// coords [P, K, 2] (qubit, angle), n_free [P], active [P], prefix states
// [P, 2, 2^n], table [2^n], fold_sweep_metadata's diag_ctrl [P, 1, D],
// diag_tgt [P, 1, D], slot_of_q [P, 1, n], diag_count [P, 1, 1],
// group_active [P, 2, G], and transitions, a HOST array of maxiter flags (as
// qt_nft_layer_sweep's).  Outputs: angles_out [P, n, 3], z [P].
// Scratch: factors [P, 2, n, 8], phase [P, 1, D, 4], probe [P] int32,
// controls [P, n] int32, base [P, 2, 2^n], partial [P, 9,
// qt_sweep_partials(n)], sums [P, 9].
int qt_fold_nft_sweep(float* angles_out, float* z, float* factors, float* phase, int* probe,
                      int* controls, float* base, float* partial, float* sums,
                      const unsigned char* transitions, const int* gate_types,
                      const float* angles, const int* coords, const int* n_free,
                      const unsigned char* active, const float* prefix, const float* table,
                      const int* diag_ctrl, const int* diag_tgt, const int* slot_of_q,
                      const int* diag_count, const int* group_active, int pop, int n_qubits,
                      int k_max, int d_slots, int maxiter, int reset_interval, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(angles_out, angles, (size_t)pop * n_qubits * 3 * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned int per_qubit = blocks_for((long long)pop * n_qubits, 128);
  layer_controls<<<per_qubit, 128, 0, s>>>(controls, diag_ctrl, slot_of_q, pop, n_qubits, d_slots);
  const LayerFactors lf{factors, phase, gate_types, slot_of_q, pop, n_qubits, d_slots};
  Fold f = make_fold(factors, diag_ctrl, diag_tgt, phase, diag_count, group_active, nullptr,
                     nullptr, nullptr, nullptr, 2, n_qubits, d_slots);
  f.exclude = probe;
  const SweepArgs w{angles_out, z, base, partial, sums, probe, gate_types, controls, coords,
                    n_free, active, table, pop, n_qubits, k_max};
  const auto rebuild = [&]() {
    sweep_refresh_all<<<per_qubit, 128, 0, s>>>(lf, angles_out);
    return run_folded(base, prefix, pop, f, s);
  };
  err = run_sweep(w, transitions, maxiter, reset_interval, rebuild, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // extern "C"
