// Slot-circuit kernels for Hopper (sm_90a) behind a plain C interface.
//
// Counterparts of the five slot kernels of queasars_tpu/sim/pallas_kernels.py
// (pallas_energies_exact, pallas_population_states, pallas_nft_layer_sweep,
// pallas_population_probs, pallas_sampled_shot_energies).  Built with the
// fold and compacted-gate kernels into one shared library and bound with
// ctypes (queasars_tpu_torch/utils/cuda_lib.py); every entry point
// takes raw device pointers plus the caller's stream, launches on that stream,
// never synchronises, allocates nothing and returns cudaGetLastError().
//
// Layout: a state is two float32 planes [2, 2^n] (re, im); a population of P
// states is [P, 2, 2^n].  Basis index i holds qubit q in bit q (qiskit
// little-endian).  Gate codes: 0 ID, 1 U3, 2 control half, 3 CU3.
//
// Design.  A TPU program keeps one whole state in VMEM for the whole circuit.
// An H100 SM has at most 227 KB of shared memory against 8 MB of planes per
// state at n=20, so the states live in device memory and one circuit engine
// (run_slots) applies the slots in the plain version's order (layer, then q
// ascending; sim/statevector.py::simulate_circuits) as passes over tiles of
// 2^13 amplitudes (tile.cuh's rounds, swizzle, loads and stores, shared
// with the fold engine; 64 KB of planes in dynamic shared memory, 256
// threads, two tiles per SM):
//   * pass A, the low tile: a block owns 2^min(n, 13) contiguous amplitudes
//     of one individual and applies the layer's slots with target q <= 12.
//     At n <= 13 the tile is the whole state: one launch applies every layer.
//   * pass B, the top tile (n > 13): a tile holds the 2^(n-13) values of
//     bits 13..n-1 for a run of 2^(26-n) >= 16 consecutive low amplitudes
//     and applies the slots with target q >= 13.  Above n = 22 the top bits
//     split evenly into windows of at most 9 bits, one pass each, in
//     ascending q.  Pass A then pass B is the layer's slot order.
//   * rounds: each thread holds 32 amplitudes of five consecutive tile bits
//     in registers and applies those bits' slots there in ascending q.  A
//     CU3's control bit comes from the register index, from the thread's
//     part of the tile index or from the block's fixed bits, wherever it
//     lies; where it is clear the pair is kept by selection, not multiplied
//     by the identity.
//   * arithmetic: common.cuh's u3_apply, the plain version's order with no
//     FMA contraction, so a state equals its plain version's bit for bit.
//     Each (individual, layer, slot)'s U3 entries are computed once per
//     block into shared memory, not once per pair.  ID and control-half
//     slots and masked layers are skipped.
//   * skips: a pass whose individual has no active slot in its range
//     returns at once.  The first pass with work reads the start state
//     (initial[p], or |0...0> made in registers) and the later
//     ones work in place, so no copy-in pass runs; if no pass has work, the
//     last one copies.
//   * bound: each pass reads and writes the planes once (16 MB per
//     individual at n=20, 10 us a layer at 3.35 TB/s for both passes) and an
//     active slot costs 28 separately rounded multiplies and adds per pair
//     (no FMA: 14 per amplitude, half the fp32 rate), ~5.6 us per individual
//     and layer at 13 active slots.  So the engine is bound by plane bytes,
//     with the arithmetic not far below; a pass's rounds and its loads and
//     stores overlap only across the SM's two resident tiles.
//   * energy: sum (re^2 + im^2) * table as a deterministic two-pass reduction
//     (fixed-order per-block partials, then one block per individual; no float
//     atomics), so equal inputs give equal bits from run to run -- an EVQE
//     trajectory branches on energy order.
//   * NFT sweep (sweep.cuh's step, shared with the fold sweep): BASE, the
//     swept layer without the probed qubit's gate applied to the prefix,
//     comes from this engine on P individuals on rebuild steps (the first,
//     then every reset_interval), with that slot turned off; between
//     rebuilds one fused pass per transition redoes the last probed gate,
//     undoes the next and writes the nine pair sums, and one thread per
//     individual takes z1, z3 and the 3-point update from the sums.
//   * sampled shots: the circuit as above, then the hierarchical inverse-CDF
//     epilogue of sampler.cuh on the planes in device memory.

#include <cuda_runtime.h>

#include "common.cuh"
#include "sampler.cuh"
#include "sweep.cuh"
#include "tile.cuh"

namespace {

constexpr int kTopBits = 9;     // the widest top window
constexpr int kMaxQubits = 31;  // in-state indices are 32-bit ints

struct Genome {
  const int* gate_types;            // [P, n_layers, n_qubits]
  const int* controls;              // [P, n_layers, n_qubits]
  const float* angles;              // [P, n_layers, n_qubits, 3]
  const unsigned char* layer_mask;  // [P, n_layers]; null = all on
  int n_layers;
  int n_qubits;
};

// A pass's tile geometry: local bit l of a tile is global bit l below
// low_bits, and global bit win_lo + (l - low_bits) from there up (the
// pass's window); the tile index fills the other global bits, those between
// low_bits and win_lo first.  The low bits keep runs of 2^low_bits
// consecutive floats together, so the loads and stores stay coalesced.
// Below 5 qubits the tile is 2^5 amplitudes, those past the state zero:
// gates on the real bits never mix the two, and nothing past the state is
// loaded or stored.
struct TileMap {
  int n_qubits;
  int tile_bits;
  int low_bits;
  int win_lo;
};

__device__ __forceinline__ int window_end(const TileMap& m) {
  return m.win_lo + m.tile_bits - m.low_bits;
}

int tile_count(const TileMap& m) {
  return m.n_qubits > m.tile_bits ? 1 << (m.n_qubits - m.tile_bits) : 1;
}

// The global bits that tile `tile` fixes: its offset in the planes.
__device__ __forceinline__ int tile_offset(const TileMap& m, int tile) {
  const int mid = m.win_lo - m.low_bits;
  return ((tile & ((1 << mid) - 1)) << m.low_bits) | ((tile >> mid) << window_end(m));
}

__device__ __forceinline__ int global_index(const TileMap& m, int offset, int li) {
  return offset | (li & ((1 << m.low_bits) - 1)) | ((li >> m.low_bits) << m.win_lo);
}

// Bit q (a global qubit) of amplitude j of a round over [s, s + 5) whose
// amplitude 0 is local index base in the tile at offset.
__device__ __forceinline__ BitOf bit_of(const TileMap& m, int offset, int base, int s, int q) {
  const int l = q < m.low_bits ? q : q - m.win_lo + m.low_bits;
  if (q >= m.low_bits && (q < m.win_lo || l >= m.tile_bits)) return BitOf{-1, (offset >> q) & 1};
  if (l >= s && l < s + kRegBits) return BitOf{l - s, 0};
  return BitOf{-1, (base >> l) & 1};
}

// A state of n < 5 qubits in one round's registers (re == null: |0...0>),
// and back.
__device__ __forceinline__ void load_small(float (&xr)[kRegs], float (&xi)[kRegs], const float* re,
                                           const float* im, int n) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const bool in = j < (1 << n);
    xr[j] = re == nullptr ? (j == 0 ? 1.0f : 0.0f) : in ? re[j] : 0.0f;
    xi[j] = re == nullptr || !in ? 0.0f : im[j];
  }
}

__device__ __forceinline__ void store_small(const float (&xr)[kRegs], const float (&xi)[kRegs],
                                            float* re, float* im, int n) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    if (j < (1 << n)) re[j] = xr[j], im[j] = xi[j];
  }
}

// True when slot q of layer k of genome p applies a gate (U3 or CU3 in a
// layer that is on).
__device__ __forceinline__ bool slot_on(const Genome& g, int p, int k, int q) {
  if (k >= g.n_layers) return false;
  if (g.layer_mask != nullptr && !g.layer_mask[p * g.n_layers + k]) return false;
  const int type = g.gate_types[((long long)p * g.n_layers + k) * g.n_qubits + q];
  return type == kGateRot || type == kGateCrot;
}

// The engine's target windows: window 0 is qubits [0, min(n, 13)); the top
// qubits 13..n-1 split evenly into windows of at most kTopBits, so a top
// pass keeps runs of at least 2^4 consecutive floats.
__host__ __device__ int top_windows(int n) {
  return n > kTileBits ? (n - kTileBits + kTopBits - 1) / kTopBits : 0;
}

// First qubit of window w >= 1.
__host__ __device__ int window_start(int n, int w) {
  const int top = n - kTileBits, count = top_windows(n), k = w - 1;
  return kTileBits + k * (top / count) + (k < top % count ? k : top % count);
}

__device__ int window_of(int n, int q) {
  int w = 0;
  while (w < top_windows(n) && q >= window_start(n, w + 1)) ++w;
  return w;
}

// One pass of the engine: the slots with targets [q_lo, q_hi), which are
// the local bits from lb_first up of the tile geometry map.
struct SlotPass {
  TileMap map;
  int window;
  int q_lo, q_hi;
  int lb_first;
};

SlotPass make_slot_pass(int n, int w) {
  SlotPass ps{};
  ps.window = w;
  if (w == 0) {
    const int bits = n < kRegBits ? kRegBits : n < kTileBits ? n : kTileBits;
    ps.map = TileMap{n, bits, bits, bits};
    ps.q_hi = n < kTileBits ? n : kTileBits;
  } else {
    ps.q_lo = window_start(n, w);
    ps.q_hi = w < top_windows(n) ? window_start(n, w + 1) : n;
    ps.lb_first = kTileBits - (ps.q_hi - ps.q_lo);
    ps.map = TileMap{n, kTileBits, ps.lb_first, ps.q_lo};
  }
  return ps;
}

// Amplitudes j of a round whose register bit b is set.
__device__ __forceinline__ unsigned register_bit_set(int b) {
  return b == 0 ? 0xAAAAAAAAu : b == 1 ? 0xCCCCCCCCu : b == 2 ? 0xF0F0F0F0u
       : b == 3 ? 0xFF00FF00u : 0xFFFF0000u;
}

// The slot on register bit B of a round over local bits [s, s + 5), if its
// bit is in [lo, hi) and it applies a gate; a CU3 only to the pairs whose
// control bit is set.
template <int B>
__device__ __forceinline__ void round_slot(float (&xr)[kRegs], float (&xi)[kRegs], int s, int lo,
                                           int hi, const int* type_s, const int* ctrl_s,
                                           const U3* u3_s, const TileMap& m, int offset,
                                           int base) {
  const int l = s + B;
  if (l < lo || l >= hi || type_s[l] == 0) return;
  unsigned on = ~0u;
  if (type_s[l] == kGateCrot) {
    const BitOf c = bit_of(m, offset, base, s, ctrl_s[l]);
    on = c.shift >= 0 ? register_bit_set(c.shift) : (c.value != 0 ? ~0u : 0u);
    if (on == 0u) return;
  }
  const U3 u = u3_s[l];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    if ((j & (1 << B)) != 0 || ((on >> j) & 1u) == 0) continue;
    const int j1 = j | (1 << B);
    u3_apply(u, xr[j], xi[j], xr[j1], xi[j1]);
  }
}

// Layers [k_begin, k_end) of pass ps on tile blockIdx.x of individual
// blockIdx.y (semantics of _apply_u3_slot, pallas_kernels.py:55-115, slot
// by slot).  The planes go from src (initial[p]; null: |0...0>)
// to dst when no earlier pass of the run had work for this individual, else
// dst is updated in place; ``last`` marks the run's last launch.
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    slot_pass(float* dst, const float* src, Genome g, SlotPass ps, int k_begin, int k_end,
              int last) {
  extern __shared__ float tile_s[];  // re then im, 2^tile_bits each, swizzled
  __shared__ U3 u3_s[kTileBits];
  __shared__ int type_s[kTileBits], ctrl_s[kTileBits];

  const int p = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n = g.n_qubits;
  const long long dim = 1LL << n;
  int earlier = 0, work = 0;
  for (int e = t; e < min(k_end, g.n_layers) * n; e += blockDim.x) {
    const int k = e / n, q = e - k * n;
    if (!slot_on(g, p, k, q)) continue;
    const int w = window_of(n, q);
    if (k < k_begin || (k == k_begin && w < ps.window)) earlier = 1;
    if (k >= k_begin && w == ps.window) work = 1;
  }
  earlier = __syncthreads_or(earlier);
  work = __syncthreads_or(work);
  if (!work && !(last && !earlier)) return;
  float* out_re = dst + (long long)p * 2 * dim;
  float* out_im = out_re + dim;
  const float* in_re = earlier ? out_re
                       : src != nullptr ? src + (long long)p * 2 * dim
                                        : nullptr;
  const float* in_im = in_re != nullptr ? in_re + dim : nullptr;
  float* s_re = tile_s;
  float* s_im = tile_s + (1 << ps.map.tile_bits);
  const int offset = tile_offset(ps.map, tile);
  const auto index = [&](int li) { return global_index(ps.map, offset, li); };

  const int lb_last = ps.lb_first + ps.q_hi - ps.q_lo;
  const int n_chunks = (lb_last - ps.lb_first + kRegBits - 1) / kRegBits;
  float xr[kRegs], xi[kRegs];
  bool first = true;
  for (int k = k_begin; k < k_end; ++k) {
    if (k > k_begin) __syncthreads();  // the last layer's rounds are done with its slots
    for (int l = ps.lb_first + t; l < lb_last; l += blockDim.x) {
      const int q = ps.q_lo + l - ps.lb_first;
      const bool on = slot_on(g, p, k, q);
      type_s[l] = on ? g.gate_types[((long long)p * g.n_layers + k) * n + q] : 0;
      if (on) {
        ctrl_s[l] = max(g.controls[((long long)p * g.n_layers + k) * n + q], 0);
        const float* a = g.angles + (((long long)p * g.n_layers + k) * n + q) * 3;
        u3_s[l] = u3_entries(a[0], a[1], a[2]);
      }
    }
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      const int lo = ps.lb_first + c * kRegBits;
      const int hi = min(lo + kRegBits, lb_last);
      const int s = min(lo, ps.map.tile_bits - kRegBits);
      const bool final_round = k == k_end - 1 && c == n_chunks - 1;
      bool has = false;
      for (int l = lo; l < hi; ++l) has = has || type_s[l] != 0;
      if (!has && !first && !final_round) continue;
      const int base = round_index(t, s, 0);
      if (first && n < kRegBits) {
        load_small(xr, xi, in_re, in_im, n);
      } else if (first) {
        load_global(xr, xi, in_re, in_im, index, base, s);
      } else {
        load_shared(xr, xi, s_re, s_im, base, s);
      }
      round_slot<0>(xr, xi, s, lo, hi, type_s, ctrl_s, u3_s, ps.map, offset, base);
      round_slot<1>(xr, xi, s, lo, hi, type_s, ctrl_s, u3_s, ps.map, offset, base);
      round_slot<2>(xr, xi, s, lo, hi, type_s, ctrl_s, u3_s, ps.map, offset, base);
      round_slot<3>(xr, xi, s, lo, hi, type_s, ctrl_s, u3_s, ps.map, offset, base);
      round_slot<4>(xr, xi, s, lo, hi, type_s, ctrl_s, u3_s, ps.map, offset, base);
      if (final_round && n < kRegBits) {
        store_small(xr, xi, out_re, out_im, n);
      } else if (final_round) {
        store_global(xr, xi, out_re, out_im, index, base, s);
      } else {
        store_shared(xr, xi, s_re, s_im, base, s);
        __syncthreads();
      }
      first = false;
    }
  }
}

cudaError_t launch_slot_pass(float* dst, const float* src, int pop, const Genome& g, int window,
                             int k_begin, int k_end, int last, cudaStream_t s) {
  const SlotPass ps = make_slot_pass(g.n_qubits, window);
  const int chunks = (ps.q_hi - ps.q_lo + kRegBits - 1) / kRegBits;
  const size_t smem =
      (k_end - k_begin) * chunks > 1 ? (2 * sizeof(float)) << ps.map.tile_bits : 0;
  const dim3 grid(tile_count(ps.map), pop);
  slot_pass<<<grid, 1 << (ps.map.tile_bits - kRegBits), smem, s>>>(dst, src, g, ps, k_begin,
                                                                     k_end, last);
  return cudaGetLastError();
}

// The engine: every (layer, slot) of genome g on pop states, state p from
// src[p] (null: |0...0>), into dst [pop, 2, 2^n].  n <= 13: one launch;
// otherwise one pass per window and layer (two at n <= 22).
cudaError_t run_slots(float* dst, const float* src, int pop, const Genome& g, cudaStream_t s) {
  const int n = g.n_qubits;
  if (n < 1 || n > kMaxQubits) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(slot_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kTileSmem);
  if (err != cudaSuccess) return err;
  const int layers = g.n_layers > 0 ? g.n_layers : 1;  // none: one empty pass copies
  const int windows = 1 + top_windows(n);
  if (windows == 1) return launch_slot_pass(dst, src, pop, g, 0, 0, layers, 1, s);
  for (int k = 0; k < layers && err == cudaSuccess; ++k) {
    for (int w = 0; w < windows && err == cudaSuccess; ++w) {
      err = launch_slot_pass(dst, src, pop, g, w, k, k + 1, k == layers - 1 && w == windows - 1,
                             s);
    }
  }
  return err;
}

Genome make_genome(const int* gate_types, const int* controls, const float* angles,
                   const unsigned char* layer_mask, int n_layers, int n_qubits) {
  return Genome{gate_types, controls, angles, layer_mask, n_layers, n_qubits};
}

// The swept layer's gate types with each individual's probed slot off
// (the rebuild's REST): rest[p, q] = 0 where q == probe[p].
__global__ void rest_gates(int* rest, const int* gate_types, const int* probe, int pop, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pop * n) return;
  rest[e] = e % n == probe[e / n] ? 0 : gate_types[e];
}

}  // namespace

extern "C" {

// Partials buffer length the energy reduction needs per individual.
int qt_energy_partials(int n_qubits) {
  const long long dim = 1LL << n_qubits;
  return (int)(dim / reduce_chunk(dim));
}

// Replaces pallas_population_states (pallas_kernels.py:326): out [P, 2, 2^n].
int qt_population_states(float* out, const float* initial, const int* gate_types,
                         const int* controls, const float* angles,
                         const unsigned char* layer_mask, int pop, int n_layers, int n_qubits,
                         void* stream) {
  const Genome g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(out, initial, pop, g, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Replaces pallas_energies_exact (pallas_kernels.py:367): out [P].
// work [P, 2, 2^n] and partial [P, qt_energy_partials(n)] are scratch.
int qt_energies_exact(float* out, float* work, float* partial, const float* initial,
                      const int* gate_types, const int* controls, const float* angles,
                      const unsigned char* layer_mask, const float* table, int pop,
                      int n_layers, int n_qubits, void* stream) {
  const long long dim = 1LL << n_qubits;
  const cudaStream_t s = (cudaStream_t)stream;
  const Genome g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(work, initial, pop, g, s);
  if (err != cudaSuccess) return (int)err;
  reduce_energies(work, table, partial, out, pop, dim, s);
  return (int)cudaGetLastError();
}

// Replaces pallas_population_probs (pallas_kernels.py:267): probs [P, 2^n].
int qt_population_probs(float* probs, float* work, const float* initial, const int* gate_types,
                        const int* controls, const float* angles,
                        const unsigned char* layer_mask, int pop, int n_layers, int n_qubits,
                        void* stream) {
  const long long dim = 1LL << n_qubits;
  const cudaStream_t s = (cudaStream_t)stream;
  const Genome g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(work, initial, pop, g, s);
  if (err != cudaSuccess) return (int)err;
  write_probabilities(work, probs, pop, dim, s);
  return (int)cudaGetLastError();
}

// Pair-sum partials per individual and sum of the NFT sweeps'
// (qt_nft_layer_sweep, qt_fold_nft_sweep) passes.
int qt_sweep_partials(int n_qubits) { return sweep_blocks(n_qubits); }

// Replaces pallas_nft_layer_sweep (pallas_kernels.py:837).
// Inputs: the swept layer gate_types/controls [P, n], start angles [P, n, 3],
// coords [P, K, 2] (qubit, angle), n_free [P], active [P], prefix states
// [P, 2, 2^n], table [2^n], and transitions, a HOST array of maxiter flags
// (1 where some individual with active && n_free > 0 probes another qubit
// than at the step before).  Outputs: angles_out [P, n, 3], z [P].
// Scratch: base [P, 2, 2^n], partial [P, 9, qt_sweep_partials(n)],
// sums [P, 9], probe [P] int32, rest [P, n] int32.
int qt_nft_layer_sweep(float* angles_out, float* z, float* base, float* partial, float* sums,
                       int* probe, int* rest, const unsigned char* transitions,
                       const int* gate_types, const int* controls, const float* angles,
                       const int* coords, const int* n_free, const unsigned char* active,
                       const float* prefix, const float* table, int pop, int n_qubits, int k_max,
                       int maxiter, int reset_interval, void* stream) {
  if (n_qubits < 1 || n_qubits > kMaxQubits) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(angles_out, angles, (size_t)pop * n_qubits * 3 * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const SweepArgs w{angles_out, z, base, partial, sums, probe, gate_types, controls, coords,
                    n_free, active, table, pop, n_qubits, k_max};
  const Genome layer = make_genome(rest, controls, angles_out, nullptr, 1, n_qubits);
  const auto rebuild = [&]() {
    rest_gates<<<blocks_for((long long)pop * n_qubits, 128), 128, 0, s>>>(rest, gate_types, probe,
                                                                           pop, n_qubits);
    return run_slots(base, prefix, pop, layer, s);
  };
  err = run_sweep(w, transitions, maxiter, reset_interval, rebuild, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Floats of sampler scratch per individual (qt_sampled_shot_indices,
// qt_sampled_shot_indices_folded, qt_sample_planes).
int qt_sampler_scratch(int n_qubits) { return (int)sampler_scratch_floats(n_qubits); }

// Replaces pallas_sampled_shot_energies (pallas_kernels.py:660) up to its
// energy gather: sampled indices out [P, S] at the uniforms u_frac [P, S],
// after each genome's circuit from |0...0> or initial [P, 2, 2^n] (null =
// |0...0>); 14 <= n <= 20.  work [P, 2, 2^n] and scratch
// [P, qt_sampler_scratch(n)] are scratch.
int qt_sampled_shot_indices(int* out, float* work, float* scratch, const float* u_frac,
                            const float* initial, const int* gate_types, const int* controls,
                            const float* angles, const unsigned char* layer_mask, int pop,
                            int n_layers, int n_qubits, int shots, void* stream) {
  if (n_qubits < 14 || n_qubits > 20) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Genome g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(work, initial, pop, g, s);
  if (err != cudaSuccess) return (int)err;
  err = sample_planes(work, u_frac, scratch, out, pop, n_qubits, shots, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The sampler epilogue alone: sampled indices out [P, S] of the state planes
// [P, 2, 2^n] at u_frac [P, S]; 14 <= n <= 21.
int qt_sample_planes(int* out, float* scratch, const float* u_frac, const float* planes, int pop,
                     int n_qubits, int shots, void* stream) {
  return (int)sample_planes(planes, u_frac, scratch, out, pop, n_qubits, shots,
                            (cudaStream_t)stream);
}

}  // extern "C"
