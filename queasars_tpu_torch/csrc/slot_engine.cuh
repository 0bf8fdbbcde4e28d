// The slot circuit engine (run_slots): U3 and CU3 gates applied layer by
// layer, in ascending target order within a layer, as passes over 2^13-
// amplitude shared-memory tiles.  Templated on a gate source, so that the
// slot kernels (slot_kernels.cu, SlotSource: every (layer, qubit) slot of
// a [P, L, n] genome) and the compacted-gate kernels (compact_kernels.cu,
// ListSource: each individual's list of active gates) run one engine.
// Each .cu is compiled by its own nvcc process, so the engine lives here.
//
// A state is two float32 planes [2, 2^n] (re, im) in device memory; a
// population of P states is [P, 2, 2^n].  An H100 SM has at most 227 KB of
// shared memory against 8 MB of planes per state at n=20, so many blocks
// share each state (tile.cuh's rounds, swizzle, loads and stores, shared
// with the fold engine; 64 KB of planes in dynamic shared memory, 256
// threads, two tiles per SM):
//   * pass A, the low tile: a block owns 2^min(n, 13) contiguous amplitudes
//     of one individual and applies the layer's gates with target q <= 12.
//     At n <= 13 the tile is the whole state: one launch applies every layer.
//   * pass B, the top tile (n > 13): a tile holds the 2^(n-13) values of
//     bits 13..n-1 for a run of 2^(26-n) >= 16 consecutive low amplitudes
//     and applies the gates with target q >= 13.  Above n = 22 the top bits
//     split evenly into windows of at most 9 bits, one pass each, in
//     ascending q.  Pass A then pass B is the layer's gate order.
//   * rounds: each thread holds 32 amplitudes of five consecutive tile bits
//     in registers and applies those bits' gates there in ascending q.  A
//     CU3's control bit comes from the register index, from the thread's
//     part of the tile index or from the block's fixed bits, wherever it
//     lies; where it is clear the pair is kept by selection, not multiplied
//     by the identity.
//   * arithmetic: common.cuh's u3_apply, the plain version's order with no
//     FMA contraction, so a state equals its plain version's bit for bit,
//     whichever source fed the gates.  Each (individual, layer, gate)'s U3
//     entries are computed once per block into shared memory, not once per
//     pair.
//   * skips: a pass whose individual has no gate in its window returns at
//     once.  The first pass with work reads the start state (initial[p], or
//     |0...0> made in registers) and the later ones work in place, so no
//     copy-in pass runs; if no pass has work, the last one copies.
//   * bound: each pass reads and writes the planes once (16 MB per
//     individual at n=20, 10 us a layer at 3.35 TB/s for both passes) and an
//     active gate costs 28 separately rounded multiplies and adds per pair
//     (no FMA: 14 per amplitude, half the fp32 rate), ~5.6 us per individual
//     and layer at 13 active gates.  So the engine is bound by plane bytes,
//     with the arithmetic not far below; a pass's rounds and its loads and
//     stores overlap only across the SM's two resident tiles.
//
// A gate source is a struct passed by value to the kernel with
//   int n_qubits, n_layers;
//   __device__ void scan(int p, const SlotPass& ps, int k_begin, int k_end,
//                        int& earlier, int& work) const;
//     this thread's share of two flags for individual p: `earlier`, some
//     gate lies in an earlier (layer, window) of the run than (k_begin,
//     ps.window); `work`, some gate of layers [k_begin, k_end) lies in the
//     pass's window [ps.q_lo, ps.q_hi);
//   __device__ void fill(int p, int k, const SlotPass& ps, int* type_s,
//                        int* ctrl_s, U3* u3_s) const;
//     called by every thread of the block: the gate on each local bit
//     [ps.lb_first, ps.lb_first + ps.q_hi - ps.q_lo) of the pass in layer
//     k -- type_s 0 (none), kGateRot or kGateCrot; for a gate, its control
//     (>= 0) and U3 entries.  The engine reads them after a __syncthreads.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

constexpr int kTopBits = 9;     // the widest top window
constexpr int kMaxQubits = 31;  // in-state indices are 32-bit ints

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

// One pass of the engine: the gates with targets [q_lo, q_hi), which are
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

// The gate on register bit B of a round over local bits [s, s + 5), if its
// bit is in [lo, hi) and it holds one; a CU3 only to the pairs whose
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
// blockIdx.y (semantics of _apply_u3_slot, pallas_kernels.py:55-115, gate
// by gate), the gates from source g.  The planes go from src (initial[p];
// null: |0...0>) to dst when no earlier pass of the run had work for this
// individual, else dst is updated in place; ``last`` marks the run's last
// launch.
template <class Source>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    slot_pass(float* dst, const float* src, Source g, SlotPass ps, int k_begin, int k_end,
              int last) {
  extern __shared__ float tile_s[];  // re then im, 2^tile_bits each, swizzled
  __shared__ U3 u3_s[kTileBits];
  __shared__ int type_s[kTileBits], ctrl_s[kTileBits];

  const int p = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n = g.n_qubits;
  const long long dim = 1LL << n;
  int earlier = 0, work = 0;
  g.scan(p, ps, k_begin, k_end, earlier, work);
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
    if (k > k_begin) __syncthreads();  // the last layer's rounds are done with its gates
    g.fill(p, k, ps, type_s, ctrl_s, u3_s);
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

template <class Source>
cudaError_t launch_slot_pass(float* dst, const float* src, int pop, const Source& g, int window,
                             int k_begin, int k_end, int last, cudaStream_t s) {
  const SlotPass ps = make_slot_pass(g.n_qubits, window);
  const int chunks = (ps.q_hi - ps.q_lo + kRegBits - 1) / kRegBits;
  const size_t smem =
      (k_end - k_begin) * chunks > 1 ? (2 * sizeof(float)) << ps.map.tile_bits : 0;
  const dim3 grid(tile_count(ps.map), pop);
  slot_pass<Source><<<grid, 1 << (ps.map.tile_bits - kRegBits), smem, s>>>(dst, src, g, ps,
                                                                            k_begin, k_end, last);
  return cudaGetLastError();
}

// The engine: every gate of source g on pop states, state p from src[p]
// (null: |0...0>), into dst [pop, 2, 2^n].  n <= 13: one launch; otherwise
// one pass per window and layer (two at n <= 22).
template <class Source>
cudaError_t run_slots(float* dst, const float* src, int pop, const Source& g, cudaStream_t s) {
  const int n = g.n_qubits;
  if (n < 1 || n > kMaxQubits) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(slot_pass<Source>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
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

}  // namespace
