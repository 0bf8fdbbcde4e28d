// Shared-memory tile rounds of the slot and fold circuit engines
// (slot_kernels.cu::run_slots, fold_kernels.cu::run_folded).
//
// A pass of an engine cuts every individual's [2, 2^n] float32 planes into
// tiles of 2^tile_bits amplitudes, one block of 2^(tile_bits - 5) threads per
// tile; each engine maps a tile's local index to the global one (its
// ``index`` functor below).  Rounds: thread t holds 32 amplitudes in
// registers, the 2^5 values of five consecutive local bits [s, s + 5), and
// the engine applies those bits' gates there; threads exchange through
// shared memory between rounds.  The tile is XOR-swizzled by 32-float groups
// (i ^ ((i >> 5) & 31)), so no round's shared-memory access has a bank
// conflict.  A launch's first round loads from device memory (or makes
// |0...0> in registers) and its last stores there directly.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTileBits = 13;                                     // a tile: 2^13 amplitudes
constexpr int kTileBlocks = 2;                                    // resident tiles per SM
constexpr int kRegBits = 5;                                       // a round: 2^5 per thread
constexpr int kRegs = 1 << kRegBits;
constexpr int kTileThreads = 1 << (kTileBits - kRegBits);         // 256
constexpr int kTileSmem = (int)(2 * sizeof(float)) << kTileBits;  // 64 KB

// Thread t's amplitude j in a round over the local bits [s, s + 5): t fills
// the other bits from the lowest up, so lanes of a warp run along bits 0-4
// (or 5-9 when s = 0).
__device__ __forceinline__ int round_index(int t, int s, int j) {
  return (t & ((1 << s) - 1)) | ((t >> s) << (s + kRegBits)) | (j << s);
}

__device__ __forceinline__ int swizzle(int i) { return i ^ ((i >> kRegBits) & (kRegs - 1)); }

// Bit q (a global qubit) of amplitude j of a round: (j >> shift) & 1 when
// shift >= 0, else value for every j.
struct BitOf {
  int shift, value;
};

// A round's amplitudes from device memory (re == null: |0...0>); index maps
// a local index of the tile to the global one.  At s = 0 they are 32
// consecutive floats of each plane.
template <class Index>
__device__ __forceinline__ void load_global(float (&xr)[kRegs], float (&xi)[kRegs],
                                            const float* re, const float* im, Index index,
                                            int base, int s) {
  if (re == nullptr) {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      xr[j] = index(base | (j << s)) == 0 ? 1.0f : 0.0f;
      xi[j] = 0.0f;
    }
  } else if (s == 0) {
    const int g = index(base);
    const float4* r4 = reinterpret_cast<const float4*>(re + g);
    const float4* i4 = reinterpret_cast<const float4*>(im + g);
#pragma unroll
    for (int c = 0; c < kRegs / 4; ++c) {
      const float4 a = r4[c], b = i4[c];
      xr[4 * c] = a.x, xr[4 * c + 1] = a.y, xr[4 * c + 2] = a.z, xr[4 * c + 3] = a.w;
      xi[4 * c] = b.x, xi[4 * c + 1] = b.y, xi[4 * c + 2] = b.z, xi[4 * c + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const int g = index(base | (j << s));
      xr[j] = re[g];
      xi[j] = im[g];
    }
  }
}

template <class Index>
__device__ __forceinline__ void store_global(const float (&xr)[kRegs], const float (&xi)[kRegs],
                                             float* re, float* im, Index index, int base,
                                             int s) {
  if (s == 0) {
    const int g = index(base);
    float4* r4 = reinterpret_cast<float4*>(re + g);
    float4* i4 = reinterpret_cast<float4*>(im + g);
#pragma unroll
    for (int c = 0; c < kRegs / 4; ++c) {
      r4[c] = make_float4(xr[4 * c], xr[4 * c + 1], xr[4 * c + 2], xr[4 * c + 3]);
      i4[c] = make_float4(xi[4 * c], xi[4 * c + 1], xi[4 * c + 2], xi[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRegs; ++j) {
      const int g = index(base | (j << s));
      re[g] = xr[j];
      im[g] = xi[j];
    }
  }
}

// A round's amplitudes from, and back to, the swizzled tile in shared memory.
__device__ __forceinline__ void load_shared(float (&xr)[kRegs], float (&xi)[kRegs],
                                            const float* s_re, const float* s_im, int base,
                                            int s) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int i = swizzle(base | (j << s));
    xr[j] = s_re[i];
    xi[j] = s_im[i];
  }
}

__device__ __forceinline__ void store_shared(const float (&xr)[kRegs], const float (&xi)[kRegs],
                                             float* s_re, float* s_im, int base, int s) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int i = swizzle(base | (j << s));
    s_re[i] = xr[j];
    s_im[i] = xi[j];
  }
}

}  // namespace
