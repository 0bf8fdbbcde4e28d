// Amplitude-shard kernels for Hopper (sm_90a) behind a plain C interface.
//
// The amplitude-sharded engine (sim/sharded_statevector.py,
// sim/sharded_fold.py) cuts each state [2, 2^n] into contiguous shards of
// 2^local_bits amplitudes, one per cell of a (pop, amp) mesh.  The JAX
// package writes that engine as XLA code under shard_map (no Pallas kernel);
// these are the port's kernels for its per-shard passes.  Every entry point
// takes raw device pointers plus the caller's stream, launches on that
// stream, never synchronises, allocates nothing and returns
// cudaGetLastError().
//
// A shard batch is [B, 2, len] (re, im planes per row); in-shard index i
// holds the global amplitude index (cell << local_bits) | i.  Every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn), so each kernel
// equals its plain version (sim/shard_kernels.py) bit for bit and its
// result for one amplitude does not depend on the shard's length -- the
// (pop, amp) factorization invariance the sharded engine promises.
//
//   * qt_shard_pair_combine: one 2x2 (a U3 slot, a fold factor, QAOA's RX)
//     on one target qubit of every row, the partner amplitude read in the
//     shard (i ^ 2^target) or from an exchanged partner shard (a global
//     target, side bit given); rows and local controls gate it.  The
//     expression is _partner_combine's (queasars_tpu/sim/
//     sharded_statevector.py:87-107), which is also the slot engine's pair
//     update (common.cuh::u3_apply).  Bound by bytes: state and partner
//     read, state written.
//   * qt_shard_group_product: the per-qubit 2x2 fold factors of the m <= 7
//     qubits [q0, q0 + m) on every row, qubit q0's first -- the Kronecker
//     product of those factors that the JAX package builds densely for the
//     TPU's matrix unit (sharded_fold.py:105-142).  Applied factor by factor
//     it costs m pair updates (u3_apply, 14 operations per amplitude each)
//     instead of 2^m complex products, so it is bound by bytes: the shard read
//     once and written once.  The design is the fold engine's (tile.cuh): a
//     block owns a tile of 2^13 amplitudes (64 KB of planes in shared
//     memory, 256 threads, two tiles per SM) whose local bits are global bits
//     0-4 (32 consecutive floats, so a first round over them loads 16 bytes
//     a thread) and the group's bits; the tile index fills the others.  Each
//     round applies up to five of the group's factors in registers in
//     ascending qubit order, with a shared-memory exchange between rounds (a
//     group of up to five qubits: one round, no shared memory).  The first
//     round loads from device memory and the last stores there, so each
//     amplitude gets the same operations in the same order whatever the
//     shard's length.
//   * qt_shard_diag_phase: one kron layer's controlled-diagonal phase slots
//     on every row, in slot order, control and target bits read from the
//     in-shard index or the cell id (sharded_fold.py:167-202).  In place.
//   * qt_shard_running_sum: inclusive running sums of segments of <= 4096
//     values in XLA's CPU order for a cumsum (sequential within chunks of
//     16; each chunk after the first plus the running sum of the chunk
//     totals before it, recursively; sim/sampling.py::running_sum).  The
//     blocked shot sampler's block CDFs and block offsets
//     (sharded_statevector.py:207-254).  Bound by bytes.  A warp holds 1024
//     consecutive values, 32 a lane (two chunks of 16, scanned one after the
//     other in registers), loaded and stored by coalesced 16-byte accesses
//     through a swizzled slice of shared memory.  The chunk totals of eight
//     lanes (one chunk of the next level) reach every lane of the eight by
//     __shfl_sync, and each lane scans them in order; the totals of those
//     chunks (segments of 512 values or more) reach the segment's lanes
//     through shared memory.
//     Segments of at most 16 values take one thread each.

#include <cuda_runtime.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

constexpr int kShardThreads = 256;
constexpr int kGroupMax = 7;                       // qubits of one group product
constexpr int kScanChunk = 16;
constexpr int kScanLane = 2 * kScanChunk;          // values per lane
constexpr int kScanWarp = 32 * kScanLane;          // values per warp
constexpr int kScanThreads = 256;                  // 8 warps a block
constexpr int kScanGroup = kScanChunk / 2;         // lanes whose chunk totals form one chunk

__global__ void shard_pair_combine(float* out, const float* state, const float* partner,
                                   const float* entries, const int* ctrl_bit,
                                   const unsigned char* enabled, long long len, int target,
                                   int side) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= len) return;
  const int b = blockIdx.y;
  const float* re = state + (long long)b * 2 * len;
  const float* im = re + len;
  float* o_re = out + (long long)b * 2 * len;
  float* o_im = o_re + len;
  const float r = re[i], m = im[i];
  const int c = ctrl_bit[b];
  if (!enabled[b] || (c >= 0 && !((i >> c) & 1))) {
    o_re[i] = r;
    o_im[i] = m;
    return;
  }
  float pr, pm;
  int bit;
  if (target >= 0) {
    const long long j = i ^ (1LL << target);
    pr = re[j];
    pm = im[j];
    bit = (int)((i >> target) & 1);
  } else {
    const float* p_re = partner + (long long)b * 2 * len;
    pr = p_re[i];
    pm = p_re[len + i];
    bit = side;
  }
  // entries: u00r u00i u01r u01i u10r u10i u11r u11i
  const float* e = entries + (long long)b * 8;
  const float ar = bit ? e[6] : e[0], ai = bit ? e[7] : e[1];
  const float br = bit ? e[4] : e[2], bi = bit ? e[5] : e[3];
  o_re[i] = sum4(ar, r, -ai, m, br, pr, -bi, pm);
  o_im[i] = sum4(ar, m, ai, r, br, pm, bi, pr);
}

// A group product's tile: local bit l is global bit l below low_bits and
// global bit l + mid_bits above; the tile index fills the mid_bits global
// bits in between, then the bits above the tile's top.  A group inside the
// low tile_bits qubits has low_bits = tile_bits (a contiguous tile);
// otherwise the tile's top m bits are the group's.
struct GroupTile {
  int tile_bits, low_bits, mid_bits;
  int g_first;  // the local bit of qubit q0
};

__device__ __forceinline__ int group_tile_index(const GroupTile& g, int tile, int li) {
  const int hi0 = g.low_bits + g.mid_bits;
  const int low = li & ((1 << g.low_bits) - 1);
  const int mid = (tile & ((1 << g.mid_bits) - 1)) << g.low_bits;
  const int top = (li >> g.low_bits) << hi0;
  return low | mid | top | ((tile >> g.mid_bits) << (hi0 + g.tile_bits - g.low_bits));
}

// Register bit B's factor when tile bit s + B is one of the group's [lo, hi):
// the pair update of every register pair across that bit.
template <int B>
__device__ __forceinline__ void group_factor(float (&xr)[kRegs], float (&xi)[kRegs], int s,
                                             int lo, int hi, int g_first, const U3* fac) {
  const int l = s + B;
  if (l < lo || l >= hi) return;
  const U3 u = fac[l - g_first];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    if (j & (1 << B)) continue;
    u3_apply(u, xr[j], xi[j], xr[j | (1 << B)], xi[j | (1 << B)]);
  }
}

// Tile blockIdx.x of row blockIdx.y; entries [B, m, 8] in U3's field order.
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    shard_group_product(float* out, const float* state, const float* entries, long long len,
                        GroupTile g, int m) {
  extern __shared__ float tile_s[];  // re then im, 2^tile_bits each, swizzled
  __shared__ U3 fac_s[kGroupMax];
  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  // A tile below 2^10 amplitudes has fewer threads than the group has qubits.
  for (int k = t; k < m; k += blockDim.x) {
    const float* e = entries + ((long long)b * m + k) * 8;
    fac_s[k] = U3{e[0], e[1], e[2], e[3], e[4], e[5], e[6], e[7]};
  }
  __syncthreads();
  const float* re = state + (long long)b * 2 * len;
  const float* im = re + len;
  float* o_re = out + (long long)b * 2 * len;
  float* o_im = o_re + len;
  float* s_re = tile_s;
  float* s_im = tile_s + (1 << g.tile_bits);
  const auto index = [&](int li) { return group_tile_index(g, tile, li); };
  const int g_last = g.g_first + m;
  const int rounds = (m + kRegBits - 1) / kRegBits;
  float xr[kRegs], xi[kRegs];
  for (int c = 0; c < rounds; ++c) {
    const int lo = g.g_first + c * kRegBits;
    const int hi = min(lo + kRegBits, g_last);
    const int s = min(lo, g.tile_bits - kRegBits);
    const int base = round_index(t, s, 0);
    if (c == 0) {
      load_global(xr, xi, re, im, index, base, s);
    } else {
      load_shared(xr, xi, s_re, s_im, base, s);
    }
    group_factor<0>(xr, xi, s, lo, hi, g.g_first, fac_s);
    group_factor<1>(xr, xi, s, lo, hi, g.g_first, fac_s);
    group_factor<2>(xr, xi, s, lo, hi, g.g_first, fac_s);
    group_factor<3>(xr, xi, s, lo, hi, g.g_first, fac_s);
    group_factor<4>(xr, xi, s, lo, hi, g.g_first, fac_s);
    if (c == rounds - 1) {
      store_global(xr, xi, o_re, o_im, index, base, s);
    } else {
      store_shared(xr, xi, s_re, s_im, base, s);
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int amp_bit(long long i, int q, int local_bits, int cell) {
  return q < local_bits ? (int)((i >> q) & 1) : (cell >> (q - local_bits)) & 1;
}

// ctrl/tgt [B, slots] (-1 = unused), phase [B, slots, 2 (target bit), 2 (re, im)].
__global__ void shard_diag_phase(float* state, const int* ctrl, const int* tgt,
                                 const float* phase, long long len, int slots, int local_bits,
                                 int cell) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= len) return;
  const int b = blockIdx.y;
  float* re = state + (long long)b * 2 * len;
  float* im = re + len;
  float r = re[i], m = im[i];
  for (int j = 0; j < slots; ++j) {
    const int c = ctrl[b * slots + j];
    if (c < 0 || !amp_bit(i, c, local_bits, cell)) continue;
    const int t = amp_bit(i, tgt[b * slots + j], local_bits, cell);
    const float* ph = phase + ((long long)(b * slots + j) * 2 + t) * 2;
    const float pr = ph[0], pi = ph[1];
    const float nr = __fsub_rn(__fmul_rn(pr, r), __fmul_rn(pi, m));
    const float ni = __fadd_rn(__fmul_rn(pr, m), __fmul_rn(pi, r));
    r = nr;
    m = ni;
  }
  re[i] = r;
  im[i] = m;
}

// Segments of at most 16 values: one thread each, one add after the other.
__global__ void running_sum_short(float* out, const float* values, long long segments,
                                  int seg_len) {
  const long long seg = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (seg >= segments) return;
  const float* x = values + seg * seg_len;
  float* y = out + seg * seg_len;
  float acc = x[0];
  y[0] = acc;
  for (int k = 1; k < seg_len; ++k) {
    acc = __fadd_rn(acc, x[k]);
    y[k] = acc;
  }
}

// Float4 q of a warp's 256 in its shared-memory slice: XOR-swizzled so that
// neither the coalesced side (q = 32 c + lane) nor the lane's own side
// (q = 8 lane + c) has a bank conflict.
__device__ __forceinline__ int scan_slot(int q) { return q ^ ((q >> 3) & 7); }

// Segments of 32..4096 values (a power of two): see the header.  Lane l of
// the grid holds values [32 l, 32 l + 32): chunk a, then chunk b.
__global__ void __launch_bounds__(kScanThreads)
    shard_running_sum(float* out, const float* values, long long count, int seg_len) {
  __shared__ float4 slices[kScanThreads / 32][kScanWarp / 4];
  __shared__ float group_totals[kScanThreads / kScanGroup];
  const int lane = threadIdx.x & 31;
  const long long thread = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  const long long warp_first = (thread - lane) * kScanLane;
  float4* slice = slices[threadIdx.x / 32];
  const float4* src = reinterpret_cast<const float4*>(values + warp_first);
  float4* dst = reinterpret_cast<float4*>(out + warp_first);
  const long long live4 = (count - warp_first) / 4;  // float4s of this warp inside the array
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int q = c * 32 + lane;
    if (q < live4) slice[scan_slot(q)] = src[q];
  }
  __syncwarp();
  float a[kScanChunk], b[kScanChunk];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 v = slice[scan_slot(lane * 8 + c)];
    float* x = c < 4 ? a + 4 * c : b + 4 * (c - 4);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
#pragma unroll
  for (int k = 1; k < kScanChunk; ++k) {
    a[k] = __fadd_rn(a[k - 1], a[k]);
    b[k] = __fadd_rn(b[k - 1], b[k]);
  }
  // Level 1: the 16 chunk totals of this lane's group of 8 lanes (or of
  // the whole segment, if shorter), in order, scanned one after the other.
  const int seg_lanes = seg_len / kScanLane;
  const int group_lanes = seg_lanes < kScanGroup ? seg_lanes : kScanGroup;
  const int j = lane & (group_lanes - 1);
  float s[kScanChunk];
#pragma unroll
  for (int k = 0; k < kScanChunk; ++k) {
    s[k] = __shfl_sync(0xffffffffu, (k & 1) ? b[kScanChunk - 1] : a[kScanChunk - 1],
                       lane - j + (k >> 1));
  }
#pragma unroll
  for (int k = 1; k < kScanChunk; ++k) s[k] = __fadd_rn(s[k - 1], s[k]);
  // Level 2 (segments of more than 256 values): the running sum of the
  // segment's group totals before this lane's group.
  bool has_c2 = false;
  float c2 = 0.0f;
  if (seg_lanes > kScanGroup) {
    const int groups = seg_lanes / kScanGroup;
    const int g = (int)(thread & (seg_lanes - 1)) / kScanGroup;
    // A block's 8192 values hold whole segments, so its group totals do.
    if (j == 0) group_totals[threadIdx.x / kScanGroup] = s[kScanChunk - 1];
    __syncthreads();
    const int first = (threadIdx.x / kScanGroup) & ~(groups - 1);
    float tot[kScanChunk];
#pragma unroll
    for (int k = 0; k < kScanChunk; ++k) tot[k] = k < groups ? group_totals[first + k] : 0.0f;
    float acc = tot[0];
#pragma unroll
    for (int k = 1; k < kScanChunk; ++k) {
      if (k < g) acc = __fadd_rn(acc, tot[k]);
    }
    has_c2 = g > 0;
    c2 = acc;
  }
  // Level 0's carries: the final level-1 value before chunk a (2 j) and
  // before chunk b (2 j + 1).  Before a group's first chunk that value is
  // the level-2 running sum itself.
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int k = 0; k < kScanChunk; ++k) {
    if (k == 2 * j - 1) sa = s[k];
    if (k == 2 * j) sb = s[k];
  }
  bool has_a = has_c2;
  float ca = c2;
  if (j > 0) {
    has_a = true;
    ca = has_c2 ? __fadd_rn(sa, c2) : sa;
  }
  const float cb = has_c2 ? __fadd_rn(sb, c2) : sb;
#pragma unroll
  for (int k = 0; k < kScanChunk; ++k) {
    if (has_a) a[k] = __fadd_rn(a[k], ca);
    b[k] = __fadd_rn(b[k], cb);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float* x = c < 4 ? a + 4 * c : b + 4 * (c - 4);
    slice[scan_slot(lane * 8 + c)] = make_float4(x[0], x[1], x[2], x[3]);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int q = c * 32 + lane;
    if (q < live4) dst[q] = slice[scan_slot(q)];
  }
}

}  // namespace

extern "C" {

int qt_shard_pair_combine(void* out, const void* state, const void* partner,
                          const void* entries, const void* ctrl_bit, const void* enabled,
                          int rows, int local_bits, int target, int side, void* stream) {
  const long long len = 1LL << local_bits;
  shard_pair_combine<<<dim3(blocks_for(len, kShardThreads), rows), kShardThreads, 0,
                       (cudaStream_t)stream>>>(
      (float*)out, (const float*)state, (const float*)partner, (const float*)entries,
      (const int*)ctrl_bit, (const unsigned char*)enabled, len, target, side);
  return (int)cudaGetLastError();
}

// 5 <= local_bits, 1 <= m <= 7, q0 + m <= local_bits.
int qt_shard_group_product(void* out, const void* state, const void* entries, int rows,
                           int local_bits, int q0, int m, void* stream) {
  GroupTile g{};
  g.tile_bits = local_bits < kTileBits ? local_bits : kTileBits;
  if (q0 + m <= g.tile_bits) {
    g.low_bits = g.tile_bits;
    g.g_first = q0;
  } else {
    g.low_bits = g.tile_bits - m;
    g.mid_bits = q0 - g.low_bits;
    g.g_first = g.low_bits;
  }
  const int rounds = (m + kRegBits - 1) / kRegBits;
  const size_t smem = rounds > 1 ? (2 * sizeof(float)) << g.tile_bits : 0;
  cudaError_t err = cudaFuncSetAttribute(
      shard_group_product, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err != cudaSuccess) return (int)err;
  const long long len = 1LL << local_bits;
  shard_group_product<<<dim3((unsigned int)(len >> g.tile_bits), rows),
                        1 << (g.tile_bits - kRegBits), smem, (cudaStream_t)stream>>>(
      (float*)out, (const float*)state, (const float*)entries, len, g, m);
  return (int)cudaGetLastError();
}

int qt_shard_diag_phase(void* state, const void* ctrl, const void* tgt, const void* phase,
                        int rows, int local_bits, int slots, int cell, void* stream) {
  const long long len = 1LL << local_bits;
  shard_diag_phase<<<dim3(blocks_for(len, kShardThreads), rows), kShardThreads, 0,
                     (cudaStream_t)stream>>>((float*)state, (const int*)ctrl, (const int*)tgt,
                                             (const float*)phase, len, slots, local_bits, cell);
  return (int)cudaGetLastError();
}

// seg_len a power of two <= 4096; count a multiple of it.
int qt_shard_running_sum(void* out, const void* values, long long count, int seg_len,
                         void* stream) {
  if (seg_len < kScanLane) {
    const long long segments = count / seg_len;
    running_sum_short<<<blocks_for(segments, kShardThreads), kShardThreads, 0,
                        (cudaStream_t)stream>>>((float*)out, (const float*)values, segments,
                                                seg_len);
  } else {
    const long long per_block = (long long)kScanThreads * kScanLane;
    shard_running_sum<<<(unsigned int)((count + per_block - 1) / per_block), kScanThreads, 0,
                        (cudaStream_t)stream>>>((float*)out, (const float*)values, count,
                                                seg_len);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
