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
//   * qt_shard_group_product: a dense [d, d] complex matrix (d = 2^m <= 128)
//     on the m qubits [q0, q0 + m) of every row, each output summed over
//     the d inputs in index order (four real accumulators, then one
//     subtraction and one addition), S group instances per CUDA block so
//     that the matrix is read from L2 once per S instances.  The fold
//     route's group products (sharded_fold.py:69-165).
//   * qt_shard_diag_phase: one kron layer's controlled-diagonal phase slots
//     on every row, in slot order, control and target bits read from the
//     in-shard index or the cell id (sharded_fold.py:167-202).  In place.
//   * qt_shard_running_sum: inclusive running sums of segments of <= 4096
//     values in XLA's CPU order for a cumsum (sequential within chunks of
//     16, plus the running sum of the chunk totals before, recursively;
//     sim/sampling.py::running_sum).  The blocked shot sampler's block
//     CDFs and block offsets (sharded_statevector.py:207-254).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kShardThreads = 256;
constexpr int kScanChunk = 16;
constexpr int kScanMax = 4096;

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

// Index of element k of group instance t: the instance's bits below q0 and
// above q0 + m, with k in the group bits.
__device__ __forceinline__ long long group_index(long long t, int k, int q0, int m) {
  const long long low = t & ((1LL << q0) - 1);
  return (((t >> q0) << (q0 + m)) | low) + ((long long)k << q0);
}

// blockDim.x == d; block (x, b) holds instances [x S, x S + S) of row b.
// ut is the matrix transposed per row: ut[b][plane][j][k] = U[k][j].
__global__ void shard_group_product(float* out, const float* state, const float* ut,
                                    long long len, int q0, int m, int per_block) {
  extern __shared__ float tile[];  // [2][S][d]
  const int d = 1 << m;
  const int k = threadIdx.x;
  const int b = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * per_block;
  const float* re = state + (long long)b * 2 * len;
  const float* im = re + len;
  for (int e = threadIdx.x; e < per_block * d; e += blockDim.x) {
    // along the instances when they are adjacent in memory (q0 > 0), else
    // along the group's contiguous lanes
    const int s = q0 > 0 ? e % per_block : e / d;
    const int j = q0 > 0 ? e / per_block : e % d;
    const long long idx = group_index(t0 + s, j, q0, m);
    tile[s * d + j] = re[idx];
    tile[(per_block + s) * d + j] = im[idx];
  }
  __syncthreads();
  const float* ur = ut + (long long)b * 2 * d * d;
  const float* ui = ur + (long long)d * d;
  float rr[8], ii[8], ri[8], ir[8];
  for (int s = 0; s < per_block; ++s) rr[s] = ii[s] = ri[s] = ir[s] = 0.0f;
  for (int j = 0; j < d; ++j) {
    const float a = ur[j * d + k], c = ui[j * d + k];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (s < per_block) {
        const float xr = tile[s * d + j], xi = tile[(per_block + s) * d + j];
        rr[s] = __fadd_rn(rr[s], __fmul_rn(xr, a));
        ii[s] = __fadd_rn(ii[s], __fmul_rn(xi, c));
        ri[s] = __fadd_rn(ri[s], __fmul_rn(xr, c));
        ir[s] = __fadd_rn(ir[s], __fmul_rn(xi, a));
      }
    }
  }
  float* o_re = out + (long long)b * 2 * len;
  float* o_im = o_re + len;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s < per_block) {
      const long long idx = group_index(t0 + s, k, q0, m);
      o_re[idx] = __fsub_rn(rr[s], ii[s]);
      o_im[idx] = __fadd_rn(ri[s], ir[s]);
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

// One CUDA block per segment.  Level l holds the chunk totals of level l - 1;
// each level is scanned in place within its chunks of 16 (one thread per
// chunk), then, top down, every chunk but the first adds the running sum of
// the chunk totals before it.
__global__ void shard_running_sum(float* out, const float* values, int seg_len) {
  __shared__ float levels[kScanMax + kScanMax / kScanChunk + kScanMax / 256 + 16];
  const long long base = (long long)blockIdx.x * seg_len;
  for (int i = threadIdx.x; i < seg_len; i += blockDim.x) levels[i] = values[base + i];
  __syncthreads();
  int offsets[4];
  int lens[4];
  int depth = 0;
  int offset = 0, len = seg_len;
  while (true) {
    offsets[depth] = offset;
    lens[depth] = len;
    const int chunks = len > kScanChunk ? len / kScanChunk : 1;
    const int width = len > kScanChunk ? kScanChunk : len;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      float* x = levels + offset + c * width;
      for (int k = 1; k < width; ++k) x[k] = __fadd_rn(x[k - 1], x[k]);
      if (len > kScanChunk) levels[offset + len + c] = x[width - 1];
    }
    __syncthreads();
    if (len <= kScanChunk) break;
    offset += len;
    len = chunks;
    ++depth;
  }
  for (int l = depth - 1; l >= 0; --l) {
    const float* totals = levels + offsets[l + 1];
    for (int i = threadIdx.x; i < lens[l]; i += blockDim.x) {
      const int c = i / kScanChunk;
      if (c > 0) levels[offsets[l] + i] = __fadd_rn(levels[offsets[l] + i], totals[c - 1]);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < seg_len; i += blockDim.x) out[base + i] = levels[i];
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

int qt_shard_group_product(void* out, const void* state, const void* ut, int rows,
                           int local_bits, int q0, int m, void* stream) {
  const long long len = 1LL << local_bits;
  const int d = 1 << m;
  const long long instances = len >> m;
  const int per_block = instances < 8 ? (int)instances : 8;
  const size_t shared = sizeof(float) * 2 * per_block * d;
  shard_group_product<<<dim3((unsigned int)(instances / per_block), rows), d, shared,
                        (cudaStream_t)stream>>>((float*)out, (const float*)state,
                                                (const float*)ut, len, q0, m, per_block);
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

int qt_shard_running_sum(void* out, const void* values, int segments, int seg_len,
                         void* stream) {
  shard_running_sum<<<segments, kShardThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, (const float*)values, seg_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
