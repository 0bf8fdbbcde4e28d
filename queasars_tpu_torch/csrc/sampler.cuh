// The in-kernel shot sampler's epilogue, shared by the slot and the fold
// sampled kernels (qt_sampled_shot_indices, qt_sampled_shot_indices_folded).
//
// Counterpart of _sample_shots_from_probs (queasars_tpu/sim/pallas_kernels.py:
// 502-656): a hierarchical inverse CDF over the probabilities |psi|^2 of a
// population's state planes [P, 2, 2^n], at given uniforms u_frac [P, S],
// writing sampled basis indices int32 [P, S].  The index space is B blocks x
// 128 rows x 128 lanes (R = 2^(n-7) rows, B = R / 128; n >= 14).
//
// The TPU kernel resolves every level for all shots at once on a VMEM-resident
// state with exact one-hot matmul gathers.  Here the state stays in device
// memory and three small kernels follow the circuit:
//   1. row_block_prefix, one block of 128 threads per (128-row block,
//      individual): each warp sums 32 rows (lane l adds its values l, l+32,
//      l+64, l+96 pairwise, then a shuffle-down tree), the 128 row masses are
//      scanned in shared memory (log steps, as the TPU's roll scans) into the
//      in-block row prefix, whose largest entry is the block total;
//   2. block_prefix, one block per individual: the log-step scan of the block
//      totals (cb) and their sum by halving (the total);
//   3. search, one block of 128 threads per shot: u = frac * total, then per
//      level the count of prefix values <= u (clamped) and u minus the largest
//      of them; the last level re-reads the chosen row's 128 amplitudes from
//      the planes and scans their probabilities.
// Bound: bytes (one read of the planes in step 1, 128 amplitudes per shot in
// step 3); the circuit before it dominates.  Every sum is a fixed tree or
// scan with explicit round-to-nearest adds (no FMA contraction, no atomics),
// the order that sim/sampling.py::hierarchical_sample_plain repeats, so equal
// inputs give equal bits and the plain version agrees bit for bit on equal
// probabilities.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSamplerLanes = 128;

__device__ __forceinline__ float prob_of(const float* re, const float* im, long long i) {
  return __fadd_rn(__fmul_rn(re[i], re[i]), __fmul_rn(im[i], im[i]));
}

// Inclusive log-step scan of s[0, width) by threads [0, 128) of the block;
// every thread of the block must call it.
__device__ void block_scan(float* s, int width) {
  const int t = threadIdx.x;
  for (int d = 1; d < width; d <<= 1) {
    const float add = (t < width && t >= d) ? s[t - d] : 0.0f;
    __syncthreads();
    if (t < width && t >= d) s[t] = __fadd_rn(s[t], add);
    __syncthreads();
  }
}

// The largest value over the block's 128 threads (exact: max needs no order).
__device__ float block_max(float v, float* scratch4) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) scratch4[threadIdx.x >> 5] = v;
  __syncthreads();
  const float m = fmaxf(fmaxf(scratch4[0], scratch4[1]), fmaxf(scratch4[2], scratch4[3]));
  __syncthreads();
  return m;
}

// One level of the search: (count of prefix values <= u clamped to cap, and
// u minus the largest such value or minus 0).  Thread t holds value t
// (valid when t < width).
__device__ int search_level(float value, bool valid, float u, int cap, float* scratch4,
                            float* rest) {
  const bool below = valid && value <= u;
  const int count = __syncthreads_count(below);
  const float base = block_max(below ? value : 0.0f, scratch4);
  *rest = __fsub_rn(u, base);
  return min(count, cap);
}

// Step 1: grid (B, P), 128 threads.
__global__ void sampler_row_block_prefix(const float* state, float* row_prefix, float* block_tot,
                                         long long dim) {
  __shared__ float s[kSamplerLanes];
  __shared__ float scratch4[4];
  const int p = blockIdx.y, b = blockIdx.x, n_blocks = gridDim.x;
  const long long rows = dim / kSamplerLanes;
  const float* re = state + (long long)p * 2 * dim;
  const float* im = re + dim;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < kSamplerLanes; j += 4) {
    const long long base = ((long long)b * kSamplerLanes + j) * kSamplerLanes;
    const float v0 = prob_of(re, im, base + lane), v1 = prob_of(re, im, base + lane + 32);
    const float v2 = prob_of(re, im, base + lane + 64), v3 = prob_of(re, im, base + lane + 96);
    float x = __fadd_rn(__fadd_rn(v0, v1), __fadd_rn(v2, v3));
    for (int off = 16; off > 0; off >>= 1) {
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
    }
    if (lane == 0) s[j] = x;
  }
  __syncthreads();
  block_scan(s, kSamplerLanes);
  const float mine = s[threadIdx.x];
  row_prefix[(long long)p * rows + (long long)b * kSamplerLanes + threadIdx.x] = mine;
  const float top = block_max(mine, scratch4);
  if (threadIdx.x == 0) block_tot[(long long)p * n_blocks + b] = top;
}

// Step 2: grid P, 128 threads; n_blocks <= 128.
__global__ void sampler_block_prefix(const float* block_tot, float* cb, float* total,
                                     int n_blocks) {
  __shared__ float s[kSamplerLanes];
  __shared__ float h[kSamplerLanes];
  const int p = blockIdx.x, t = threadIdx.x;
  const float v = t < n_blocks ? block_tot[(long long)p * n_blocks + t] : 0.0f;
  s[t] = v;
  h[t] = v;
  __syncthreads();
  block_scan(s, n_blocks);
  if (t < n_blocks) cb[(long long)p * n_blocks + t] = s[t];
  for (int half = n_blocks / 2; half > 0; half >>= 1) {
    const float add = t < half ? h[t + half] : 0.0f;
    __syncthreads();
    if (t < half) h[t] = __fadd_rn(h[t], add);
    __syncthreads();
  }
  if (t == 0) total[p] = h[0];
}

// Step 3: grid (S, P), 128 threads.
__global__ void sampler_search(const float* state, const float* row_prefix, const float* cb,
                               const float* total, const float* u_frac, int* out, long long dim,
                               int n_blocks, int shots) {
  __shared__ float s[kSamplerLanes];
  __shared__ float scratch4[4];
  const int p = blockIdx.y, shot = blockIdx.x, t = threadIdx.x;
  const long long rows = dim / kSamplerLanes;
  const float u = __fmul_rn(u_frac[(long long)p * shots + shot], total[p]);
  float u1, u2, rest;
  const bool in_range = t < n_blocks;
  const float c = in_range ? cb[(long long)p * n_blocks + t] : 0.0f;
  const int block = search_level(c, in_range, u, n_blocks - 1, scratch4, &u1);
  const long long first_row = (long long)block * kSamplerLanes;
  const float rp = row_prefix[(long long)p * rows + first_row + t];
  const int row = search_level(rp, true, u1, kSamplerLanes - 1, scratch4, &u2);
  const long long global_row = first_row + row;
  const float* re = state + (long long)p * 2 * dim;
  s[t] = prob_of(re, re + dim, global_row * kSamplerLanes + t);
  __syncthreads();
  block_scan(s, kSamplerLanes);
  const int lane = search_level(s[t], true, u2, kSamplerLanes - 1, scratch4, &rest);
  if (t == 0) out[(long long)p * shots + shot] = (int)(global_row * kSamplerLanes + lane);
}

// Floats of sampler scratch per individual: row prefix [R], block totals
// [B], block prefix [B], total [1].
long long sampler_scratch_floats(int n_qubits) {
  const long long rows = 1LL << (n_qubits - 7);
  return rows + 2 * (rows / kSamplerLanes) + 1;
}

// Sample indices out [P, S] from state planes [P, 2, 2^n] at u_frac [P, S];
// scratch holds P * sampler_scratch_floats(n) floats.
cudaError_t sample_planes(const float* state, const float* u_frac, float* scratch, int* out,
                          int pop, int n_qubits, int shots, cudaStream_t stream) {
  if (n_qubits < 14 || n_qubits > 21 || shots < 1) return cudaErrorInvalidValue;
  const long long dim = 1LL << n_qubits;
  const long long rows = dim / kSamplerLanes;
  const int n_blocks = (int)(rows / kSamplerLanes);
  float* row_prefix = scratch;
  float* block_tot = row_prefix + (long long)pop * rows;
  float* cb = block_tot + (long long)pop * n_blocks;
  float* total = cb + (long long)pop * n_blocks;
  sampler_row_block_prefix<<<dim3(n_blocks, pop), kSamplerLanes, 0, stream>>>(state, row_prefix,
                                                                             block_tot, dim);
  sampler_block_prefix<<<pop, kSamplerLanes, 0, stream>>>(block_tot, cb, total, n_blocks);
  sampler_search<<<dim3(shots, pop), kSamplerLanes, 0, stream>>>(state, row_prefix, cb, total,
                                                                 u_frac, out, dim, n_blocks,
                                                                 shots);
  return cudaGetLastError();
}

}  // namespace
