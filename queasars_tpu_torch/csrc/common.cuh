// Pieces shared by the slot and fold kernels: state initialisation, the
// deterministic energy reduction and the probability pass.
//
// A state is two float32 planes [2, 2^n] (re, im); a population of P states
// is [P, 2, 2^n].  The energy reduction sums (re^2 + im^2) * table in a fixed
// order -- per-block partials over fixed chunks, then one block per row --
// with no float atomics, so equal inputs give equal bits from run to run (an
// EVQE trajectory branches on energy order).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kPairThreads = 256;
constexpr int kReduceThreads = 256;
constexpr long long kReduceChunk = 4096;  // elements per first-pass block

__global__ void init_zero_state(float* state, long long dim) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= dim) return;
  float* s = state + (long long)blockIdx.y * 2 * dim;
  s[i] = i == 0 ? 1.0f : 0.0f;
  s[dim + i] = 0.0f;
}

__device__ float block_sum(float value, float* shared) {
  shared[threadIdx.x] = value;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) shared[threadIdx.x] += shared[threadIdx.x + stride];
    __syncthreads();
  }
  return shared[0];
}

__global__ void energy_partials(const float* state, const float* table, float* partial,
                                long long dim, long long chunk) {
  __shared__ float shared[kReduceThreads];
  const int p = blockIdx.y;
  const float* re = state + (long long)p * 2 * dim;
  const float* im = re + dim;
  const long long begin = blockIdx.x * chunk;
  float acc = 0.0f;
  for (long long i = begin + threadIdx.x; i < begin + chunk; i += blockDim.x) {
    const float r = re[i], m = im[i];
    acc += (r * r + m * m) * table[i];
  }
  const float total = block_sum(acc, shared);
  if (threadIdx.x == 0) partial[(long long)p * gridDim.x + blockIdx.x] = total;
}

// out[row] = sum of partial[row, 0 .. n_partials) in a fixed order.
__global__ void energy_finish(const float* partial, float* out, int n_partials) {
  __shared__ float shared[kReduceThreads];
  const float* row = partial + (long long)blockIdx.x * n_partials;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n_partials; b += blockDim.x) acc += row[b];
  const float total = block_sum(acc, shared);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

__global__ void probabilities(const float* state, float* probs, long long dim) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= dim) return;
  const float* re = state + (long long)blockIdx.y * 2 * dim;
  const float r = re[i], m = re[dim + i];
  probs[(long long)blockIdx.y * dim + i] = r * r + m * m;
}

unsigned int blocks_for(long long count, int threads) {
  return (unsigned int)((count + threads - 1) / threads);
}

long long reduce_chunk(long long count) { return count < kReduceChunk ? count : kReduceChunk; }

// State p starts from |0...0>, or from initial[p] when initial is given.
cudaError_t init_states(float* state, const float* initial, int pop, long long dim,
                        cudaStream_t stream) {
  if (initial != nullptr) {
    return cudaMemcpyAsync(state, initial, (size_t)pop * 2 * dim * sizeof(float),
                           cudaMemcpyDeviceToDevice, stream);
  }
  init_zero_state<<<dim3(blocks_for(dim, kPairThreads), pop), kPairThreads, 0, stream>>>(state,
                                                                                         dim);
  return cudaGetLastError();
}

void reduce_energies(const float* state, const float* table, float* partial, float* out,
                     int pop, long long dim, cudaStream_t stream) {
  const long long chunk = reduce_chunk(dim);
  const int n_partials = (int)(dim / chunk);
  energy_partials<<<dim3(n_partials, pop), kReduceThreads, 0, stream>>>(state, table, partial, dim,
                                                                         chunk);
  energy_finish<<<pop, kReduceThreads, 0, stream>>>(partial, out, n_partials);
}

void write_probabilities(const float* state, float* probs, int pop, long long dim,
                         cudaStream_t stream) {
  probabilities<<<dim3(blocks_for(dim, kPairThreads), pop), kPairThreads, 0, stream>>>(state, probs,
                                                                                       dim);
}

}  // namespace
