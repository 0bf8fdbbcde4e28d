// Pieces shared by the slot, fold and compacted-gate kernels: the gate
// codes, the U3 entries and pair update, the deterministic energy reduction
// and the probability pass.
//
// A state is two float32 planes [2, 2^n] (re, im); a population of P states
// is [P, 2, 2^n].  The energy reduction sums (re^2 + im^2) * table in a fixed
// order -- per-block partials over fixed chunks, then one block per row --
// with no float atomics, so equal inputs give equal bits from run to run (an
// EVQE trajectory branches on energy order).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kGateRot = 1;   // U3
constexpr int kGateCrot = 3;  // CU3
constexpr int kPairThreads = 256;
constexpr int kReduceThreads = 256;
constexpr long long kReduceChunk = 4096;  // elements per first-pass block

// ((a0 b0 + a1 b1) + a2 b2) + a3 b3 with every product and sum rounded on its
// own (no FMA contraction): the plain version's order of operations
// (sim/statevector.py::apply_u3_pairs), so on the card a state equals its
// plain version's bit for bit.
__device__ __forceinline__ float sum4(float a0, float b0, float a1, float b1, float a2,
                                      float b2, float a3, float b3) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2)),
                   __fmul_rn(a3, b3));
}

// The U3(theta, phi, lam) entries (re, im) of _u3_entries
// (queasars_tpu/sim/pallas_kernels.py:44-52), computed with sinf/cosf as the
// plain version's torch.sin/torch.cos compute them on the card.
struct U3 {
  float u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i;
};

__device__ __forceinline__ U3 u3_entries(float theta, float phi, float lam) {
  const float sin_t = sinf(theta * 0.5f), cos_t = cosf(theta * 0.5f);
  const float pl = __fadd_rn(phi, lam);
  return U3{cos_t,           0.0f,           -cosf(lam) * sin_t, -sinf(lam) * sin_t,
            cosf(phi) * sin_t, sinf(phi) * sin_t, cosf(pl) * cos_t,   sinf(pl) * cos_t};
}

// U3 u on one amplitude pair (r0 + i m0, r1 + i m1), whose second index has
// the target bit set.  The engines, the sweep passes and the plain version
// (sim/statevector.py::apply_u3_pairs) all round alike.
__device__ __forceinline__ void u3_apply(const U3& u, float& r0, float& m0, float& r1, float& m1) {
  const float a = r0, b = m0, c = r1, d = m1;
  r0 = sum4(u.u00r, a, -u.u00i, b, u.u01r, c, -u.u01i, d);
  m0 = sum4(u.u00r, b, u.u00i, a, u.u01r, d, u.u01i, c);
  r1 = sum4(u.u11r, c, -u.u11i, d, u.u10r, a, -u.u10i, b);
  m1 = sum4(u.u11r, d, u.u11i, c, u.u10r, b, u.u10i, a);
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
