// The three-point NFT step's bookkeeping for Hopper (sm_90a) behind a plain
// C interface.
//
// optim/nft.py::_nft_steps moves a whole population in lock-step: each step
// evaluates two probes (coordinate k mod n_free of every individual at
// +-pi/2), fits the sinusoid of optim/nft_math.py::nft_three_point_update
// and moves the active individuals' coordinate to the fit's minimum.  As
// PyTorch operations the work around the two probe evaluations is about 60
// small launches a step, and at n=20 the host's time to issue them exceeds
// the card's time for the probes.  qt_nft_step does it in one launch.  It
// replaces no TPU kernel: the JAX package leaves the same loop to XLA inside
// one jit.
//
// One block per individual.  Thread 0 fits z0, z1 and z3 of step update_k
// and, where the individual is active with a free coordinate, computes the
// coordinate's new value and writes z; then the block writes the angles
// (src with that coordinate moved) to `angles` and, for step probe_k, the
// two probe tensors: copies of the new angles with probe_k's coordinate at
// +-pi/2.  update_k < 0 only copies src (the call's first launch);
// probe_k < 0 writes no probes (the call's last step).  Bound by launch
// latency: its bytes (angles read once, written three times, 92 KB at P=16,
// L=6, n=20) take 0.03 us at 3.35 TB/s.
//
// Bits: each operation is the PyTorch loop's (_nft_steps' reference path),
// in its order and rounded on its own (__fadd_rn, __fmul_rn, __fsqrt_rn:
// nvcc would contract a*b+c into an FMA), and atan2f is the function
// torch.atan2 computes on the card, so the angles and z equal that loop's
// bit for bit.  sweep.cuh::sweep_update groups theta + atan2f + pi the other
// way and may contract, so it is not reused.

#include <cuda_runtime.h>

namespace {

constexpr int kStepThreads = 128;
// float32(pi) and float32(pi / 2): the float32 values PyTorch gives the
// loop's Python constants math.pi and math.pi / 2
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kHalfPi = static_cast<float>(3.14159265358979323846 / 2);

// Offset in an individual's [L, n, 3] angles of its coordinate of step k:
// coords[p, k mod max(n_free, 1)] as (layer, qubit, angle).
__device__ __forceinline__ int step_offset(const int* coords, int p, int k, int n_free,
                                           int n_coords, int n_qubits) {
  const int* c = coords + ((long long)p * n_coords + k % max(n_free, 1)) * 3;
  return (c[0] * n_qubits + c[1]) * 3 + c[2];
}

__global__ void nft_step(const float* src, float* angles, float* plus, float* minus,
                         float* z_out, const float* z0, const float* z1, const float* z3,
                         const int* coords, const int* n_free, const bool* active, int entries,
                         int n_coords, int n_qubits, int update_k, int probe_k) {
  __shared__ int moved;
  __shared__ float moved_value;
  const int p = blockIdx.x;
  const int free_count = n_free[p];
  const float* from = src + (long long)p * entries;
  if (threadIdx.x == 0) {
    int at = -1;
    float value = 0.0f;
    if (update_k >= 0) {
      const float a = z0[p], b = z1[p], c = z3[p];
      const float mid = __fmul_rn(__fadd_rn(b, c), 0.5f);
      const float d = __fsub_rn(a, mid);
      const float e = __fmul_rn(__fsub_rn(b, c), 0.5f);
      const float square_sum = __fadd_rn(__fmul_rn(d, d), __fmul_rn(e, e));
      const bool apply = active[p] && free_count > 0;
      if (apply) {
        at = step_offset(coords, p, update_k, free_count, n_coords, n_qubits);
        value = __fadd_rn(from[at], __fadd_rn(atan2f(e, d), kPi));
      }
      z_out[p] = apply ? __fsub_rn(mid, __fsqrt_rn(square_sum)) : a;
    }
    moved = at;
    moved_value = value;
  }
  __syncthreads();
  const int at = moved;
  const float value = moved_value;
  const int probe =
      probe_k >= 0 ? step_offset(coords, p, probe_k, free_count, n_coords, n_qubits) : -1;
  const long long base = (long long)p * entries;
  for (int j = threadIdx.x; j < entries; j += blockDim.x) {
    const float v = j == at ? value : from[j];
    angles[base + j] = v;
    if (probe >= 0) {
      plus[base + j] = j == probe ? __fadd_rn(v, kHalfPi) : v;
      minus[base + j] = j == probe ? __fsub_rn(v, kHalfPi) : v;
    }
  }
}

}  // namespace

extern "C" {

// src, angles, plus, minus [P, L, n, 3] float32 (src may be angles); z_out,
// z0, z1, z3 [P] float32 (z0 may be z_out); coords [P, n_coords, 3] int32;
// n_free [P] int32; active [P] bool.  z0, z1 and z3 are read only when
// update_k >= 0, plus and minus written only when probe_k >= 0.
int qt_nft_step(void* src, void* angles, void* plus, void* minus, void* z_out, void* z0,
                void* z1, void* z3, void* coords, void* n_free, void* active, int pop,
                int entries, int n_coords, int n_qubits, int update_k, int probe_k,
                void* stream) {
  if (pop > 0) {
    nft_step<<<pop, kStepThreads, 0, (cudaStream_t)stream>>>(
        (const float*)src, (float*)angles, (float*)plus, (float*)minus, (float*)z_out,
        (const float*)z0, (const float*)z1, (const float*)z3, (const int*)coords,
        (const int*)n_free, (const bool*)active, entries, n_coords, n_qubits, update_k,
        probe_k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
