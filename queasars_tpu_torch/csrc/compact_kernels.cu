// Compacted-gate kernels for Hopper (sm_90a) behind a plain C interface.
//
// Counterparts of compact_energies_exact and compact_probs of
// queasars_tpu/sim/compact_kernels.py.  Built by the same nvcc call as the
// slot and fold kernels (queasars_tpu_torch/utils/cuda_lib.py); every entry
// point takes raw device pointers plus the caller's stream, launches on that
// stream, never synchronises, allocates nothing and returns
// cudaGetLastError().
//
// Input: each individual's active gates only, compacted on the host
// (queasars_tpu_torch/sim/compact_kernels.py::compact_gates) and sorted by
// (layer, lane group q < 7, row group q >= 7, qubit) -- ascending qubit order
// within a layer, the order in which the slot kernels apply it:
//   qubits, controls, angle_index [P, G] int32 (control -1 = plain U3;
//   angle_index = layer * n + qubit into the [P, L*n, 3] view of the live
//   angles [P, L, n, 3]) and boundaries [P, 2L+1] int32, whose last column
//   is each individual's count.  Entries past the count are padding.
//
// Design.  The TPU kernel keeps one state in VMEM and runs two dynamic-bound
// loops per layer over the list.  Here, as in the slot kernels, states live
// in device memory and many blocks share each state:
//   * gate pass: one launch per compacted index g = 0 .. max_count-1 over the
//     whole population (the host knows max_count, so it never reads the card
//     back); a thread owns one amplitude pair.  Each block reads its
//     individual's count, g-th qubit, control and angle triple straight from
//     the angles through angle_index (no gathered copy) and returns at once
//     past its individual's count, so padding is never visited.  The pair
//     update is common.cuh's u3_pair_update, the slot gate pass's own.
//   * energy / probabilities: common.cuh's fixed-order reduction and
//     probability pass, as rows 1 and 4 use them.
//   Same gates in the same order with the same arithmetic: the results equal
//   the slot kernels' bit for bit on the same genome.
// Bound: device-memory bytes, 32 per amplitude pair and active gate (16 for
// the half of a CU3 pair whose control bit is set), as the slot gate pass;
// the compaction removes the launches and block scheduling of the empty
// (layer, slot) positions, not bytes.  Shared-memory runs of consecutive
// low-qubit gates of the sorted list are left for later work.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

struct CompactGenome {
  const int* qubits;       // [pop, max_gates]
  const int* controls;     // [pop, max_gates]; -1 = plain U3
  const int* angle_index;  // [pop, max_gates]; into angles [pop, n_layers * n_qubits, 3]
  const int* boundaries;   // [pop, 2 * n_layers + 1]
  const float* angles;     // [pop, n_layers, n_qubits, 3]
  int max_gates;
  int n_layers;
  int n_qubits;
};

// Gate g of every individual whose count exceeds g.
__global__ void apply_compact_gate(float* state, CompactGenome c, int g, long long dim) {
  const int p = blockIdx.y;
  const int width = 2 * c.n_layers + 1;
  if (g >= c.boundaries[(long long)p * width + width - 1]) return;
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= dim / 2) return;
  const long long e = (long long)p * c.max_gates + g;
  const int q = c.qubits[e];
  const long long i0 = ((j >> q) << (q + 1)) | (j & ((1LL << q) - 1));
  const int control = c.controls[e];
  if (control >= 0 && ((i0 >> control) & 1) == 0) return;
  const float* a =
      c.angles + ((long long)p * c.n_layers * c.n_qubits + c.angle_index[e]) * 3;
  float* re = state + (long long)p * 2 * dim;
  u3_pair_update(re, re + dim, i0, i0 | (1LL << q), a[0], a[1], a[2]);
}

// Every state from |0...0>, then gates 0 .. max_count-1 of each list.
cudaError_t run_compact_circuit(float* state, const CompactGenome& c, int pop, int max_count,
                                long long dim, cudaStream_t stream) {
  if (max_count < 0 || max_count > c.max_gates) return cudaErrorInvalidValue;
  cudaError_t err = init_states(state, nullptr, pop, dim, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks_for(dim / 2, kPairThreads), pop);
  for (int g = 0; g < max_count; ++g) {
    apply_compact_gate<<<grid, kPairThreads, 0, stream>>>(state, c, g, dim);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Replaces compact_energies_exact (queasars_tpu/sim/compact_kernels.py:338):
// out [P].  work [P, 2, 2^n] and partial [P, qt_energy_partials(n)] are
// scratch.
int qt_compact_energies_exact(float* out, float* work, float* partial, const int* qubits,
                              const int* controls, const int* angle_index,
                              const int* boundaries, const float* angles, const float* table,
                              int pop, int max_gates, int max_count, int n_layers, int n_qubits,
                              void* stream) {
  const long long dim = 1LL << n_qubits;
  const cudaStream_t s = (cudaStream_t)stream;
  const CompactGenome c{qubits, controls, angle_index, boundaries, angles,
                        max_gates, n_layers, n_qubits};
  cudaError_t err = run_compact_circuit(work, c, pop, max_count, dim, s);
  if (err != cudaSuccess) return (int)err;
  reduce_energies(work, table, partial, out, pop, dim, s);
  return (int)cudaGetLastError();
}

// Replaces compact_probs (queasars_tpu/sim/compact_kernels.py:353):
// probs [P, 2^n].  work [P, 2, 2^n] is scratch.
int qt_compact_probs(float* probs, float* work, const int* qubits, const int* controls,
                     const int* angle_index, const int* boundaries, const float* angles,
                     int pop, int max_gates, int max_count, int n_layers, int n_qubits,
                     void* stream) {
  const long long dim = 1LL << n_qubits;
  const cudaStream_t s = (cudaStream_t)stream;
  const CompactGenome c{qubits, controls, angle_index, boundaries, angles,
                        max_gates, n_layers, n_qubits};
  cudaError_t err = run_compact_circuit(work, c, pop, max_count, dim, s);
  if (err != cudaSuccess) return (int)err;
  write_probabilities(work, probs, pop, dim, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
