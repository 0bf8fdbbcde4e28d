// Compacted-gate kernels for Hopper (sm_90a) behind a plain C interface.
//
// Counterparts of compact_energies_exact and compact_probs of
// queasars_tpu/sim/compact_kernels.py.  Built with the slot and fold kernels
// into one shared library (queasars_tpu_torch/utils/cuda_lib.py); every entry
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
//   angles [P, L, n, 3]) and boundaries [P, 2L+1] int32: layer l's gates are
//   [boundaries[p, 2l], boundaries[p, 2l+2]), and the last column is each
//   individual's count.  Entries past the count are padding.
//
// Design.  The TPU kernel keeps one state in VMEM and runs two dynamic-bound
// loops per layer over the list.  Here the list feeds the slot circuit
// engine (slot_engine.cuh::run_slots) through ListSource: the same 2^13-
// amplitude tile passes as rows 1-5, one launch for every layer at n <= 13,
// one per (layer, window) above (two at n <= 22).  A pass reads only its
// individual's segments: the scan for work runs over the entries of its
// layers, the fill of layer k writes the gates of k's segment whose qubit
// lies in the pass's window (control >= 0: a CU3; the angle triple straight
// from the live angles through angle_index, no gathered copy) and clears the
// window's other bits.  Entries past the count are never read.  A layer's
// gates commute and the list is in the engine's order, so the states, and
// common.cuh's fixed-order energies and probabilities after them, equal
// rows 1's and 4's bits on the genome the list was compacted from.
// Bound: as the slot engine, the planes' bytes, two read+write passes per
// layer with a gate and individual at n > 13 (16 MB each at n=20); the
// list saves a pass's setup only the reads of the empty slots.

#include <cuda_runtime.h>

#include "common.cuh"
#include "slot_engine.cuh"

namespace {

// The engine's gate source over each individual's compacted list.
struct ListSource {
  const int* qubits;       // [pop, max_gates]
  const int* controls;     // [pop, max_gates]; -1 = plain U3
  const int* angle_index;  // [pop, max_gates]; into angles [pop, n_layers * n_qubits, 3]
  const int* boundaries;   // [pop, 2 * n_layers + 1]
  const float* angles;     // [pop, n_layers, n_qubits, 3]
  int max_gates;
  int n_layers;
  int n_qubits;

  __device__ __forceinline__ const int* segments(int p) const {
    return boundaries + (long long)p * (2 * n_layers + 1);
  }

  // The entries of layers [k_begin, k_end) (slot_engine.cuh's scan
  // contract); the layers before k_begin count by their boundaries alone.
  __device__ __forceinline__ void scan(int p, const SlotPass& ps, int k_begin, int k_end,
                                       int& earlier, int& work) const {
    const int* b = segments(p);
    const int kb = min(k_begin, n_layers), ke = min(k_end, n_layers);
    if (b[2 * kb] > b[0]) earlier = 1;
    const int first_end = kb < n_layers ? b[2 * kb + 2] : b[2 * kb];
    const int* q = qubits + (long long)p * max_gates;
    for (int e = b[2 * kb] + threadIdx.x; e < b[2 * ke]; e += blockDim.x) {
      const int w = window_of(n_qubits, q[e]);
      if (e < first_end && w < ps.window) earlier = 1;
      if (w == ps.window) work = 1;
    }
  }

  // Layer k's gates in the pass's window on their local bits, every other
  // local bit cleared (the fill contract).
  __device__ __forceinline__ void fill(int p, int k, const SlotPass& ps, int* type_s,
                                       int* ctrl_s, U3* u3_s) const {
    const int lb_last = ps.lb_first + ps.q_hi - ps.q_lo;
    for (int l = ps.lb_first + threadIdx.x; l < lb_last; l += blockDim.x) type_s[l] = 0;
    __syncthreads();
    if (k >= n_layers) return;
    const int* b = segments(p);
    const long long row = (long long)p * max_gates;
    for (int e = b[2 * k] + threadIdx.x; e < b[2 * k + 2]; e += blockDim.x) {
      const int q = qubits[row + e];
      if (q < ps.q_lo || q >= ps.q_hi) continue;
      const int l = ps.lb_first + q - ps.q_lo, control = controls[row + e];
      type_s[l] = control >= 0 ? kGateCrot : kGateRot;
      ctrl_s[l] = max(control, 0);
      const float* a = angles + ((long long)p * n_layers * n_qubits + angle_index[row + e]) * 3;
      u3_s[l] = u3_entries(a[0], a[1], a[2]);
    }
  }
};

// Every state from |0...0> through its list.  max_count (the largest count)
// is only checked: each pass reads its individual's own boundaries.
cudaError_t run_compact(float* state, const ListSource& c, int pop, int max_count,
                        cudaStream_t stream) {
  if (max_count < 0 || max_count > c.max_gates) return cudaErrorInvalidValue;
  return run_slots(state, nullptr, pop, c, stream);
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
  const cudaStream_t s = (cudaStream_t)stream;
  const ListSource c{qubits, controls, angle_index, boundaries, angles,
                     max_gates, n_layers, n_qubits};
  cudaError_t err = run_compact(work, c, pop, max_count, s);
  if (err != cudaSuccess) return (int)err;
  reduce_energies(work, table, partial, out, pop, 1LL << n_qubits, s);
  return (int)cudaGetLastError();
}

// Replaces compact_probs (queasars_tpu/sim/compact_kernels.py:353):
// probs [P, 2^n].  work [P, 2, 2^n] is scratch.
int qt_compact_probs(float* probs, float* work, const int* qubits, const int* controls,
                     const int* angle_index, const int* boundaries, const float* angles,
                     int pop, int max_gates, int max_count, int n_layers, int n_qubits,
                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const ListSource c{qubits, controls, angle_index, boundaries, angles,
                     max_gates, n_layers, n_qubits};
  cudaError_t err = run_compact(work, c, pop, max_count, s);
  if (err != cudaSuccess) return (int)err;
  write_probabilities(work, probs, pop, 1LL << n_qubits, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
