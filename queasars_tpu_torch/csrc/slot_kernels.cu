// Slot-circuit kernels for Hopper (sm_90a) behind a plain C interface.
//
// Counterparts of the five slot kernels of queasars_tpu/sim/pallas_kernels.py
// (pallas_energies_exact, pallas_population_states, pallas_nft_layer_sweep,
// pallas_population_probs, pallas_sampled_shot_energies).  Built with the
// fold and compacted-gate kernels into one shared library and bound with
// ctypes (queasars_tpu_torch/utils/cuda_lib.py); every entry point
// takes raw device pointers plus the caller's stream, launches on that stream,
// never synchronises, allocates nothing and returns cudaGetLastError().
//
// Layout: a state is two float32 planes [2, 2^n] (re, im); a population of P
// states is [P, 2, 2^n].  Basis index i holds qubit q in bit q (qiskit
// little-endian).  Gate codes: 0 ID, 1 U3, 2 control half, 3 CU3.
//
// Design.  A TPU program keeps one whole state in VMEM for the whole circuit.
// Here the states live in device memory and the slot circuit engine of
// slot_engine.cuh (run_slots; its header gives the tile passes, rounds,
// skips and bound) applies the slots in the plain version's order (layer,
// then q ascending; sim/statevector.py::simulate_circuits).  Its gate source
// here is SlotSource: every (layer, qubit) slot of the [P, L, n] genome, a
// pass skipping ID and control-half slots and masked layers.  The
// compacted-gate kernels run the same engine on their gate lists.
//   * energy: sum (re^2 + im^2) * table as a deterministic two-pass reduction
//     (fixed-order per-block partials, then one block per individual; no float
//     atomics), so equal inputs give equal bits from run to run -- an EVQE
//     trajectory branches on energy order.
//   * NFT sweep (sweep.cuh's step, shared with the fold sweep): BASE, the
//     swept layer without the probed qubit's gate applied to the prefix,
//     comes from this engine on P individuals on rebuild steps (the first,
//     then every reset_interval), with that slot turned off; between
//     rebuilds one fused pass per transition redoes the last probed gate,
//     undoes the next and writes the nine pair sums, and one thread per
//     individual takes z1, z3 and the 3-point update from the sums.
//   * sampled shots: the circuit as above, then the hierarchical inverse-CDF
//     epilogue of sampler.cuh on the planes in device memory.

#include <cuda_runtime.h>

#include "common.cuh"
#include "sampler.cuh"
#include "slot_engine.cuh"
#include "sweep.cuh"

namespace {

// The engine's gate source over every slot of a [P, L, n] genome.
struct SlotSource {
  const int* gate_types;            // [P, n_layers, n_qubits]
  const int* controls;              // [P, n_layers, n_qubits]
  const float* angles;              // [P, n_layers, n_qubits, 3]
  const unsigned char* layer_mask;  // [P, n_layers]; null = all on
  int n_layers;
  int n_qubits;

  // True when slot q of layer k of genome p applies a gate (U3 or CU3 in a
  // layer that is on).
  __device__ __forceinline__ bool on(int p, int k, int q) const {
    if (k >= n_layers) return false;
    if (layer_mask != nullptr && !layer_mask[p * n_layers + k]) return false;
    const int type = gate_types[((long long)p * n_layers + k) * n_qubits + q];
    return type == kGateRot || type == kGateCrot;
  }

  // Every slot of layers [0, k_end) (slot_engine.cuh's scan contract).
  __device__ __forceinline__ void scan(int p, const SlotPass& ps, int k_begin, int k_end,
                                       int& earlier, int& work) const {
    const int n = n_qubits;
    for (int e = threadIdx.x; e < min(k_end, n_layers) * n; e += blockDim.x) {
      const int k = e / n, q = e - k * n;
      if (!on(p, k, q)) continue;
      const int w = window_of(n, q);
      if (k < k_begin || (k == k_begin && w < ps.window)) earlier = 1;
      if (k >= k_begin && w == ps.window) work = 1;
    }
  }

  // Slot q of layer k on local bit lb_first + q - q_lo (the fill contract).
  __device__ __forceinline__ void fill(int p, int k, const SlotPass& ps, int* type_s,
                                       int* ctrl_s, U3* u3_s) const {
    const int lb_last = ps.lb_first + ps.q_hi - ps.q_lo;
    for (int l = ps.lb_first + threadIdx.x; l < lb_last; l += blockDim.x) {
      const int q = ps.q_lo + l - ps.lb_first;
      const long long slot = ((long long)p * n_layers + k) * n_qubits + q;
      const bool gated = on(p, k, q);
      type_s[l] = gated ? gate_types[slot] : 0;
      if (gated) {
        ctrl_s[l] = max(controls[slot], 0);
        const float* a = angles + slot * 3;
        u3_s[l] = u3_entries(a[0], a[1], a[2]);
      }
    }
  }
};

SlotSource make_genome(const int* gate_types, const int* controls, const float* angles,
                   const unsigned char* layer_mask, int n_layers, int n_qubits) {
  return SlotSource{gate_types, controls, angles, layer_mask, n_layers, n_qubits};
}

// The swept layer's gate types with each individual's probed slot off
// (the rebuild's REST): rest[p, q] = 0 where q == probe[p].
__global__ void rest_gates(int* rest, const int* gate_types, const int* probe, int pop, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pop * n) return;
  rest[e] = e % n == probe[e / n] ? 0 : gate_types[e];
}

}  // namespace

extern "C" {

// Partials buffer length the energy reduction needs per individual.
int qt_energy_partials(int n_qubits) {
  const long long dim = 1LL << n_qubits;
  return (int)(dim / reduce_chunk(dim));
}

// Replaces pallas_population_states (pallas_kernels.py:326): out [P, 2, 2^n].
int qt_population_states(float* out, const float* initial, const int* gate_types,
                         const int* controls, const float* angles,
                         const unsigned char* layer_mask, int pop, int n_layers, int n_qubits,
                         void* stream) {
  const SlotSource g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(out, initial, pop, g, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Replaces pallas_energies_exact (pallas_kernels.py:367): out [P].
// work [P, 2, 2^n] and partial [P, qt_energy_partials(n)] are scratch.
int qt_energies_exact(float* out, float* work, float* partial, const float* initial,
                      const int* gate_types, const int* controls, const float* angles,
                      const unsigned char* layer_mask, const float* table, int pop,
                      int n_layers, int n_qubits, void* stream) {
  const long long dim = 1LL << n_qubits;
  const cudaStream_t s = (cudaStream_t)stream;
  const SlotSource g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(work, initial, pop, g, s);
  if (err != cudaSuccess) return (int)err;
  reduce_energies(work, table, partial, out, pop, dim, s);
  return (int)cudaGetLastError();
}

// Replaces pallas_population_probs (pallas_kernels.py:267): probs [P, 2^n].
int qt_population_probs(float* probs, float* work, const float* initial, const int* gate_types,
                        const int* controls, const float* angles,
                        const unsigned char* layer_mask, int pop, int n_layers, int n_qubits,
                        void* stream) {
  const long long dim = 1LL << n_qubits;
  const cudaStream_t s = (cudaStream_t)stream;
  const SlotSource g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(work, initial, pop, g, s);
  if (err != cudaSuccess) return (int)err;
  write_probabilities(work, probs, pop, dim, s);
  return (int)cudaGetLastError();
}

// Pair-sum partials per individual and sum of the NFT sweeps'
// (qt_nft_layer_sweep, qt_fold_nft_sweep) passes.
int qt_sweep_partials(int n_qubits) { return sweep_blocks(n_qubits); }

// Replaces pallas_nft_layer_sweep (pallas_kernels.py:837).
// Inputs: the swept layer gate_types/controls [P, n], start angles [P, n, 3],
// coords [P, K, 2] (qubit, angle), n_free [P], active [P], prefix states
// [P, 2, 2^n], table [2^n], and transitions, a HOST array of maxiter flags
// (1 where some individual with active && n_free > 0 probes another qubit
// than at the step before).  Outputs: angles_out [P, n, 3], z [P].
// Scratch: base [P, 2, 2^n], partial [P, 9, qt_sweep_partials(n)],
// sums [P, 9], probe [P] int32, rest [P, n] int32.
int qt_nft_layer_sweep(float* angles_out, float* z, float* base, float* partial, float* sums,
                       int* probe, int* rest, const unsigned char* transitions,
                       const int* gate_types, const int* controls, const float* angles,
                       const int* coords, const int* n_free, const unsigned char* active,
                       const float* prefix, const float* table, int pop, int n_qubits, int k_max,
                       int maxiter, int reset_interval, void* stream) {
  if (n_qubits < 1 || n_qubits > kMaxQubits) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(angles_out, angles, (size_t)pop * n_qubits * 3 * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const SweepArgs w{angles_out, z, base, partial, sums, probe, gate_types, controls, coords,
                    n_free, active, table, pop, n_qubits, k_max};
  const SlotSource layer = make_genome(rest, controls, angles_out, nullptr, 1, n_qubits);
  const auto rebuild = [&]() {
    rest_gates<<<blocks_for((long long)pop * n_qubits, 128), 128, 0, s>>>(rest, gate_types, probe,
                                                                           pop, n_qubits);
    return run_slots(base, prefix, pop, layer, s);
  };
  err = run_sweep(w, transitions, maxiter, reset_interval, rebuild, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Floats of sampler scratch per individual (qt_sampled_shot_indices,
// qt_sampled_shot_indices_folded, qt_sample_planes).
int qt_sampler_scratch(int n_qubits) { return (int)sampler_scratch_floats(n_qubits); }

// Replaces pallas_sampled_shot_energies (pallas_kernels.py:660) up to its
// energy gather: sampled indices out [P, S] at the uniforms u_frac [P, S],
// after each genome's circuit from |0...0> or initial [P, 2, 2^n] (null =
// |0...0>); 14 <= n <= 20.  work [P, 2, 2^n] and scratch
// [P, qt_sampler_scratch(n)] are scratch.
int qt_sampled_shot_indices(int* out, float* work, float* scratch, const float* u_frac,
                            const float* initial, const int* gate_types, const int* controls,
                            const float* angles, const unsigned char* layer_mask, int pop,
                            int n_layers, int n_qubits, int shots, void* stream) {
  if (n_qubits < 14 || n_qubits > 20) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const SlotSource g = make_genome(gate_types, controls, angles, layer_mask, n_layers, n_qubits);
  cudaError_t err = run_slots(work, initial, pop, g, s);
  if (err != cudaSuccess) return (int)err;
  err = sample_planes(work, u_frac, scratch, out, pop, n_qubits, shots, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The sampler epilogue alone: sampled indices out [P, S] of the state planes
// [P, 2, 2^n] at u_frac [P, S]; 14 <= n <= 21.
int qt_sample_planes(int* out, float* scratch, const float* u_frac, const float* planes, int pop,
                     int n_qubits, int shots, void* stream) {
  return (int)sample_planes(planes, u_frac, scratch, out, pop, n_qubits, shots,
                            (cudaStream_t)stream);
}

}  // extern "C"
