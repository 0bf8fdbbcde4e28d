// Slot-circuit kernels for Hopper (sm_90a) behind a plain C interface.
//
// Counterparts of the four slot kernels of queasars_tpu/sim/pallas_kernels.py
// (pallas_energies_exact, pallas_population_states, pallas_nft_layer_sweep,
// pallas_population_probs).  Built by one nvcc call into a shared library and
// bound with ctypes (queasars_tpu_torch/utils/cuda_lib.py); every entry point
// takes raw device pointers plus the caller's stream, launches on that stream,
// never synchronises, allocates nothing and returns cudaGetLastError().
//
// Layout: a state is two float32 planes [2, 2^n] (re, im); a population of P
// states is [P, 2, 2^n].  Basis index i holds qubit q in bit q (qiskit
// little-endian).  Gate codes: 0 ID, 1 U3, 2 control half, 3 CU3.
//
// Design.  A TPU program keeps one whole state in VMEM for the whole circuit.
// An H100 SM has at most 227 KB of shared memory against 8 MB of planes per
// state at n=20, so here the states live in device memory (50 MB of L2 behind
// it) and many blocks share each state:
//   * gate pass: one launch per (layer, slot) over the whole population; a
//     thread owns one amplitude pair (i, i | 2^q) with bit q of i clear.  Each
//     block reads its individual's gate type, control, angles and layer-mask
//     bit from device memory, so the host never branches on genome values.
//     ID/CTRL slots and masked layers return at once.  Bound: device-memory
//     bytes (16 B read + 16 B written per pair and active slot).  Fusing runs
//     of low-qubit slots into shared-memory tiles is left for later work.
//   * energy: sum (re^2 + im^2) * table as a deterministic two-pass reduction
//     (fixed-order per-block partials, then one block per individual; no float
//     atomics), so equal inputs give equal bits from run to run -- an EVQE
//     trajectory branches on energy order.
//   * NFT sweep: the step loop runs on the host side of this library and only
//     enqueues launches (no synchronisation): per step both probe states
//     (+pi/2 and -pi/2) are batched as 2P copies of the prefix, the layer is
//     applied, both energies are reduced, and one thread per individual runs
//     the 3-point update with atan2f.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kGateRot = 1;
constexpr int kGateCrot = 3;
constexpr float kHalfPi = 1.57079632679489662f;
constexpr float kPi = 3.14159265358979324f;

struct Genome {
  const int* gate_types;            // [genome_pop, n_layers, n_qubits]
  const int* controls;              // [genome_pop, n_layers, n_qubits]
  const float* angles;              // [angle_pop, n_layers, n_qubits, 3]
  const unsigned char* layer_mask;  // [genome_pop, n_layers]; null = all on
  int genome_pop;                   // state p uses genome p % genome_pop
  int angle_pop;                    // state p uses angles p % angle_pop
  int n_layers;
  int n_qubits;
};

// Semantics of _apply_u3_slot (pallas_kernels.py:55-115) with the U3 entries
// of _u3_entries (:44-52).
__global__ void apply_slot(float* state, Genome g, int layer, int q, long long dim) {
  const int p = blockIdx.y;
  const int gi = p % g.genome_pop;
  if (g.layer_mask != nullptr && !g.layer_mask[gi * g.n_layers + layer]) return;
  const long long slot = ((long long)gi * g.n_layers + layer) * g.n_qubits + q;
  const int type = g.gate_types[slot];
  if (type != kGateRot && type != kGateCrot) return;
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= dim / 2) return;
  const long long i0 = ((j >> q) << (q + 1)) | (j & ((1LL << q) - 1));
  const long long i1 = i0 | (1LL << q);
  if (type == kGateCrot) {
    const int c = max(g.controls[slot], 0);
    if (((i0 >> c) & 1) == 0) return;
  }
  const int ai = p % g.angle_pop;
  const float* a = g.angles + (((long long)ai * g.n_layers + layer) * g.n_qubits + q) * 3;
  const float theta = a[0], phi = a[1], lam = a[2];
  float sin_t, cos_t, sin_l, cos_l, sin_p, cos_p, sin_pl, cos_pl;
  sincosf(theta * 0.5f, &sin_t, &cos_t);
  sincosf(lam, &sin_l, &cos_l);
  sincosf(phi, &sin_p, &cos_p);
  sincosf(phi + lam, &sin_pl, &cos_pl);
  const float u00r = cos_t, u00i = 0.0f;
  const float u01r = -cos_l * sin_t, u01i = -sin_l * sin_t;
  const float u10r = cos_p * sin_t, u10i = sin_p * sin_t;
  const float u11r = cos_pl * cos_t, u11i = sin_pl * cos_t;

  float* re = state + (long long)p * 2 * dim;
  float* im = re + dim;
  const float r0 = re[i0], m0 = im[i0], r1 = re[i1], m1 = im[i1];
  re[i0] = u00r * r0 - u00i * m0 + u01r * r1 - u01i * m1;
  im[i0] = u00r * m0 + u00i * r0 + u01r * m1 + u01i * r1;
  re[i1] = u11r * r1 - u11i * m1 + u10r * r0 - u10i * m0;
  im[i1] = u11r * m1 + u11i * r1 + u10r * m0 + u10i * r0;
}

// Probe angles of NFT step k: rows [0, P) shift the probed coordinate by
// +pi/2, rows [P, 2P) by -pi/2 (the z1 and z3 probes of the TPU kernel).
__global__ void sweep_probe_angles(const float* current, const int* coords, const int* n_free,
                                   int k, int pop, int n_qubits, int k_max, float* probe) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pop) return;
  const int width = n_qubits * 3;
  for (int e = 0; e < width; ++e) {
    const float v = current[p * width + e];
    probe[p * width + e] = v;
    probe[(pop + p) * width + e] = v;
  }
  const int idx = k % max(n_free[p], 1);
  const int q = coords[(p * k_max + idx) * 2];
  const int a = coords[(p * k_max + idx) * 2 + 1];
  const float theta = current[p * width + q * 3 + a];
  probe[p * width + q * 3 + a] = theta + kHalfPi;
  probe[(pop + p) * width + q * 3 + a] = theta - kHalfPi;
}

// The 3-point sinusoid update of _nft_layer_sweep_kernel (pallas_kernels.py:
// 809-818), with atan2f in place of the polynomial _kernel_atan2.
__global__ void sweep_update(float* current, float* z, const float* z13, const int* coords,
                             const int* n_free, const unsigned char* active, int k, int pop,
                             int n_qubits, int k_max) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pop) return;
  const int nf = n_free[p];
  if (!(active[p] && nf > 0)) return;
  const int idx = k % max(nf, 1);
  const int q = coords[(p * k_max + idx) * 2];
  const int a = coords[(p * k_max + idx) * 2 + 1];
  float* slot = current + (p * n_qubits + q) * 3 + a;
  const float theta = *slot;
  const float z0 = z[p], z1 = z13[p], z3 = z13[pop + p];
  const float mid = (z1 + z3) * 0.5f;
  const float half_diff = (z1 - z3) * 0.5f;
  const float d = z0 - mid;
  const float shift = atan2f(half_diff, d);
  *slot = theta + shift + kPi;
  z[p] = mid - sqrtf(d * d + half_diff * half_diff);
}

// Start every state from |0...0>, or state p from initial[p % init_pop],
// then apply every (layer, slot) of the genome.
cudaError_t run_circuit(float* state, const float* initial, int init_pop, int pop,
                        const Genome& g, long long dim, cudaStream_t stream) {
  if (initial == nullptr) {
    init_zero_state<<<dim3(blocks_for(dim, kPairThreads), pop), kPairThreads, 0, stream>>>(state, dim);
  } else {
    const size_t bytes = (size_t)init_pop * 2 * dim * sizeof(float);
    for (int p = 0; p < pop; p += init_pop) {
      cudaError_t err = cudaMemcpyAsync(state + (long long)p * 2 * dim, initial, bytes,
                                        cudaMemcpyDeviceToDevice, stream);
      if (err != cudaSuccess) return err;
    }
  }
  const dim3 grid(blocks_for(dim / 2, kPairThreads), pop);
  for (int layer = 0; layer < g.n_layers; ++layer) {
    for (int q = 0; q < g.n_qubits; ++q) {
      apply_slot<<<grid, kPairThreads, 0, stream>>>(state, g, layer, q, dim);
    }
  }
  return cudaGetLastError();
}

Genome make_genome(const int* gate_types, const int* controls, const float* angles,
                   const unsigned char* layer_mask, int pop, int n_layers, int n_qubits) {
  return Genome{gate_types, controls, angles, layer_mask, pop, pop, n_layers, n_qubits};
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
  const Genome g = make_genome(gate_types, controls, angles, layer_mask, pop, n_layers, n_qubits);
  cudaError_t err = run_circuit(out, initial, pop, pop, g, 1LL << n_qubits, (cudaStream_t)stream);
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
  const Genome g = make_genome(gate_types, controls, angles, layer_mask, pop, n_layers, n_qubits);
  cudaError_t err = run_circuit(work, initial, pop, pop, g, dim, s);
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
  const Genome g = make_genome(gate_types, controls, angles, layer_mask, pop, n_layers, n_qubits);
  cudaError_t err = run_circuit(work, initial, pop, pop, g, dim, s);
  if (err != cudaSuccess) return (int)err;
  write_probabilities(work, probs, pop, dim, s);
  return (int)cudaGetLastError();
}

// Replaces pallas_nft_layer_sweep (pallas_kernels.py:837).
// Inputs: the swept layer gate_types/controls [P, n], start angles [P, n, 3],
// coords [P, K, 2] (qubit, angle), n_free [P], active [P], prefix states
// [P, 2, 2^n], table [2^n].  Outputs: angles_out [P, n, 3], z [P].
// Scratch: probe [2P, n, 3], work [2P, 2, 2^n], partial [2P, partials], z13 [2P].
int qt_nft_layer_sweep(float* angles_out, float* z, float* probe, float* work, float* partial,
                       float* z13, const int* gate_types, const int* controls,
                       const float* angles, const int* coords, const int* n_free,
                       const unsigned char* active, const float* prefix, const float* table,
                       int pop, int n_qubits, int k_max, int maxiter, int reset_interval,
                       void* stream) {
  const long long dim = 1LL << n_qubits;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(angles_out, angles, (size_t)pop * n_qubits * 3 * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const Genome current = make_genome(gate_types, controls, angles_out, nullptr, pop, 1, n_qubits);
  Genome probes = current;
  probes.angles = probe;
  probes.angle_pop = 2 * pop;
  const unsigned int small = blocks_for(pop, 128);

  err = run_circuit(work, prefix, pop, pop, current, dim, s);
  if (err != cudaSuccess) return (int)err;
  reduce_energies(work, table, partial, z, pop, dim, s);
  for (int k = 0; k < maxiter; ++k) {
    if (k > 0 && k % reset_interval == 0) {
      err = run_circuit(work, prefix, pop, pop, current, dim, s);
      if (err != cudaSuccess) return (int)err;
      reduce_energies(work, table, partial, z, pop, dim, s);
    }
    sweep_probe_angles<<<small, 128, 0, s>>>(angles_out, coords, n_free, k, pop, n_qubits, k_max, probe);
    err = run_circuit(work, prefix, pop, 2 * pop, probes, dim, s);
    if (err != cudaSuccess) return (int)err;
    reduce_energies(work, table, partial, z13, 2 * pop, dim, s);
    sweep_update<<<small, 128, 0, s>>>(angles_out, z, z13, coords, n_free, active, k, pop,
                                        n_qubits, k_max);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
