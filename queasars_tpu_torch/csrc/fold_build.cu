// The kron-fold pipeline of a genome batch built on the card in one launch,
// for Hopper (sm_90a) behind a plain C interface.
//
// sim/fold_pipeline.py::build_fold_pipeline turns [P, L, n] genomes into the
// ten FoldPipeline tensors that the fold kernels (rows 6-11) read: per kron
// layer k = 0..L the per-qubit 2x2 factors K[k] = Vdag[k] . main[k-1] (the
// identity past either end), their per-axis-group activity, and per circuit
// layer the controlled-diagonal phases compacted to the front of D = max(n/2,
// 1) slots (those absorbed into their kron layer apart).  As PyTorch
// operations (build_fold_pipeline_plain) that is about 207 launches and two
// blocking copies of constants a call, and on the fold route the host's time
// to issue them sets the pace of the parameter search.  qt_fold_build does it
// in one launch.  It replaces no TPU kernel: the JAX package leaves the same
// algebra to XLA (queasars_tpu/sim/fold_pipeline.py::build_fold_pipeline).
//
// One warp per (individual, kron layer), lane q on qubit q (n <= 32), four
// warps a block.  A lane computes slot (k, q)'s Vdag and CDiag phases and slot
// (k-1, q)'s main factor (so each slot's factors are computed by two warps,
// in registers), multiplies them and writes its factor; a ballot of the
// lanes' activity gives the kron layer's group activity.  Kron layer k's
// activity is all that absorbing layer k's phases needs, so the same warp
// then flags layer k's CU3s, applies the absorb rule, and compacts both slot
// lists with a ballot and the popcount of the lanes below: flagged qubits in
// qubit order, the order argsort(stable=True) gives.  No shared memory, no
// barrier.  Bound by launch latency: its bytes (158 KB at P=16, L=6, n=20)
// take 0.05 us at 3.35 TB/s.
//
// Bits: every product and sum is rounded on its own (__fmul_rn, __fadd_rn;
// nvcc would contract a*b+c into an FMA), and sinf, cosf, sqrtf and atan2f
// (no fast math) are the functions torch.sin, torch.cos, torch.sqrt and
// torch.atan2 compute on the card, in the PyTorch build's order.  The 2x2
// products follow a float32 GEMM's accumulation (an FMA per term, k = 0
// first), as the PyTorch build's batched `@` computes them.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBuildWarps = 4;
constexpr int kLaneBits = 7;  // fold_pipeline.LANE_BITS: axis groups of 7 qubits
constexpr unsigned kFull = 0xffffffffu;

// One slot's factors as slot_factors (sim/fold_pipeline.py) gives them:
// main and vdag complex 2x2 (row-major re and im), ph the CDiag phases
// (target bit 0 re, im, target bit 1 re, im).
struct Slot {
  float main_re[4], main_im[4], vdag_re[4], vdag_im[4], ph[4];
};

__device__ __forceinline__ void identity(float* re, float* im) {
  re[0] = 1.0f; re[1] = 0.0f; re[2] = 0.0f; re[3] = 1.0f;
  im[0] = 0.0f; im[1] = 0.0f; im[2] = 0.0f; im[3] = 0.0f;
}

// slot_factors of one slot of (masked) gate type `type` and angles `a`
// (theta, phi, lam; read only for ROT and CROT): U3 for ROT, the CU3's
// eigendecomposition U3 = V diag(e^{i ph0}, e^{i ph1}) V^dag for CROT, the
// identity otherwise.
__device__ Slot slot_factors(int type, const float* a) {
  Slot s;
  identity(s.main_re, s.main_im);
  identity(s.vdag_re, s.vdag_im);
  s.ph[0] = 1.0f; s.ph[1] = 0.0f; s.ph[2] = 1.0f; s.ph[3] = 0.0f;
  if (type == kGateRot) {
    const U3 u = u3_entries(a[0], a[1], a[2]);
    s.main_re[0] = u.u00r; s.main_re[1] = u.u01r; s.main_re[2] = u.u10r; s.main_re[3] = u.u11r;
    s.main_im[0] = u.u00i; s.main_im[1] = u.u01i; s.main_im[2] = u.u10i; s.main_im[3] = u.u11i;
  } else if (type == kGateCrot) {
    const float theta = a[0], phi = a[1], lam = a[2];
    const float sv = __fmul_rn(__fadd_rn(phi, lam), 0.5f);
    const float av = __fmul_rn(__fsub_rn(phi, lam), 0.5f);
    const float half = __fmul_rn(theta, 0.5f);
    const float cos_half = cosf(half), sin_half = sinf(half);
    const float cos_d2 = __fmul_rn(cos_half, cosf(sv));
    const float mz = __fmul_rn(cos_half, sinf(sv));
    const float my = __fmul_rn(sin_half, cosf(av));
    const float mx = __fmul_rn(-sin_half, sinf(av));
    const float xy_sq = __fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my));
    const bool xy_zero = xy_sq == 0.0f;
    const float nxy = xy_zero ? 0.0f : sqrtf(xy_sq);
    const float s_sq = __fadd_rn(__fmul_rn(nxy, nxy), __fmul_rn(mz, mz));
    const float sin_d2 = s_sq == 0.0f ? 0.0f : sqrtf(s_sq);
    const float d_half = atan2f(sin_d2, cos_d2);
    const float ph0 = __fsub_rn(sv, d_half), ph1 = __fadd_rn(sv, d_half);
    s.ph[0] = cosf(ph0); s.ph[1] = sinf(ph0); s.ph[2] = cosf(ph1); s.ph[3] = sinf(ph1);
    if (!(sin_d2 < 1e-7f)) {  // else V stays the identity (a degenerate CU3)
      const float mz_b = (xy_zero && mz == 0.0f) ? 1.0f : mz;
      const float b_half = __fmul_rn(atan2f(nxy, mz_b), 0.5f);
      const float c = atan2f(xy_zero ? 0.0f : my, xy_zero ? 1.0f : mx);
      const float cos_b = cosf(b_half), sin_b = sinf(b_half);
      const float sbc = __fmul_rn(sin_b, cosf(c)), sbs = __fmul_rn(sin_b, sinf(c));
      s.main_re[0] = cos_b; s.main_re[1] = -sbc; s.main_re[2] = sbc; s.main_re[3] = cos_b;
      s.main_im[1] = sbs; s.main_im[2] = sbs;
    }
    // vdag = V^dagger: the transpose of V's real part, minus its imaginary part's
    s.vdag_re[0] = s.main_re[0]; s.vdag_re[1] = s.main_re[2];
    s.vdag_re[2] = s.main_re[1]; s.vdag_re[3] = s.main_re[3];
    s.vdag_im[0] = -s.main_im[0]; s.vdag_im[1] = -s.main_im[2];
    s.vdag_im[2] = -s.main_im[1]; s.vdag_im[3] = -s.main_im[3];
  }
  return s;
}

// Entry (i, j) of the real 2x2 product a . b as a float32 GEMM accumulates it.
__device__ __forceinline__ float gemm_entry(const float* a, const float* b, int i, int j) {
  return __fmaf_rn(a[2 * i + 1], b[2 + j], __fmaf_rn(a[2 * i], b[j], 0.0f));
}

// The lanes of axis group g (lane q<7, row 7<=q<14, top q>=14; the last of
// the n_groups takes every qubit up to n).
__device__ __forceinline__ unsigned group_lanes(int g, int n_groups, int n_qubits) {
  const int lo = g * kLaneBits;
  const int hi = g == n_groups - 1 ? n_qubits : lo + kLaneBits;
  return (unsigned)(((1ull << hi) - 1ull) ^ ((1ull << lo) - 1ull));
}

struct Slots {
  int* ctrl;
  int* tgt;
  float* phase;
  int* count;
};

// Compacts one circuit layer's flagged lanes into `out`'s D slots at `row`
// (= p * L + layer): flagged qubits first, in qubit order; -1 and the (1, 0)
// phases in the unused slots; the count of flagged lanes (not capped at D).
__device__ __forceinline__ void compact(const Slots& out, long long row, int d_slots, bool flag,
                                        int lane, int control, const float* ph) {
  const unsigned flagged = __ballot_sync(kFull, flag);
  const int count = __popc(flagged);
  const int at = __popc(flagged & ((1u << lane) - 1u));
  const long long base = row * d_slots;
  if (flag && at < d_slots) {
    out.ctrl[base + at] = control;
    out.tgt[base + at] = lane;
    float* dst = out.phase + (base + at) * 4;
    dst[0] = ph[0]; dst[1] = ph[1]; dst[2] = ph[2]; dst[3] = ph[3];
  }
  if (lane >= count && lane < d_slots) {
    out.ctrl[base + lane] = -1;
    out.tgt[base + lane] = -1;
    float* dst = out.phase + (base + lane) * 4;
    dst[0] = 1.0f; dst[1] = 0.0f; dst[2] = 1.0f; dst[3] = 0.0f;
  }
  if (lane == 0) out.count[row] = count;
}

__global__ void fold_build(float* factors, int* group_active, Slots diag, Slots absorbed,
                           const int* gate_types, const int* controls, const float* angles,
                           const bool* layer_mask, int pop, int n_layers, int n_qubits,
                           int absorb_diag) {
  const int warp = blockIdx.x * kBuildWarps + threadIdx.x / 32;
  const int n_kron = n_layers + 1;
  if (warp >= pop * n_kron) return;  // whole warps only
  const int lane = threadIdx.x % 32;
  const int p = warp / n_kron, k = warp % n_kron;
  const bool on = lane < n_qubits;
  const long long row = (long long)p * n_layers;

  // layer k's slot (Vdag, phases) and layer k-1's (main) on this lane's qubit
  int type_k = 0, type_prev = 0;
  long long slot_k = 0, slot_prev = 0;
  if (on && k < n_layers) {
    slot_k = (row + k) * n_qubits + lane;
    type_k = layer_mask[row + k] ? gate_types[slot_k] : 0;
  }
  if (on && k > 0) {
    slot_prev = (row + k - 1) * n_qubits + lane;
    type_prev = layer_mask[row + k - 1] ? gate_types[slot_prev] : 0;
  }
  const Slot cur = slot_factors(type_k, angles + slot_k * 3);
  const Slot prev = slot_factors(type_prev, angles + slot_prev * 3);

  // K[k] = vdag[k] . main[k-1] (complex), and its distance from the identity
  bool active = false;
  if (on) {
    float* out = factors + (((long long)p * n_kron + k) * n_qubits + lane) * 8;
    bool nan = false;
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2, j = e % 2;
      const float re = __fsub_rn(gemm_entry(cur.vdag_re, prev.main_re, i, j),
                                 gemm_entry(cur.vdag_im, prev.main_im, i, j));
      const float im = __fadd_rn(gemm_entry(cur.vdag_re, prev.main_im, i, j),
                                 gemm_entry(cur.vdag_im, prev.main_re, i, j));
      out[e] = re;
      out[4 + e] = im;
      const float off = i == j ? __fsub_rn(re, 1.0f) : re;
      const float d = __fadd_rn(__fmul_rn(off, off), __fmul_rn(im, im));
      active = active || d > 1e-14f;
      nan = nan || d != d;
    }
    active = active && !nan;  // the PyTorch build's amax propagates a NaN
  }
  const unsigned act = __ballot_sync(kFull, active);
  const int n_groups = min((n_qubits + kLaneBits - 1) / kLaneBits, 3);
  if (lane < n_groups) {
    group_active[((long long)p * n_kron + k) * n_groups + lane] =
        (act & group_lanes(lane, n_groups, n_qubits)) != 0u;
  }
  if (k == n_layers) return;  // the last kron layer has no diagonal pass

  // layer k's CU3 phases: absorbed where control and target share an axis
  // group that kron layer k has active (the top group only up to n = 21)
  const bool crot = on && layer_mask[row + k] && gate_types[slot_k] == kGateCrot;
  const int control = crot ? controls[slot_k] : -1;
  const int g_t = min(lane / kLaneBits, 2);
  const int g_c = min(max(control, 0) / kLaneBits, 2);
  const bool absorb = absorb_diag && crot && g_t == g_c &&
                      (g_t < 2 || n_qubits <= 3 * kLaneBits) &&
                      (act & group_lanes(g_t, n_groups, n_qubits)) != 0u;
  const int d_slots = max(n_qubits / 2, 1);
  compact(diag, row + k, d_slots, crot && !absorb, lane, control, cur.ph);
  compact(absorbed, row + k, d_slots, absorb, lane, control, cur.ph);
}

}  // namespace

extern "C" {

// Outputs in FoldPipeline's field order and layouts (K = L + 1 kron layers,
// D = max(n / 2, 1) slots, G = min(ceil(n / 7), 3) axis groups): factors
// [P, K, n, 2, 2, 2] float32, diag_ctrl / diag_tgt [P, L, D] int32,
// diag_phase [P, L, D, 2, 2] float32, diag_count [P, L] int32, group_active
// [P, K, G] int32, then abs_ctrl, abs_tgt, abs_phase, abs_count as the diag_
// fields.  Inputs: gate_types, controls [P, L, n] int32, angles [P, L, n, 3]
// float32, layer_mask [P, L] bool.  1 <= n_qubits <= 32.
int qt_fold_build(void* factors, void* diag_ctrl, void* diag_tgt, void* diag_phase,
                  void* diag_count, void* group_active, void* abs_ctrl, void* abs_tgt,
                  void* abs_phase, void* abs_count, void* gate_types, void* controls,
                  void* angles, void* layer_mask, int pop, int n_layers, int n_qubits,
                  int absorb_diag, void* stream) {
  if (n_qubits < 1 || n_qubits > 32 || pop < 0 || n_layers < 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)pop * (n_layers + 1);
  if (warps > 0) {
    const Slots diag{(int*)diag_ctrl, (int*)diag_tgt, (float*)diag_phase, (int*)diag_count};
    const Slots absorbed{(int*)abs_ctrl, (int*)abs_tgt, (float*)abs_phase, (int*)abs_count};
    const int blocks = (int)((warps + kBuildWarps - 1) / kBuildWarps);
    fold_build<<<blocks, kBuildWarps * 32, 0, (cudaStream_t)stream>>>(
        (float*)factors, (int*)group_active, diag, absorbed, (const int*)gate_types,
        (const int*)controls, (const float*)angles, (const bool*)layer_mask, pop, n_layers,
        n_qubits, absorb_diag);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
