// Generation turnover pass for Hopper (sm_90a), CUDA C++ with a plain C entry
// point for ctypes.
//
// For base demand b (P, T) float32 and every (pool p, hour t):
//
//   m_g(t)   = sigmoid(rate_g * (t - mid_g))          explicit exp form
//   eff(t)   = exp(neg_sw * t)                        neg_sw = -sw_log
//   col      = b[p,t] - b[p,t] * m_g(t)                    p is src of g
//            = b[p,t] + (b[src_g,t] * m_g(t)) * inv_gain_g p is dst of g
//            = b[p,t]                                      otherwise
//   out[p,t] = col * eff(t)
//
// Takes the place of the compiled lax.scan over hours in
// src/repro/capacity/generations.py::migrate_demand (the scan at line 275,
// its step _mig_step at line 251), which is not a Pallas kernel.  The scan
// carries the migrated share m into hour t as sigmoid(rate * ((t-1) + 1 -
// mid)), its closed form; (t-1) + 1 is t exactly in float32 below 2^24
// hours, so no hour depends on another and the pass is one elementwise
// kernel, not a walk.
//
// Units: the wrapper hands over a (U, 2) table of row pairs and a (U,) edge
// index, one unit per edge (its source row, its successor row) and one per
// pool on no edge (its row, -1).  The successor table's validation lets a
// pool be the source of at most one edge or the successor of at most one,
// never both, so the units cover every pool exactly once: no two threads
// write one element, no atomics are needed, and a pair's thread reads the
// source row once for both of its outputs.
//
// Layout: blockIdx.y walks units, x-threads walk hours, so every block has
// one unit's kind (no divergence) and a warp's loads and stores of each row
// are 128 contiguous bytes.
//
// Bound: bytes.  Every row is read once and written once, 2 P T * 4 bytes,
// about 0.215 GB at 1024 pools x 26,280 hours.  Two expf and a divide per
// pair-hour are far below the card's operation rate.
//
// Numerics: every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc fuses no
// multiply-add, and expf is the precise libdevice function PyTorch's exp
// calls on the card: the kernel equals the plain version (ref.py) bit for
// bit there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxUnitBlocks = 65535;  // gridDim.y limit

__device__ __forceinline__ float sigmoid(float x) {
  const float e = expf(-fabsf(x));
  const float d = __fadd_rn(1.0f, e);
  return x >= 0.0f ? __fdiv_rn(1.0f, d) : __fdiv_rn(e, d);
}

__global__ void __launch_bounds__(kThreads)
    generation_turnover_kernel(const float* __restrict__ base,
                               const int* __restrict__ unit_rows,
                               const int* __restrict__ unit_edge,
                               const float* __restrict__ inv_gain,
                               const float* __restrict__ midpoint,
                               const float* __restrict__ rate,
                               float neg_sw, float* __restrict__ out,
                               int units, int hours) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= hours) return;
  const float tf = static_cast<float>(t);
  const float eff = expf(__fmul_rn(neg_sw, tf));
  for (int u = blockIdx.y; u < units; u += gridDim.y) {
    const size_t a = static_cast<size_t>(unit_rows[2 * u]) * hours + t;
    const float ba = base[a];
    const int g = unit_edge[u];
    if (g < 0) {
      out[a] = __fmul_rn(ba, eff);
      continue;
    }
    const size_t d = static_cast<size_t>(unit_rows[2 * u + 1]) * hours + t;
    const float bd = base[d];
    const float m = sigmoid(__fmul_rn(rate[g], __fsub_rn(tf, midpoint[g])));
    const float moved = __fmul_rn(ba, m);
    out[a] = __fmul_rn(__fsub_rn(ba, moved), eff);
    out[d] = __fmul_rn(__fadd_rn(bd, __fmul_rn(moved, inv_gain[g])), eff);
  }
}

}  // namespace

extern "C" int generation_turnover_launch(
    const float* base, const int* unit_rows, const int* unit_edge,
    const float* inv_gain, const float* midpoint, const float* rate,
    float neg_sw, float* out, int units, int hours, cudaStream_t stream) {
  if (units <= 0 || hours <= 0) return 0;
  const dim3 grid((hours + kThreads - 1) / kThreads,
                  units < kMaxUnitBlocks ? units : kMaxUnitBlocks);
  generation_turnover_kernel<<<grid, kThreads, 0, stream>>>(
      base, unit_rows, unit_edge, inv_gain, midpoint, rate, neg_sw, out,
      units, hours);
  return static_cast<int>(cudaGetLastError());
}
