// Commitment-cost sweep for Hopper (sm_90a), CUDA C++ with a plain C entry
// point for ctypes.
//
//   over [p, g] = sum_t w[p,t] * max(f[p,t] - cs[p,g], 0)
//   under[p, g] = sum_t w[p,t] * max(cs[p,g] - f[p,t], 0)
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/commitment_sweep/commitment_sweep.py::commitment_sweep_kernel
// (body _sweep_kernel), which carries the T sum across its sequential grid
// axis in VMEM.  Hopper's blocks run in no order, so the T loop moves inside
// the block.
//
// Bound: FP32 work on the CUDA cores, about 6 flops per (row, candidate,
// hour) triple (sub, two max, two fma), against reading f and w once.  At
// the planner's shape (8192 rows x 128 candidates x 1344 hours) that is
// ~8.5 GFLOP against ~88 MB, so the kernel is bound by operations, not
// bytes: the design spends its effort on keeping the inner loop to FP
// instructions and one shared-memory read per four hours.
//
// Design: one block per (kRows rows x kCands candidates) tile, one thread
// per candidate.  The block stages kChunk hours of its rows' f and w in
// shared memory with coalesced loads; every thread then walks those hours
// for each of its rows, reading them as float4 broadcasts and keeping the
// over/under sums in registers.  Ragged P, G and T edges are masked here,
// so the caller pads nothing.
//
// Sum order: every output's T sum is fixed by T alone, whatever the row
// tile it lands in: per kChunk-hour chunk, four lane sums (hours 4i+l,
// increasing i, one fmaf each; the chunk's last n % 4 hours go to lane 0)
// combined as (l0 + l1) + (l2 + l3), and the chunk sums added in chunk
// order.  A batched launch therefore equals a launch per row block bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kCands = 128;  // candidates per block = threads per block
constexpr int kRows = 8;     // rows per block
constexpr int kChunk = 256;  // hours staged in shared memory per step

__device__ __forceinline__ void accumulate(float fv, float wv, float c,
                                           float& o, float& u) {
  const float d = fv - c;
  o = fmaf(wv, fmaxf(d, 0.0f), o);
  u = fmaf(wv, fmaxf(-d, 0.0f), u);
}

__global__ void __launch_bounds__(kCands)
sweep_kernel(const float* __restrict__ f, const float* __restrict__ w,
             const float* __restrict__ cs, float* __restrict__ over,
             float* __restrict__ under, int P, int G, int T) {
  __shared__ __align__(16) float fs[kRows][kChunk];
  __shared__ __align__(16) float ws[kRows][kChunk];

  const int g = blockIdx.y * kCands + threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * kRows;
  const bool g_ok = g < G;

  float c[kRows], o[kRows], u[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long p = p0 + r;
    c[r] = (g_ok && p < P) ? cs[p * G + g] : 0.0f;
    o[r] = 0.0f;
    u[r] = 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    for (int i = threadIdx.x; i < kRows * kChunk; i += kCands) {
      const int r = i / kChunk;
      const int j = i - r * kChunk;
      const long long p = p0 + r;
      const bool ok = p < P && j < n;
      const long long at = p * T + t0 + j;
      fs[r][j] = ok ? f[at] : 0.0f;
      ws[r][j] = ok ? w[at] : 0.0f;
    }
    __syncthreads();

    const int n4 = n >> 2;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float cr = c[r];
      // Four partial sums per output, one per float4 lane: four
      // independent fma chains, and each chains only a quarter of the
      // chunk's hours, which keeps the float32 rounding error small.
      float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, o3 = 0.0f;
      float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f, u3 = 0.0f;
      const float4* f4 = reinterpret_cast<const float4*>(fs[r]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[r]);
      for (int j = 0; j < n4; ++j) {
        const float4 fv = f4[j];
        const float4 wv = w4[j];
        accumulate(fv.x, wv.x, cr, o0, u0);
        accumulate(fv.y, wv.y, cr, o1, u1);
        accumulate(fv.z, wv.z, cr, o2, u2);
        accumulate(fv.w, wv.w, cr, o3, u3);
      }
      for (int j = n4 << 2; j < n; ++j) {
        accumulate(fs[r][j], ws[r][j], cr, o0, u0);
      }
      o[r] += (o0 + o1) + (o2 + o3);
      u[r] += (u0 + u1) + (u2 + u3);
    }
    __syncthreads();
  }

  if (!g_ok) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long p = p0 + r;
    if (p < P) {
      over[p * G + g] = o[r];
      under[p * G + g] = u[r];
    }
  }
}

}  // namespace

// f, w: (P, T) and cs: (P, G) contiguous float32 on the current device;
// over, under: (P, G) float32 outputs.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int commitment_sweep_launch(const float* f, const float* w,
                                       const float* cs, float* over,
                                       float* under, int P, int G, int T,
                                       void* stream) {
  if (P <= 0 || G <= 0 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((P + kRows - 1) / kRows, (G + kCands - 1) / kCands);
  sweep_kernel<<<grid, kCands, 0, static_cast<cudaStream_t>(stream)>>>(
      f, w, cs, over, under, P, G, T);
  return static_cast<int>(cudaGetLastError());
}
