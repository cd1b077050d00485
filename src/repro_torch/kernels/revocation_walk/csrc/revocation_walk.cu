// Spot revocation walk for Hopper (sm_90a), CUDA C++ with a plain C entry
// point for ctypes.
//
// For every lane l = n * P + p (Monte-Carlo draw n, pool p) and hour t:
//
//   nxt         = avail > 0.5 ? (u >= hazard[p]) : (u < recovery[p])
//   interrupted = avail * (1 - nxt)
//   price       = clip(0.9 * price + (0.3 * band[p]) * z, -band[p], band[p])
//   available[t, l] = nxt, interrupted[t, l], price[t, l] = 1 + price
//
// starting from avail0[l] and price 0, with u = us[t, l], z = zs[t, l].
//
// Takes the place of the compiled lax.scan over hours in
// src/repro/capacity/preemption.py::revocation_walk (the scan of _step at
// line 190), which is not a Pallas kernel: on the TPU the scan is XLA's.
// The step is serial in t and independent across lanes, so one thread
// walks one lane through every hour, its state and price in registers.
//
// Bound: bytes.  The walk reads us and zs once and writes three outputs
// once: 20 bytes per (lane, hour) against ~12 operations, far below the
// card's ~20 operations per byte.  The arrays are hour-major (T, N, P), so
// a warp's 32 neighbouring lanes load and store 128 contiguous bytes per
// array per hour: every access is one coalesced transaction.  (Writing the
// reference's (N, P, T) layout from one thread per lane would stride by T.)
// The uniforms and normals do not depend on the state, so a thread issues
// the loads of kUnroll hours before it steps through them: with 32k lanes
// that keeps megabytes of loads in flight, enough to cover the memory's
// latency.  The loads and stores stream past L1 and L2 (__ldcs/__stcs):
// nothing is read twice.
//
// Numerics: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn), so nvcc fuses no multiply-add; the plain version (ref.py)
// takes the same float32 steps, and the two agree bit for bit.  The
// reference's compiled scan may contract the price update into an fma, so
// against it prices agree to ~1e-7, states bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;  // hours whose loads are issued together

struct Lane {
  float hazard, recovery, band, band3;  // band3 = 0.3 * band, rounded once
  float avail, price;
};

__device__ __forceinline__ void step(Lane& s, float u, float z, float* out_a,
                                     float* out_i, float* out_p) {
  const float nxt =
      s.avail > 0.5f ? (u >= s.hazard ? 1.0f : 0.0f)
                     : (u < s.recovery ? 1.0f : 0.0f);
  const float interrupted = __fmul_rn(s.avail, __fsub_rn(1.0f, nxt));
  const float walk = __fadd_rn(__fmul_rn(0.9f, s.price), __fmul_rn(s.band3, z));
  s.price = fminf(fmaxf(walk, -s.band), s.band);
  s.avail = nxt;
  __stcs(out_a, nxt);
  __stcs(out_i, interrupted);
  __stcs(out_p, __fadd_rn(1.0f, s.price));
}

__global__ void __launch_bounds__(kThreads)
    revocation_walk_kernel(const float* __restrict__ hazard,
                           const float* __restrict__ recovery,
                           const float* __restrict__ band,
                           const float* __restrict__ avail0,
                           const float* __restrict__ us,
                           const float* __restrict__ zs,
                           float* __restrict__ available,
                           float* __restrict__ interrupted,
                           float* __restrict__ price, int lanes, int pools,
                           int hours) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int p = lane % pools;
  Lane s;
  s.hazard = hazard[p];
  s.recovery = recovery[p];
  s.band = band[p];
  s.band3 = __fmul_rn(0.3f, s.band);
  s.avail = avail0[lane];
  s.price = 0.0f;

  const size_t stride = static_cast<size_t>(lanes);
  size_t off = static_cast<size_t>(lane);
  int t = 0;
  for (; t + kUnroll <= hours; t += kUnroll) {
    float u[kUnroll], z[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      u[i] = __ldcs(us + off + i * stride);
      z[i] = __ldcs(zs + off + i * stride);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const size_t o = off + i * stride;
      step(s, u[i], z[i], available + o, interrupted + o, price + o);
    }
    off += kUnroll * stride;
  }
  for (; t < hours; ++t, off += stride) {
    step(s, __ldcs(us + off), __ldcs(zs + off), available + off,
         interrupted + off, price + off);
  }
}

}  // namespace

extern "C" int revocation_walk_launch(const float* hazard,
                                      const float* recovery,
                                      const float* band, const float* avail0,
                                      const float* us, const float* zs,
                                      float* available, float* interrupted,
                                      float* price, int lanes, int pools,
                                      int hours, cudaStream_t stream) {
  if (lanes <= 0 || pools <= 0 || hours <= 0) return 0;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  revocation_walk_kernel<<<blocks, kThreads, 0, stream>>>(
      hazard, recovery, band, avail0, us, zs, available, interrupted, price,
      lanes, pools, hours);
  return static_cast<int>(cudaGetLastError());
}
