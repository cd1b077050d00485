// Mamba's selective scan for Hopper (sm_90a), CUDA C++ with a plain C entry
// point for ctypes.
//
// For every batch row b, channel c (of D) and state n (of N), from h0 and
// for t = 0 .. S-1 in order:
//
//   h[b, c, n] = exp(delta[b, t, c] * a[c, n]) * h[b, c, n]
//                + delta[b, t, c] * bm[b, t, n] * x[b, t, c]
//   y[b, t, c] = sum_n cm[b, t, n] * h[b, c, n]
//
// and h_out = h after the last step.  Everything is float32.
//
// Takes the place of the jax.lax.associative_scan in
// src/repro/models/mamba.py::_ssm_scan (the scan at line 94), which is not
// a Pallas kernel: on the TPU it is XLA's, over chunks of pick_chunk(S)
// steps whose (B, L, D, N) decay and input tensors it materializes.  Here
// nothing of size S x D x N ever reaches memory.
//
// Design: the recurrence is serial in t and independent across (b, c, n).
// L = N / SPL neighbouring lanes of a warp hold the N states of one (b, c)
// in registers, SPL = 4 states each, and walk the sequence in
// order; each step's y is their partial sums added by __shfl_xor_sync
// within the group.  At jamba's prefill (B 1, D 8192, N 16) that is 32,768
// threads in 256 blocks of 32 channels: every SM busy at batch 1 (a thread
// per channel would give 64 blocks), and 4 independent state updates per
// thread per step for the schedulers to overlap.  A block stages tiles of
// TT steps through shared memory with cp.async, double-buffered: the next
// tile's delta and x (one 128-byte row a step for its 32 channels) and
// bm and cm (N floats a step, shared by all its channels) are in flight
// while the block walks the current one, and each tile's y goes out as
// whole rows.  (A first version that loaded each step's operands per lane
// a few steps ahead kept ~2 KB in flight per SM, where the memory's
// latency wants ~25 KB, and ran 13x its bound.)
//
// Bound: bytes.  The scan must read delta and x and write y once: 12 bytes
// per (step, channel), against ~8 operations per (step, channel, state)
// (one exponential, products and multiply-adds, the group sum), 2.4
// operations a byte at N = 16, below the card's ~20 float32 operations per
// byte.  At (1, 2048, 8192, 16) the bytes take ~0.06 ms at 3.35 TB/s and
// the 268M exponentials about as long on the special function units.
//
// Numerics: exp(delta a) is exp2f(delta (a log2 e)), a's scale rounded
// once (relative error ~|delta a| x 2^-24 in the decay); products in the
// reference's order ((delta * bm) * x); nvcc fuses the state update and
// y's products into fma, and the group sum is a butterfly.  The plain
// version (ref.py, a torch step loop) rounds each operation apart and sums
// N in its own order, so the two agree to float32 rounding (within 1e-5 of
// the largest |y| on the card), not bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

constexpr float kLog2e = 1.4426950408889634f;

// A lane's 4 floats from shared memory as one 16-byte load (each lane's
// first state is a multiple of 4 and rows hold N floats).
__device__ __forceinline__ void load_states(float* out, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

template <int N>
struct Shape {
  static_assert(N == 8 || N == 16, "state sizes the kernel is built for");
  static constexpr int kSpl = 4;                  // states per lane
  static constexpr int kL = N / kSpl;             // lanes per channel
  static constexpr int kCpb = kThreads / kL;      // channels per block
  static constexpr int kTt = kCpb >= 64 ? 16 : 32;  // steps per tile
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ delta,
                      const float* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int B, int S, int D) {
  constexpr int kSpl = Shape<N>::kSpl, kL = Shape<N>::kL;
  constexpr int kCpb = Shape<N>::kCpb, kTt = Shape<N>::kTt;
  __shared__ float s_d[2][kTt][kCpb], s_x[2][kTt][kCpb];
  __shared__ __align__(16) float s_b[2][kTt][N], s_c[2][kTt][N];
  __shared__ float s_y[kTt][kCpb];

  const int per_row = (D + kCpb - 1) / kCpb;
  const long long b = blockIdx.x / per_row;
  const int c0 = (blockIdx.x % per_row) * kCpb;
  const int cl = threadIdx.x / kL;            // channel within the block
  const int g = threadIdx.x % kL;             // lane within the channel
  const int c = c0 + cl;
  // A channel past D still takes part in the shuffles and the barriers,
  // on whatever its shared slots hold, and stores nothing.
  const bool live = c < D;
  const int n0 = g * kSpl;
  float h[kSpl], an[kSpl];
#pragma unroll
  for (int k = 0; k < kSpl; ++k) {
    h[k] = live ? h0[(b * D + c) * N + n0 + k] : 0.0f;
    // exp(delta a) as exp2(delta (a log2 e)): one rounding of a's scale
    an[k] = live ? a[static_cast<long long>(c) * N + n0 + k] * kLog2e : 0.0f;
  }
  const float* d_row = delta + b * S * D;
  const float* x_row = x + b * S * D;
  const float* b_row = bm + b * S * N;
  const float* c_row = cm + b * S * N;
  float* y_row = y + b * S * D;

  // Tile t0 .. t0 + kTt - 1 into buffer buf (rows past S are left as they
  // are and never read).
  auto stage = [&](int buf, int t0) {
    const int rows = min(kTt, S - t0);
    for (int i = threadIdx.x; i < kTt * kCpb; i += kThreads) {
      const int r = i / kCpb, cc = i % kCpb;
      if (r < rows && c0 + cc < D) {
        const long long off = static_cast<long long>(t0 + r) * D + c0 + cc;
        cp_async4(&s_d[buf][r][cc], d_row + off);
        cp_async4(&s_x[buf][r][cc], x_row + off);
      }
    }
    for (int i = threadIdx.x; i < kTt * N; i += kThreads) {
      const int r = i / N;
      if (r < rows) {
        const long long off = static_cast<long long>(t0) * N + i;
        cp_async4(&s_b[buf][r][i % N], b_row + off);
        cp_async4(&s_c[buf][r][i % N], c_row + off);
      }
    }
    cp_async_commit();
  };

  const int tiles = (S + kTt - 1) / kTt;
  stage(0, 0);
  for (int k = 0; k < tiles; ++k) {
    const int buf = k & 1, t0 = k * kTt;
    if (k + 1 < tiles) {
      stage(buf ^ 1, t0 + kTt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(kTt, S - t0);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {  // uniform across the block
      const float dv = s_d[buf][r][cl], xv = s_x[buf][r][cl];
      float bv[kSpl], cv[kSpl];
      load_states(bv, &s_b[buf][r][n0]);
      load_states(cv, &s_c[buf][r][n0]);
      float yv = 0.0f;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        const float da = exp2f(dv * an[j]);
        const float bx = dv * bv[j] * xv;
        h[j] = da * h[j] + bx;
        yv += cv[j] * h[j];
      }
#pragma unroll
      for (int off = kL / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off, kL);
      if (g == 0) s_y[r][cl] = yv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * kCpb; i += kThreads) {
      const int r = i / kCpb, cc = i % kCpb;
      if (c0 + cc < D)
        __stcs(y_row + static_cast<long long>(t0 + r) * D + c0 + cc,
               s_y[r][cc]);
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kSpl; ++k) h_out[(b * D + c) * N + n0 + k] = h[k];
  }
}

template <int N>
cudaError_t launch(const float* delta, const float* x, const float* a,
                   const float* bm, const float* cm, const float* h0,
                   float* y, float* h_out, int B, int S, int D,
                   cudaStream_t stream) {
  constexpr int kCpb = Shape<N>::kCpb;
  const long long blocks =
      static_cast<long long>(B) * ((D + kCpb - 1) / kCpb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mamba_scan_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(delta, x, a, bm, cm, h0, y, h_out, B, S,
                                   D);
  return cudaGetLastError();
}

}  // namespace
// delta, x, y (B, S, D); a (D, N); bm, cm (B, S, N); h0, h_out (B, D, N);
// all contiguous float32.  Returns the CUDA error of the launch (0 on
// success); an N other than 8 or 16 is cudaErrorInvalidValue.
extern "C" int mamba_scan_launch(const float* delta, const float* x,
                                 const float* a, const float* bm,
                                 const float* cm, const float* h0, float* y,
                                 float* h_out, int B, int S, int D, int N,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 8: err = launch<8>(delta, x, a, bm, cm, h0, y, h_out, B, S, D, s);
      break;
    case 16: err = launch<16>(delta, x, a, bm, cm, h0, y, h_out, B, S, D, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
