// Mamba's selective scan and its backward for Hopper (sm_90a), CUDA C++
// with plain C entry points for ctypes.
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
// steps whose (B, L, D, N) decay and input tensors it materializes, and
// JAX gets its backward by autodiff.  Here nothing of size S x D x N ever
// reaches memory.
//
// What held the first design back: the recurrence is serial in t, and
// PR 25's kernel walked each (b, c) over all S steps (4 lanes a channel,
// 256 blocks of 128 threads at batch 1 and D 8192, ~8 warps an SM): paced
// by the latency of its per-step chain, 5.2x its bytes bound.
//
// Design, forward: the sequence is cut into chunks of kChunk = 64 steps,
// and three kernels run one after the other on the stream:
//   1. scan_chunks<N, false>: every (b, chunk, channel) runs its chunk
//      from h = 0 and writes the chunk's local end state into `states`
//      (B, C, D, N) and the sum of its deltas into `dsum` (B, C, D);
//   2. scan_combine: one thread per (b, c, n) walks the C chunks in order,
//      start_k = h, h = exp(a dsum_k) h + local_k, writing each chunk's
//      true start state over its local end state in `states` (kBatch
//      chunks' loads in flight at once);
//   3. scan_chunks<N, true>: every (b, chunk, channel) runs its chunk
//      again from its start state and writes y; the last chunk writes
//      h_out.
// One thread a channel holds its N states in registers (no shuffles);
// delta and x come straight from global memory, a warp's 32 channels one
// 128-byte row a step, kAhead steps ahead in a register ring; bm and cm
// are staged for the chunk in shared memory and read as broadcasts.  At
// S = 2048 that is 32 chunks of independent work: 2,048 blocks of 128
// threads at batch 1.  The price: delta and x are read twice (20 bytes per
// (step, channel) against the 12 of one pass) and every exponential is
// taken twice, and the states make a round trip (16.8 MB at jamba's
// prefill).  `states` is an output: the chunk-start states are what the
// backward reads.
//
// Design, backward (the adjoint g_t of h_t runs back in time: g_{t-1} =
// dy_{t-1} C_{t-1} + A_t g_t with A_t = exp(delta_t a), a linear
// recurrence chunked the same way):
//   A. bwd_local: every (b, chunk, channel) runs its chunk's adjoint back
//      from 0, one thread a channel as the forward's passes, and writes
//      u_k = A_{t0} g_{t0} into `gbuf` (B, C, D, N) and the sum of its
//      deltas into `dsum`;
//   B. bwd_combine: one thread per (b, c, n) walks the chunks back,
//      G = dh_final (or 0), then for k = C-1 .. 0: gbuf_k = G (the adjoint
//      entering chunk k from its end), G = exp(a dsum_k) G + u_k; finally
//      dh0 = G;
//   C. bwd_grads: every (b, chunk, channel) recomputes its forward states
//      from its saved start state, in sub-chunks of kSub = 16 steps held
//      in registers (one pass over the chunk keeps each sub-chunk's start
//      state; each sub-chunk, last first, is rerun into registers and then
//      walked back carrying g), so h_{t-1} is never recovered by dividing
//      by A_t (which underflows).  L = N / 4 neighbouring lanes of a warp
//      hold one channel's states, 4 each; a block of 8 N threads covers 32
//      channels, whose delta, x and dy rows it stages for the chunk in
//      shared memory by cp.async.  Per step: ddelta and dx (sums over the
//      lanes of a channel), written over the staged delta and x rows once
//      every lane has read them (__syncwarp); dB and dC (sums over the
//      block's 32 channels: shuffles within a warp, then a fixed-order sum
//      over the warps in shared memory) as one partial per (b, channel
//      block, t) into `dbm_part`, `dcm_part` (B, D / 32, S, N); da summed
//      over the chunk's steps per thread, into `gbuf` (B, C, D, N) in
//      place of the adjoint it read.
// No float atomics: the wrapper sums the partials over their axis with
// torch (a fixed order), so a rerun is bit for bit.  A simple first
// design: its shuffles and three exponentials a (step, channel, state)
// keep it far above its bound.
//
// Bound: bytes.  The forward must read delta and x and write y once: 12
// bytes per (step, channel), against ~8 operations per (step, channel,
// state), 2.4 operations a byte at N = 16, below the card's ~20 float32
// operations per byte: ~0.06 ms at (1, 2048, 8192, 16) and 3.35 TB/s.
// The backward must read delta, x and dy and write ddelta and dx: 20
// bytes per (step, channel).
//
// Numerics: exp(delta a) is 2^(delta (a log2 e)) by ex2.approx.ftz (~2 ulp;
// a decay below 2^-126 flushes to 0), a's scale rounded once (relative
// error ~|delta a| x 2^-24 in the decay); a chunk's decay in the combines
// is 2^((a log2 e) sum delta), the deltas summed in step order, where the
// plain versions multiply the per-step decays: equal but for float32
// rounding.  Products in the reference's order ((delta * bm) * x); nvcc
// fuses the updates into fma; the group and block sums are butterflies and
// fixed trees.  The plain versions (ref.py, torch step loops) round each
// operation apart and sum in their own order, so the two agree to float32
// rounding (within 1e-5 of each output's largest on the card), not bit for
// bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 64;   // steps per chunk
constexpr int kSub = 16;     // steps per register-held sub-chunk (backward)
constexpr int kCpb = 32;     // channels per block of bwd_grads
constexpr int kSpl = 4;      // states per lane
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kLaneThreads = 128;  // one thread a channel: channels a block
constexpr int kBatch = 8;          // chunks a combine thread loads at once
constexpr int kAhead = 4;          // steps a lane thread loads ahead

// 2^x by the special function unit alone (ex2.approx.ftz: ~2 ulp, a
// subnormal result flushed to zero); exp2f adds a range fix-up.
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static_assert(kChunk % kSub == 0, "sub-chunks tile a chunk");

template <int N>
struct Shape {
  static_assert(N == 8 || N == 16, "state sizes the kernels are built for");
  static constexpr int kL = N / kSpl;            // lanes per channel
  static constexpr int kThreads = kCpb * kL;     // 256 / 128 ... 64
  static constexpr int kWarps = kThreads / 32;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A lane's 4 floats from shared memory as one 16-byte load (each lane's
// first state is a multiple of 4 and rows hold N floats).
__device__ __forceinline__ void load4(float* out, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

// Rows t0 .. t0 + rows - 1 of a (S, D) plane's columns c0 .. c0 + 31 into
// dst[kChunk][kCpb]; columns past D are zeroed.
template <int Threads>
__device__ __forceinline__ void stage_cols(float* dst, const float* src,
                                           int t0, int rows, int c0, int D,
                                           bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kCpb / 4); i += Threads) {
      const int r = i / (kCpb / 4), cc = (i % (kCpb / 4)) * 4;
      float* s = dst + r * kCpb + cc;
      if (c0 + cc < D) {
        cp_async16(s, src + static_cast<long long>(t0 + r) * D + c0 + cc);
      } else {
        s[0] = s[1] = s[2] = s[3] = 0.0f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * kCpb; i += Threads) {
      const int r = i / kCpb, cc = i % kCpb;
      if (c0 + cc < D) {
        cp_async4(dst + i, src + static_cast<long long>(t0 + r) * D + c0 + cc);
      } else {
        dst[i] = 0.0f;
      }
    }
  }
}

// Rows t0 .. t0 + rows - 1 of a (S, N) plane into dst[kChunk][N].
template <int N, int Threads>
__device__ __forceinline__ void stage_states(float* dst, const float* src,
                                             int t0, int rows, bool vec) {
  const float* base = src + static_cast<long long>(t0) * N;
  if (vec) {
    for (int i = threadIdx.x; i < rows * N / 4; i += Threads)
      cp_async16(dst + 4 * i, base + 4 * i);
  } else {
    for (int i = threadIdx.x; i < rows * N; i += Threads)
      cp_async4(dst + i, base + i);
  }
}

// Rows back to global memory: dst (S, D) rows t0.. from src[kChunk][kCpb].
template <int Threads>
__device__ __forceinline__ void store_cols(float* dst, const float* src,
                                           int t0, int rows, int c0, int D) {
  for (int i = threadIdx.x; i < rows * kCpb; i += Threads) {
    const int r = i / kCpb, cc = i % kCpb;
    if (c0 + cc < D)
      __stcs(dst + static_cast<long long>(t0 + r) * D + c0 + cc, src[i]);
  }
}

// Sum over the L lanes of a channel (a butterfly within the group).
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, L);
  return v;
}

// Sum over the warp's channels, lanes with the same state group (stride L).
template <int L>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's (batch, chunk, channel block) and this thread's channel.
struct Place {
  long long b;
  int k, c0, cl, g, c, t0, rows;
  bool live;
};

template <int N>
__device__ __forceinline__ Place place(int S, int D) {
  constexpr int kL = Shape<N>::kL;
  Place p;
  p.c0 = blockIdx.x * kCpb;
  p.k = blockIdx.y;
  p.b = blockIdx.z;
  p.cl = threadIdx.x / kL;
  p.g = threadIdx.x % kL;
  p.c = p.c0 + p.cl;
  p.live = p.c < D;
  p.t0 = p.k * kChunk;
  p.rows = min(kChunk, S - p.t0);
  return p;
}

// Forward pass 1 (OutY = false) and pass 3 (OutY = true): one thread a
// channel, its N states in registers; delta and x read straight from
// global memory (a warp's 32 channels are one 128-byte row a step), bm and
// cm staged for the chunk in shared memory and read as broadcasts.
template <int N, bool OutY>
__global__ void __launch_bounds__(kLaneThreads)
    scan_chunks(const float* __restrict__ delta, const float* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ states,
                float* __restrict__ dsum, float* __restrict__ y,
                float* __restrict__ h_out, int S, int D, int C) {
  __shared__ __align__(16) float s_b[kChunk * N], s_c[OutY ? kChunk * N : 4];
  const int c = blockIdx.x * kLaneThreads + threadIdx.x;
  const int k = blockIdx.y;
  const long long b = blockIdx.z;
  const int t0 = k * kChunk, rows = min(kChunk, S - t0);
  const bool live = c < D;
  const long long row = b * S;
  const bool vec_n = aligned16(bm) && aligned16(cm);
  stage_states<N, kLaneThreads>(s_b, bm + row * N, t0, rows, vec_n);
  if (OutY)
    stage_states<N, kLaneThreads>(s_c, cm + row * N, t0, rows, vec_n);
  cp_async_wait_all();
  __syncthreads();

  const long long sidx = ((b * C + k) * D + c) * N;
  float h[N], an[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    an[j] = live ? a[static_cast<long long>(c) * N + j] * kLog2e : 0.0f;
    h[j] = (OutY && live) ? states[sidx + j] : 0.0f;
  }
  const long long off = (row + t0) * D + c;
  // a ring of kAhead steps' delta and x in registers: step r + kAhead is
  // loaded while step r is computed, so the loads' latency hides behind
  // kAhead steps of work
  float dq[kAhead], xq[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const long long at = off + static_cast<long long>(i) * D;
    dq[i] = (live && i < rows) ? __ldg(delta + at) : 0.0f;
    xq[i] = (live && i < rows) ? __ldg(x + at) : 0.0f;
  }
  float dtot = 0.0f;
  for (int r0 = 0; r0 < rows; r0 += kAhead) {  // uniform across the block
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int r = r0 + i;
      if (r >= rows) break;
      const float dv = dq[i], xv = xq[i];
      const long long at = off + static_cast<long long>(r) * D;
      if (live && r + kAhead < rows) {
        dq[i] = __ldg(delta + at + static_cast<long long>(kAhead) * D);
        xq[i] = __ldg(x + at + static_cast<long long>(kAhead) * D);
      }
      float yv = 0.0f;
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        float bv[4], cv[4];
        load4(bv, &s_b[r * N + q]);
        if (OutY) load4(cv, &s_c[r * N + q]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[q + e] = fexp2(dv * an[q + e]) * h[q + e] + dv * bv[e] * xv;
          if (OutY) yv += cv[e] * h[q + e];
        }
      }
      if (OutY) {
        if (live) __stcs(y + at, yv);
      } else {
        dtot += dv;
      }
    }
  }
  if (!live) return;
  if (OutY) {
    if (k == C - 1) {
#pragma unroll
      for (int j = 0; j < N; ++j) h_out[(b * D + c) * N + j] = h[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) states[sidx + j] = h[j];
    dsum[(b * C + k) * D + c] = dtot;
  }
}

// Forward pass 2: one thread per (b, c, n), the chunks in order; the
// local end states in `states` become the chunks' start states.
__global__ void scan_combine(const float* __restrict__ a,
                             const float* __restrict__ h0,
                             float* __restrict__ states,
                             const float* __restrict__ dsum, int B, int C,
                             int D, int N) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * D * N) return;
  const long long b = i / (static_cast<long long>(D) * N);
  const int cn = static_cast<int>(i % (static_cast<long long>(D) * N));
  const int c = cn / N;
  const float an = a[cn] * kLog2e;
  float h = h0[i];
  // kBatch chunks' loads in flight at once: the walk's latency is paid
  // once a batch, not once a chunk
  for (int k0 = 0; k0 < C; k0 += kBatch) {
    float local[kBatch], ds[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int k = k0 + e;
      if (k < C) {
        local[e] = states[(b * C + k) * D * N + cn];
        ds[e] = dsum[(b * C + k) * D + c];
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int k = k0 + e;
      if (k < C) {
        states[(b * C + k) * D * N + cn] = h;
        h = fexp2(an * ds[e]) * h + local[e];
      }
    }
  }
}

// Backward pass A: each chunk's adjoint from 0 at its end back to its
// first step, one thread a channel as the forward's passes; u_k = A_{t0}
// g_{t0} into gbuf, the chunk's delta sum.
template <int N>
__global__ void __launch_bounds__(kLaneThreads)
    bwd_local(const float* __restrict__ delta, const float* __restrict__ a,
              const float* __restrict__ cm, const float* __restrict__ dy,
              float* __restrict__ gbuf, float* __restrict__ dsum, int S,
              int D, int C) {
  __shared__ __align__(16) float s_c[kChunk * N];
  const int c = blockIdx.x * kLaneThreads + threadIdx.x;
  const int k = blockIdx.y;
  const long long b = blockIdx.z;
  const int t0 = k * kChunk, rows = min(kChunk, S - t0);
  const bool live = c < D;
  const long long row = b * S;
  stage_states<N, kLaneThreads>(s_c, cm + row * N, t0, rows, aligned16(cm));
  cp_async_wait_all();
  __syncthreads();
  float an[N], u[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    an[j] = live ? a[static_cast<long long>(c) * N + j] * kLog2e : 0.0f;
    u[j] = 0.0f;
  }
  const long long off = (row + t0) * D + c;
  // the forward's ring of loads ahead, walking back from the last step
  float dq[kAhead], gq[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const long long at = off + static_cast<long long>(rows - 1 - i) * D;
    dq[i] = (live && i < rows) ? __ldg(delta + at) : 0.0f;
    gq[i] = (live && i < rows) ? __ldg(dy + at) : 0.0f;
  }
  float dtot = 0.0f;
  for (int r0 = rows - 1; r0 >= 0; r0 -= kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int r = r0 - i;
      if (r < 0) break;
      const float dv = dq[i], gv = gq[i];
      const long long at = off + static_cast<long long>(r) * D;
      if (live && r - kAhead >= 0) {
        dq[i] = __ldg(delta + at - static_cast<long long>(kAhead) * D);
        gq[i] = __ldg(dy + at - static_cast<long long>(kAhead) * D);
      }
      dtot += dv;
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        float cv[4];
        load4(cv, &s_c[r * N + q]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          u[q + e] = fexp2(dv * an[q + e]) * (gv * cv[e] + u[q + e]);
      }
    }
  }
  if (!live) return;
  const long long at = ((b * C + k) * D + c) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) gbuf[at + j] = u[j];
  // the same chunk sum as the forward's, in reverse step order
  dsum[(b * C + k) * D + c] = dtot;
}

// Backward pass B: one thread per (b, c, n), the chunks back to front.
__global__ void bwd_combine(const float* __restrict__ a,
                            const float* __restrict__ dh_final,
                            float* __restrict__ gbuf,
                            const float* __restrict__ dsum,
                            float* __restrict__ dh0, int B, int C, int D,
                            int N) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * D * N) return;
  const long long b = i / (static_cast<long long>(D) * N);
  const int cn = static_cast<int>(i % (static_cast<long long>(D) * N));
  const int c = cn / N;
  const float an = a[cn] * kLog2e;
  float g = dh_final ? dh_final[i] : 0.0f;
  for (int k0 = C - 1; k0 >= 0; k0 -= kBatch) {
    float u[kBatch], ds[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int k = k0 - e;
      if (k >= 0) {
        u[e] = gbuf[(b * C + k) * D * N + cn];
        ds[e] = dsum[(b * C + k) * D + c];
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int k = k0 - e;
      if (k >= 0) {
        gbuf[(b * C + k) * D * N + cn] = g;
        g = fexp2(an * ds[e]) * g + u[e];
      }
    }
  }
  dh0[i] = g;
}

// Backward pass C: the gradients of each chunk's steps.
template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads)
    bwd_grads(const float* __restrict__ delta, const float* __restrict__ x,
              const float* __restrict__ a, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ dy,
              const float* __restrict__ states, float* __restrict__ gbuf,
              float* __restrict__ ddelta, float* __restrict__ dx,
              float* __restrict__ dbm_part, float* __restrict__ dcm_part,
              int S, int D, int C) {
  constexpr int kL = Shape<N>::kL, kThreads = Shape<N>::kThreads;
  constexpr int kWarps = Shape<N>::kWarps;
  __shared__ __align__(16) float s_d[kChunk * kCpb], s_x[kChunk * kCpb],
      s_g[kChunk * kCpb];
  __shared__ __align__(16) float s_b[kChunk * N], s_c[kChunk * N];
  // per warp, per step of a sub-chunk: its channels' dB and dC sums
  __shared__ float s_rb[kWarps][kSub][N], s_rc[kWarps][kSub][N];
  const Place p = place<N>(S, D);
  const long long row = p.b * S;
  const bool vec = (D % 4 == 0) && aligned16(delta) && aligned16(x) &&
                   aligned16(dy);
  const bool vec_n = aligned16(bm) && aligned16(cm);
  stage_cols<kThreads>(s_d, delta + row * D, p.t0, p.rows, p.c0, D, vec);
  stage_cols<kThreads>(s_x, x + row * D, p.t0, p.rows, p.c0, D, vec);
  stage_cols<kThreads>(s_g, dy + row * D, p.t0, p.rows, p.c0, D, vec);
  stage_states<N, kThreads>(s_b, bm + row * N, p.t0, p.rows, vec_n);
  stage_states<N, kThreads>(s_c, cm + row * N, p.t0, p.rows, vec_n);
  cp_async_wait_all();
  __syncthreads();

  const int n0 = p.g * kSpl;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long sidx = ((p.b * C + p.k) * D + p.c) * N + n0;
  const int cblocks = gridDim.x;
  float an[kSpl], av[kSpl], carry[kSpl], da[kSpl];
  float hs[kChunk / kSub][kSpl];   // each sub-chunk's start state
  {
    float h[kSpl];
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      av[j] = p.live ? a[static_cast<long long>(p.c) * N + n0 + j] : 0.0f;
      an[j] = av[j] * kLog2e;
      h[j] = p.live ? states[sidx + j] : 0.0f;
      carry[j] = p.live ? gbuf[sidx + j] : 0.0f;
      da[j] = 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kChunk / kSub; ++q) {
#pragma unroll
      for (int j = 0; j < kSpl; ++j) hs[q][j] = h[j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = q * kSub + i;
        if (r < p.rows) {
          const float dv = s_d[r * kCpb + p.cl], xv = s_x[r * kCpb + p.cl];
          float bv[kSpl];
          load4(bv, &s_b[r * N + n0]);
#pragma unroll
          for (int j = 0; j < kSpl; ++j)
            h[j] = fexp2(dv * an[j]) * h[j] + dv * bv[j] * xv;
        }
      }
    }
  }

#pragma unroll
  for (int q = kChunk / kSub - 1; q >= 0; --q) {
    const int r0 = q * kSub;
    if (r0 >= p.rows) continue;   // uniform across the block
    float hist[kSub][kSpl];       // h_t of the sub-chunk's steps
    {
      float h[kSpl];
#pragma unroll
      for (int j = 0; j < kSpl; ++j) h[j] = hs[q][j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = r0 + i;
        if (r < p.rows) {
          const float dv = s_d[r * kCpb + p.cl], xv = s_x[r * kCpb + p.cl];
          float bv[kSpl];
          load4(bv, &s_b[r * N + n0]);
#pragma unroll
          for (int j = 0; j < kSpl; ++j)
            h[j] = fexp2(dv * an[j]) * h[j] + dv * bv[j] * xv;
        }
#pragma unroll
        for (int j = 0; j < kSpl; ++j) hist[i][j] = h[j];
      }
    }
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      const int r = r0 + i;
      if (r >= p.rows) continue;  // uniform across the block
      const float dv = s_d[r * kCpb + p.cl], xv = s_x[r * kCpb + p.cl];
      const float gv = s_g[r * kCpb + p.cl];
      float bv[kSpl], cv[kSpl];
      load4(bv, &s_b[r * N + n0]);
      load4(cv, &s_c[r * N + n0]);
      float dd = 0.0f, dxp = 0.0f;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        const float hp = i > 0 ? hist[i - 1][j] : hs[q][j];
        const float ea = fexp2(dv * an[j]);
        const float gj = gv * cv[j] + carry[j];
        const float bx = bv[j] * xv;
        dd += gj * (av[j] * ea * hp + bx);
        dxp += gj * dv * bv[j];
        da[j] += gj * dv * ea * hp;
        carry[j] = ea * gj;
        // this step's dC and dB, summed over the warp's channels
        const float sc = channel_sum<kL>(gv * hist[i][j]);
        const float sb = channel_sum<kL>(gj * dv * xv);
        if (lane < kL) {
          s_rc[warp][i][n0 + j] = sc;
          s_rb[warp][i][n0 + j] = sb;
        }
      }
      dd = group_sum<kL>(dd);
      dxp = group_sum<kL>(dxp);
      __syncwarp();   // every lane of the channel has read delta and x
      if (p.g == 0) {
        s_d[r * kCpb + p.cl] = dd;
        s_x[r * kCpb + p.cl] = dxp;
      }
    }
    __syncthreads();
    // the block's dB, dC partials of this sub-chunk, warps summed in order
    const int rows = min(kSub, p.rows - r0);
    for (int e = threadIdx.x; e < rows * N; e += kThreads) {
      const int i = e / N, nn = e % N;
      float sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += s_rb[w][i][nn];
        sc += s_rc[w][i][nn];
      }
      const long long at =
          ((p.b * cblocks + blockIdx.x) * S + p.t0 + r0 + i) * N + nn;
      dbm_part[at] = sb;
      dcm_part[at] = sc;
    }
    __syncthreads();
  }
  store_cols<kThreads>(ddelta + row * D, s_d, p.t0, p.rows, p.c0, D);
  store_cols<kThreads>(dx + row * D, s_x, p.t0, p.rows, p.c0, D);
  if (p.live) {
#pragma unroll
    for (int j = 0; j < kSpl; ++j) gbuf[sidx + j] = da[j];
  }
}

dim3 chunk_grid(int B, int C, int D) {
  return dim3((D + kCpb - 1) / kCpb, C, B);
}

dim3 lane_grid(int B, int C, int D) {
  return dim3((D + kLaneThreads - 1) / kLaneThreads, C, B);
}

bool grid_ok(int B, int C) { return B <= 65535 && C <= 65535; }

unsigned flat_blocks(int B, int D, int N) {
  return static_cast<unsigned>(
      (static_cast<long long>(B) * D * N + 255) / 256);
}

template <int N>
cudaError_t forward(const float* delta, const float* x, const float* a,
                    const float* bm, const float* cm, const float* h0,
                    float* y, float* h_out, float* states, float* dsum,
                    int B, int S, int D, cudaStream_t stream) {
  const int C = (S + kChunk - 1) / kChunk;
  if (!grid_ok(B, C)) return cudaErrorInvalidConfiguration;
  const dim3 grid = lane_grid(B, C, D);
  constexpr int kThreads = kLaneThreads;
  scan_chunks<N, false><<<grid, kThreads, 0, stream>>>(
      delta, x, a, bm, cm, states, dsum, y, h_out, S, D, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_combine<<<flat_blocks(B, D, N), 256, 0, stream>>>(a, h0, states, dsum,
                                                         B, C, D, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_chunks<N, true><<<grid, kThreads, 0, stream>>>(
      delta, x, a, bm, cm, states, dsum, y, h_out, S, D, C);
  return cudaGetLastError();
}

template <int N>
cudaError_t backward(const float* delta, const float* x, const float* a,
                     const float* bm, const float* cm, const float* dy,
                     const float* states, const float* dh_final,
                     float* ddelta, float* dx, float* dh0, float* gbuf,
                     float* dsum, float* dbm_part, float* dcm_part, int B,
                     int S, int D, cudaStream_t stream) {
  const int C = (S + kChunk - 1) / kChunk;
  if (!grid_ok(B, C)) return cudaErrorInvalidConfiguration;
  const dim3 grid = chunk_grid(B, C, D);
  constexpr int kThreads = Shape<N>::kThreads;
  bwd_local<N><<<lane_grid(B, C, D), kLaneThreads, 0, stream>>>(
      delta, a, cm, dy, gbuf, dsum, S, D, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_combine<<<flat_blocks(B, D, N), 256, 0, stream>>>(
      a, dh_final, gbuf, dsum, dh0, B, C, D, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_grads<N><<<grid, kThreads, 0, stream>>>(
      delta, x, a, bm, cm, dy, states, gbuf, ddelta, dx, dbm_part, dcm_part,
      S, D, C);
  return cudaGetLastError();
}

}  // namespace

// delta, x, y (B, S, D); a (D, N); bm, cm (B, S, N); h0, h_out (B, D, N);
// states (B, C, D, N) and dsum (B, C, D) with C = ceil(S / 64), the
// chunk-start states (an output) and scratch; all contiguous float32, S
// >= 1.  Launches the three forward kernels; returns the first CUDA error
// (0 on success); an N other than 8 or 16 is cudaErrorInvalidValue.
extern "C" int mamba_scan_launch(const float* delta, const float* x,
                                 const float* a, const float* bm,
                                 const float* cm, const float* h0, float* y,
                                 float* h_out, float* states, float* dsum,
                                 int B, int S, int D, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 8:
      err = forward<8>(delta, x, a, bm, cm, h0, y, h_out, states, dsum, B, S,
                       D, s);
      break;
    case 16:
      err = forward<16>(delta, x, a, bm, cm, h0, y, h_out, states, dsum, B,
                        S, D, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The backward from the forward's chunk-start `states`: dy, ddelta, dx
// (B, S, D); dh_final (B, D, N) or null; dh0 (B, D, N); gbuf (B, C, D, N)
// scratch that ends holding da's per-(b, chunk) partials; dsum (B, C, D)
// scratch; dbm_part, dcm_part (B, ceil(D / 32), S, N) partials.  All
// contiguous float32, S >= 1.  Launches the three backward kernels;
// returns the first CUDA error (0 on success).
extern "C" int mamba_scan_bwd_launch(
    const float* delta, const float* x, const float* a, const float* bm,
    const float* cm, const float* dy, const float* states,
    const float* dh_final, float* ddelta, float* dx, float* dh0, float* gbuf,
    float* dsum, float* dbm_part, float* dcm_part, int B, int S, int D, int N,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 8:
      err = backward<8>(delta, x, a, bm, cm, dy, states, dh_final, ddelta, dx,
                        dh0, gbuf, dsum, dbm_part, dcm_part, B, S, D, s);
      break;
    case 16:
      err = backward<16>(delta, x, a, bm, cm, dy, states, dh_final, ddelta,
                         dx, dh0, gbuf, dsum, dbm_part, dcm_part, B, S, D, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
