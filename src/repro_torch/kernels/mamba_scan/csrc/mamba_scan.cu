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
//   C. bwd_grads: a block is one (b, chunk) and kCpb = 128 channels,
//      taken kCh = 32 at a time; L = N / 4 neighbouring lanes hold one
//      channel's states, 4 each.  Each pass stages its delta, x and dy
//      columns for the chunk by cp.async, runs the chunk forward from its
//      saved start state keeping each kSub = 8-step sub-chunk's start
//      state (one exponential), then reruns each sub-chunk, last first,
//      keeping A_t and A_t h_{t-1} in registers (the second exponential),
//      and walks it back carrying g with no exponential of its own; h_{t-1}
//      is never recovered by dividing by A_t (which underflows).  The sums
//      go two steps at a time through reduce-scatter butterflies, each
//      round sending half of what a lane holds: ddelta and dx (over the
//      lanes of a channel; dx = delta sum_n g B) in 3 shuffles a lane
//      where plain trees take 8, each lane then storing one of the four to
//      global memory; dC (in the forward run) and dB (in the walk) over the
//      warp's channels in 7 shuffles where plain trees take 24, added by
//      each warp into its own rows of shared memory, pass after pass; at
//      the end the block sums its warps in order into one partial per (b,
//      128 channels, t) in `dbm_part`, `dcm_part` (B, D / 128, S, N); da
//      summed over the chunk's steps per thread, into `gbuf` (B, C, D, N)
//      in place of the adjoint it read.  The sub-chunk loops are rolled
//      (the start states in local memory): unrolled over the eight
//      sub-chunks, the same kernel took ~1.5x as long, most likely from
//      instruction-cache misses.
// No float atomics: the wrapper sums the partials over their axis with
// torch (a fixed order), so a rerun is bit for bit.  The partials are 67
// MB at jamba's train shape.  What bounds pass C, by probes that removed
// one part at a time at jamba's train shape (pass C ~2.2 ms;
// tools/kernel_ab.py): the forward run that keeps the sub-chunk starts
// (~0.6 ms, dC's sums included), the shuffles and their selects (~0.55
// ms), instruction issue at 12 warps an SM (160 registers and 64 KB of
// shared memory a block of 4 warps); hardly its exponentials (~0.17
// ms).  Taking the sub-chunk starts
// from pass A instead (run forward) would move ~1.2 GB more through HBM,
// about what the forward run costs.
//
// Bound: bytes.  The forward must read delta and x and write y once: 12
// bytes per (step, channel), against ~8 operations per (step, channel,
// state), 2.4 operations a byte at N = 16, below the card's ~20 float32
// operations per byte: ~0.06 ms at (1, 2048, 8192, 16) and 3.35 TB/s.
// The backward must read delta, x and dy and write ddelta and dx: 20
// bytes per (step, channel).  The exponentials are taken by the special
// function unit, 16 a clock an SM (an eighth of the FMA rate).
//
// Numerics: exp(delta a) is 2^(delta (a log2 e)) by ex2.approx.ftz (~2 ulp;
// a decay below 2^-126 flushes to 0), a's scale rounded once (relative
// error ~|delta a| x 2^-24 in the decay); a chunk's decay in the combines
// is 2^((a log2 e) sum delta), the deltas summed in step order, where the
// plain versions multiply the per-step decays: equal but for float32
// rounding.  The forward's products in the reference's order ((delta *
// bm) * x), the backward's as bm * (delta * x), delta * x taken once a
// step; nvcc fuses the updates into fma; the group and block sums are
// butterflies and fixed trees.  The plain versions (ref.py, torch step
// loops) round each operation apart and sum in their own order, so the two
// agree to float32 rounding (within 1e-5 of each output's largest on the
// card), not bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 64;   // steps per chunk
constexpr int kSub = 8;      // steps per register-held sub-chunk (backward)
constexpr int kCh = 32;      // channels a pass of bwd_grads stages
constexpr int kPasses = 4;   // passes a block of bwd_grads
constexpr int kCpb = kCh * kPasses;  // channels a block: one dB/dC partial
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
  static constexpr int kThreads = kCh * kL;      // 128 at N 16, 64 at N 8
  static constexpr int kWarps = kThreads / 32;
  // bwd_grads' dynamic shared memory (floats): delta, x, dy of a pass
  // (kChunk x kCh each), bm and cm (kChunk x N each), and each warp's dB
  // and dC sums over its channels (kWarps x kChunk x N each)
  static constexpr int kGradFloats =
      3 * kChunk * kCh + 2 * kChunk * N + 2 * kWarps * kChunk * N;
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
// dst[kChunk][kCh]; columns past D are zeroed.
template <int Threads>
__device__ __forceinline__ void stage_cols(float* dst, const float* src,
                                           int t0, int rows, int c0, int D,
                                           bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kCh / 4); i += Threads) {
      const int r = i / (kCh / 4), cc = (i % (kCh / 4)) * 4;
      float* s = dst + r * kCh + cc;
      if (c0 + cc < D) {
        cp_async16(s, src + static_cast<long long>(t0 + r) * D + c0 + cc);
      } else {
        s[0] = s[1] = s[2] = s[3] = 0.0f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * kCh; i += Threads) {
      const int r = i / kCh, cc = i % kCh;
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

// The channel's sums over its L lanes (the lanes' state groups) of two
// steps' (ddelta, dx) terms v[slot][0 | 1], reduced and scattered: the
// round L / 2 apart sends one slot and adds the partner's other (a select
// pair, one shuffle and one add per value), the round 1 apart (L = 4)
// sends one of the two sums.  At L = 4 the lane ends with the sum of term
// (lane & 1) of slot (lane >> 1) & 1; at L = 2 with both terms of slot
// (lane & 1), in out[0], out[1].
template <int L>
__device__ __forceinline__ void group_rs(const float (&v)[2][2], int lane,
                                         float (&out)[2]) {
  const bool hi = lane & (L / 2);
  float k0 = hi ? v[1][0] : v[0][0], k1 = hi ? v[1][1] : v[0][1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? v[0][0] : v[1][0], L / 2);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? v[0][1] : v[1][1], L / 2);
  if constexpr (L == 4) {
    const bool odd = lane & 1;
    out[0] = (odd ? k1 : k0) +
             __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1);
  } else {
    out[0] = k0;
    out[1] = k1;
  }
}

// The sums over the warp's channels (lanes L, 2 L, .. 16 apart) of two
// steps' terms of this lane's four states, v[slot][0..3], reduced and
// scattered: the rounds 16, 8 and 4 apart each send half of what a lane
// still holds and add the partner's half, a round 2 apart (L = 2) is a
// plain butterfly.  The lane ends with the sum for slot (lane >> 4) & 1
// and state n0 + rs_state(lane); the rs_writer lanes hold each once.
template <int L>
__device__ __forceinline__ float channel_rs(const float (&v)[2][kSpl],
                                            int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  float k[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    k[j] = (hi16 ? v[1][j] : v[0][j]) +
           __shfl_xor_sync(0xffffffffu, hi16 ? v[0][j] : v[1][j], 16);
  }
  const float k0 = (hi8 ? k[2] : k[0]) +
                   __shfl_xor_sync(0xffffffffu, hi8 ? k[0] : k[2], 8);
  const float k1 = (hi8 ? k[3] : k[1]) +
                   __shfl_xor_sync(0xffffffffu, hi8 ? k[1] : k[3], 8);
  float kk = (hi4 ? k1 : k0) +
             __shfl_xor_sync(0xffffffffu, hi4 ? k0 : k1, 4);
  if constexpr (L == 2) kk += __shfl_xor_sync(0xffffffffu, kk, 2);
  return kk;
}

__device__ __forceinline__ int rs_state(int lane) {
  return ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

template <int L>
__device__ __forceinline__ bool rs_writer(int lane) {
  return L == 4 || (lane & 2) == 0;
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

// Backward pass C: the gradients of each chunk's steps.  A block is one
// (b, chunk) and kCpb channels, taken kCh at a time (a pass); within a
// pass L = N / 4 neighbouring lanes hold one channel's states, 4 each.
// Per pass: the pass's delta, x, dy columns staged by cp.async; pass 1
// runs the chunk forward from its saved start state, keeping each
// sub-chunk's start state and summing dC over the warp's channels; then
// each sub-chunk, last first, is rerun with its decays A_t and A_t h_{t-1}
// kept in registers (kSub x 4 each) and walked back carrying g, with no
// exponential of its own.  The sums go two steps at a time through
// reduce-scatter butterflies: ddelta and dx over the channel's lanes
// (group_rs), each lane storing one of the four to global memory; dB and
// dC over the warp's channels (channel_rs), kept in registers until the
// sub-chunk's last step and then added by each warp into its own rows of
// shared memory, pass after pass.  da is summed per thread over the
// chunk.  The sub-chunk loops stay rolled (see the header); the start
// states live in local memory.  At the end the block sums its warps in
// order: one dB and one dC partial per (b, kCpb channels, t).
template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads, 3)
    bwd_grads(const float* __restrict__ delta, const float* __restrict__ x,
              const float* __restrict__ a, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ dy,
              const float* __restrict__ states, float* __restrict__ gbuf,
              float* __restrict__ ddelta, float* __restrict__ dx,
              float* __restrict__ dbm_part, float* __restrict__ dcm_part,
              int S, int D, int C) {
  constexpr int kL = Shape<N>::kL, kThreads = Shape<N>::kThreads;
  constexpr int kWarps = Shape<N>::kWarps;
  constexpr int kNsub = kChunk / kSub;
  static_assert(kSub % 2 == 0, "the sums go two steps at a time");
  extern __shared__ __align__(16) float smem[];
  float* s_d = smem;                      // [kChunk][kCh]
  float* s_x = s_d + kChunk * kCh;
  float* s_g = s_x + kChunk * kCh;
  float* s_b = s_g + kChunk * kCh;        // [kChunk][N]
  float* s_c = s_b + kChunk * N;
  float* s_db = s_c + kChunk * N;         // [kWarps][kChunk][N]
  float* s_dc = s_db + kWarps * kChunk * N;

  const int k = blockIdx.y;
  const long long b = blockIdx.z;
  const int t0 = k * kChunk, rows = min(kChunk, S - t0);
  const int cl = threadIdx.x / kL, sg = threadIdx.x % kL, n0 = sg * kSpl;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // where this lane's scattered sums belong: dB/dC (step of the pair,
  // state); ddelta/dx (step of the pair, term)
  const bool writer = rs_writer<kL>(lane);
  const int wslot = (lane >> 4) & 1, wn = n0 + rs_state(lane);
  const int gslot = kL == 4 ? (lane >> 1) & 1 : lane & 1;
  float* const g_w = (kL == 4 && (lane & 1)) ? dx : ddelta;
  float* const acc_b = s_db + warp * kChunk * N + wn;
  float* const acc_c = s_dc + warp * kChunk * N + wn;
  const long long row = b * S;
  const bool vec = (D % 4 == 0) && aligned16(delta) && aligned16(x) &&
                   aligned16(dy);
  stage_states<N, kThreads>(s_b, bm + row * N, t0, rows,
                            aligned16(bm) && aligned16(cm));
  stage_states<N, kThreads>(s_c, cm + row * N, t0, rows,
                            aligned16(bm) && aligned16(cm));
  for (int i = threadIdx.x; i < 2 * kWarps * kChunk * N; i += kThreads)
    s_db[i] = 0.0f;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int c0 = blockIdx.x * kCpb + pass * kCh;
    if (c0 >= D) break;  // uniform across the block
    if (pass > 0) __syncthreads();  // every warp is done with the last pass
    stage_cols<kThreads>(s_d, delta + row * D, t0, rows, c0, D, vec);
    stage_cols<kThreads>(s_x, x + row * D, t0, rows, c0, D, vec);
    stage_cols<kThreads>(s_g, dy + row * D, t0, rows, c0, D, vec);
    cp_async_wait_all();
    __syncthreads();

    const int c = c0 + cl;
    const bool live = c < D;
    const long long sidx = ((b * C + k) * D + c) * N + n0;
    float an[kSpl], av[kSpl], carry[kSpl], da[kSpl], h[kSpl];
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      av[j] = live ? a[static_cast<long long>(c) * N + n0 + j] : 0.0f;
      an[j] = av[j] * kLog2e;
      h[j] = live ? states[sidx + j] : 0.0f;
      carry[j] = live ? gbuf[sidx + j] : 0.0f;
      da[j] = 0.0f;
    }

    // pass 1: each sub-chunk's start state; dC_t = sum_c dy_t h_t
    float hs[kNsub][kSpl];
#pragma unroll 1
    for (int q = 0; q < kNsub; ++q) {
      const int r0 = q * kSub;
      if (r0 >= rows) break;  // uniform across the block
#pragma unroll
      for (int j = 0; j < kSpl; ++j) hs[q][j] = h[j];
      float zc[2][kSpl], zq[kSub / 2];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int j = 0; j < kSpl; ++j) zc[i & 1][j] = 0.0f;
        if (r < rows) {  // uniform across the block
          const float dv = s_d[r * kCh + cl], xv = s_x[r * kCh + cl];
          const float gv = s_g[r * kCh + cl], dvx = dv * xv;
          float bv[kSpl];
          load4(bv, &s_b[r * N + n0]);
#pragma unroll
          for (int j = 0; j < kSpl; ++j) {
            h[j] = fmaf(fexp2(dv * an[j]), h[j], bv[j] * dvx);
            zc[i & 1][j] = gv * h[j];
          }
        }
        if (i & 1) {  // steps r - 1, r summed
          zq[i / 2] = r - 1 < rows ? channel_rs<kL>(zc, lane) : 0.0f;
        }
      }
      // into shared memory after the sub-chunk: no store orders its steps
      if (writer) {
#pragma unroll
        for (int i = 0; i < kSub / 2; ++i) {
          const int rw = r0 + 2 * i + wslot;
          if (rw < rows) acc_c[rw * N] += zq[i];
        }
      }
    }

    // the walk back, a sub-chunk at a time
#pragma unroll 1
    for (int q = kNsub - 1; q >= 0; --q) {
      const int r0 = q * kSub;
      if (r0 >= rows) continue;  // uniform across the block
      float ea[kSub][kSpl], qa[kSub][kSpl];  // A_t, A_t h_{t-1}
#pragma unroll
      for (int j = 0; j < kSpl; ++j) h[j] = hs[q][j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = r0 + i;
        if (r < rows) {
          const float dv = s_d[r * kCh + cl], xv = s_x[r * kCh + cl];
          const float dvx = dv * xv;
          float bv[kSpl];
          load4(bv, &s_b[r * N + n0]);
#pragma unroll
          for (int j = 0; j < kSpl; ++j) {
            ea[i][j] = fexp2(dv * an[j]);
            qa[i][j] = ea[i][j] * h[j];
            h[j] = qa[i][j] + bv[j] * dvx;
          }
        }
      }
      float gd[2][2], zb[2][kSpl], zq[kSub / 2];  // a pair of steps' terms
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int r = r0 + i, slot = i & 1;
        gd[slot][0] = gd[slot][1] = 0.0f;
#pragma unroll
        for (int j = 0; j < kSpl; ++j) zb[slot][j] = 0.0f;
        if (r < rows) {  // uniform across the block
          const float dv = s_d[r * kCh + cl], xv = s_x[r * kCh + cl];
          const float gv = s_g[r * kCh + cl], dvx = dv * xv;
          float bv[kSpl], cv[kSpl];
          load4(bv, &s_b[r * N + n0]);
          load4(cv, &s_c[r * N + n0]);
          float dd = 0.0f, dxp = 0.0f;
#pragma unroll
          for (int j = 0; j < kSpl; ++j) {
            const float gj = fmaf(gv, cv[j], carry[j]);
            dd = fmaf(gj, fmaf(av[j], qa[i][j], bv[j] * xv), dd);
            dxp = fmaf(gj, bv[j], dxp);
            da[j] = fmaf(gj * dv, qa[i][j], da[j]);
            carry[j] = ea[i][j] * gj;
            zb[slot][j] = gj * dvx;
          }
          gd[slot][0] = dd;
          gd[slot][1] = dxp * dv;
        }
        if (slot == 0 && r < rows) {  // steps r, r + 1 summed
          float gs[2];
          group_rs<kL>(gd, lane, gs);
          const float z = channel_rs<kL>(zb, lane);
          const int rg = r + gslot;
          if (rg < rows && live) {
            const long long at = (row + t0 + rg) * D + c;
            if constexpr (kL == 4) {
              __stcs(g_w + at, gs[0]);
            } else {
              __stcs(ddelta + at, gs[0]);
              __stcs(dx + at, gs[1]);
            }
          }
          zq[i / 2] = z;
        } else if (slot == 0) {
          zq[i / 2] = 0.0f;
        }
      }
      if (writer) {
#pragma unroll
        for (int i = 0; i < kSub / 2; ++i) {
          const int rw = r0 + 2 * i + wslot;
          if (rw < rows) acc_b[rw * N] += zq[i];
        }
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < kSpl; ++j) gbuf[sidx + j] = da[j];
    }
  }
  __syncthreads();
  // the block's dB, dC partials: its warps summed in order
  for (int e = threadIdx.x; e < rows * N; e += kThreads) {
    const int i = e / N, nn = e % N;
    float sb = 0.0f, sc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sb += s_db[(w * kChunk + i) * N + nn];
      sc += s_dc[(w * kChunk + i) * N + nn];
    }
    const long long at = ((b * gridDim.x + blockIdx.x) * S + t0 + i) * N + nn;
    dbm_part[at] = sb;
    dcm_part[at] = sc;
  }
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
  const dim3 grid((D + kCpb - 1) / kCpb, C, B);
  constexpr int kThreads = Shape<N>::kThreads;
  constexpr int kSmem = Shape<N>::kGradFloats * sizeof(float);
  static bool sized = false;  // bwd_grads may take kSmem (over 48 KB)
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_grads<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  bwd_local<N><<<lane_grid(B, C, D), kLaneThreads, 0, stream>>>(
      delta, a, cm, dy, gbuf, dsum, S, D, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_combine<<<flat_blocks(B, D, N), 256, 0, stream>>>(
      a, dh_final, gbuf, dsum, dh0, B, C, D, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_grads<N><<<grid, kThreads, kSmem, stream>>>(
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
// scratch; dbm_part, dcm_part (B, ceil(D / 128), S, N) partials.  All
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
