// Commitment-cost sweep for Hopper (sm_90a), CUDA C++ with a plain C entry
// point for ctypes.
//
//   over [p, g] = sum_t w[p,t] * max(f[p,t] - cs[p,g], 0)
//   under[p, g] = sum_t w[p,t] * max(cs[p,g] - f[p,t], 0)
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/commitment_sweep/commitment_sweep.py::commitment_sweep_kernel
// (body _sweep_kernel), which compares every hour with every candidate and
// carries the T sum across its sequential grid axis in VMEM.
//
// Algorithm: buckets, not the brute force.  A row's candidates, sorted,
// cut the line into G + 1 buckets; an hour with w != 0 falls in bucket
// k = #(candidates < f) and adds three terms there, each of one sign:
//   W[k] += w,   S1[k] += w (f - c[k-1]),   S2[k] += w (c[k] - f).
// A scan over the candidates then gives every output:
//   over[j]  = sum_{k>j} S1[k]  + sum_{i=j}^{G-2} (c[i+1] - c[i]) W(>i+1)
//   under[j] = sum_{k<=j} S2[k] + sum_{i=1}^{j}   (c[i] - c[i-1]) W(<i)
// About 20 instructions per nonzero hour instead of ~6 per (hour,
// candidate) pair, so the work is bound by reading f and w once (bytes),
// not by operations.  (The closed form over = sum_{f>c} w f - c sum_{f>c} w
// is cheaper still but cancels: in float32 it misses the tolerance.)
//
// Order-free sums: every term, and every product of the scan, is rounded
// to fixed point at a per-row power of two (weights at 2^sw, the rest at
// 2^s), chosen from the row's largest |w| and the range of its f and
// candidates so that every term stays below 2^31, and summed in int64,
// where T < 2^31 hours cannot overflow.  Sums of integers are exact, so
// the shared-memory atomics may land in any order: a rerun, a batched
// launch and a launch per row block agree bit for bit, and
// ref.commitment_sweep_bucketed_ref reproduces the kernel exactly (every
// float64 step is an explicitly rounded __d*_rn intrinsic, so no fused
// multiply-add moves a bit).  The integer outputs are scaled back in
// float64 and rounded to float32 once.  The int64 sums are kept with two
// 32-bit atomics and a carry: a 64-bit shared-memory atomicAdd is a
// compare-and-swap loop on this card.
//
// Layout: one block of four warps per (row, tile of up to kTile
// candidates); a tile buckets the whole row against its own sorted
// candidates, so any G works.  The tile is sorted in shared memory (a
// stable rank sort) unless it already ascends, and the outputs go back in
// the caller's order.  Two passes over the row, four hours a thread per
// 16-byte load: the first finds the scale (and any non-finite value: such
// a row gives NaN everywhere), the second, from L2, buckets the hours.  A
// bucket is guessed from a uniform grid's spacing (the grid solver's is
// max(f) x linspace(0, 1)) and checked against its two candidates, else
// found by binary search.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;     // candidates per tile (ref.CANDIDATE_TILE)
constexpr int kThreads = 128;  // one block per (row, tile): four warps
constexpr int kWarps = kThreads / 32;
constexpr int kHours = 4 * kThreads;  // hours per step: four per thread
constexpr int kAhead = 3;  // steps of pass 1 whose loads are issued together
constexpr int kTermBits = 31;  // every term below 2^31 (ref.TERM_BITS)
constexpr int kMinShift = -1022, kMaxShift = 1000;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int shift_for(double bound) {
  int e;
  frexp(bound, &e);
  return min(max(kTermBits - e, kMinShift), kMaxShift);
}

// 2^s from its bits (s within the normal range): exact on every device.
__device__ __forceinline__ double pow2(int s) {
  return __longlong_as_double(static_cast<long long>(s + 1023) << 52);
}

__device__ __forceinline__ long long fixed(double x) {
  return __double2ll_rn(x);
}

// A thread's four hours t .. t+3 of a row (16-byte loads where the row
// allows them); hours past T read as w = 0.
__device__ __forceinline__ void load4(const float* frow, const float* wrow,
                                      int t, int T, bool aligned,
                                      float (&fv)[4], float (&wv)[4]) {
  if (aligned && t + 3 < T) {
    const float4 a = *reinterpret_cast<const float4*>(frow + t);
    const float4 b = *reinterpret_cast<const float4*>(wrow + t);
    fv[0] = a.x; fv[1] = a.y; fv[2] = a.z; fv[3] = a.w;
    wv[0] = b.x; wv[1] = b.y; wv[2] = b.z; wv[3] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = t + q < T;
      fv[q] = in ? frow[t + q] : 0.0f;
      wv[q] = in ? wrow[t + q] : 0.0f;
    }
  }
}

// v added to the int64 at `at` with two 32-bit shared-memory atomics (a
// 64-bit one is a compare-and-swap loop on this card): the low words add
// unsigned, and the add that wraps them carries one into the high word.
// Little-endian, the two words are the int64 itself.  Integer adds: the
// sum is exact in any order.
__device__ __forceinline__ void add(long long* at, long long v) {
  unsigned* word = reinterpret_cast<unsigned*>(at);
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned old = atomicAdd(word, lo);
  const unsigned hi = static_cast<unsigned>(v >> 32) + (old + lo < old);
  if (hi != 0) atomicAdd(word + 1, hi);
}

// In-place inclusive scan of a[0..n) by one warp, towards higher indices
// (prefix) or lower ones (suffix).  Lane l owns a contiguous chunk; the
// chunk totals are scanned by shuffles.  Integer sums: any order is exact.
__device__ void warp_scan(long long* a, int n, bool suffix, int lane) {
  __syncwarp();
  const int per = (n + 31) / 32;
  const int b = min(lane * per, n), e = min(b + per, n);
  long long sum = 0;
  for (int i = b; i < e; ++i) sum += a[i];
  long long x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = suffix ? __shfl_down_sync(kFull, x, d)
                               : __shfl_up_sync(kFull, x, d);
    if (suffix ? lane + d < 32 : lane >= d) x += y;
  }
  long long carry = x - sum;  // the lanes before (prefix) or after (suffix)
  if (suffix) {
    for (int i = e - 1; i >= b; --i) { carry += a[i]; a[i] = carry; }
  } else {
    for (int i = b; i < e; ++i) { carry += a[i]; a[i] = carry; }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ f, const float* __restrict__ w,
             const float* __restrict__ cs, float* __restrict__ over,
             float* __restrict__ under, int G, int T) {
  __shared__ float cand[kTile];
  __shared__ unsigned char idx[kTile];
  __shared__ long long bw[kTile + 1];
  __shared__ long long b1[kTile + 1];
  __shared__ long long b2[kTile + 1];
  __shared__ float red[5][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = blockIdx.x;
  const int g0 = blockIdx.y * kTile;
  const int gt = min(kTile, G - g0);
  const float* frow = f + p * T;
  const float* wrow = w + p * T;
  const float* crow = cs + p * G;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(frow) | reinterpret_cast<uintptr_t>(wrow))
       & 15) == 0;

  for (int j = tid; j <= gt; j += kThreads) {
    bw[j] = 0;
    b1[j] = 0;
    b2[j] = 0;
  }
  if (tid < gt) {
    cand[tid] = crow[g0 + tid];
    idx[tid] = static_cast<unsigned char>(tid);
  }

  // Pass 1: the row's scale.  Candidates over all G (every tile of a row
  // must find the same scale), hours with w != 0 for the rest.
  bool bad = false;
  float cmin = CUDART_INF_F, cmax = -CUDART_INF_F;
  for (int g = tid; g < G; g += kThreads) {
    const float c = crow[g];
    bad |= !isfinite(c);
    cmin = fminf(cmin, c);
    cmax = fmaxf(cmax, c);
  }
  float wmax = 0.0f, fmin = CUDART_INF_F, fmax = -CUDART_INF_F;
  auto stats = [&](const float (&fv)[4], const float (&wv)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bad |= !(isfinite(fv[q]) && isfinite(wv[q]));
      if (wv[q] != 0.0f) {
        wmax = fmaxf(wmax, fabsf(wv[q]));
        fmin = fminf(fmin, fv[q]);
        fmax = fmaxf(fmax, fv[q]);
      }
    }
  };
  for (int t0 = 0; t0 < T; t0 += kAhead * kHours) {
    float fv[kAhead][4], wv[kAhead][4];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      load4(frow, wrow, t0 + u * kHours + 4 * tid, T, aligned, fv[u], wv[u]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) stats(fv[u], wv[u]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    wmax = fmaxf(wmax, __shfl_xor_sync(kFull, wmax, d));
    fmin = fminf(fmin, __shfl_xor_sync(kFull, fmin, d));
    fmax = fmaxf(fmax, __shfl_xor_sync(kFull, fmax, d));
    cmin = fminf(cmin, __shfl_xor_sync(kFull, cmin, d));
    cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, d));
  }
  if (lane == 0) {
    red[0][warp] = wmax;
    red[1][warp] = fmin;
    red[2][warp] = fmax;
    red[3][warp] = cmin;
    red[4][warp] = cmax;
  }
  bad = __syncthreads_or(bad);  // also publishes the stores above
  if (bad) {
    for (int j = tid; j < gt; j += kThreads) {
      over[p * G + g0 + j] = CUDART_NAN_F;
      under[p * G + g0 + j] = CUDART_NAN_F;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    wmax = fmaxf(wmax, red[0][i]);
    fmin = fminf(fmin, red[1][i]);
    fmax = fmaxf(fmax, red[2][i]);
    cmin = fminf(cmin, red[3][i]);
    cmax = fmaxf(cmax, red[4][i]);
  }
  const double lo = fminf(fmin, cmin), hi = fmaxf(fmax, cmax);
  const int s = shift_for(__dmul_rn(wmax, __dsub_rn(hi, lo)));
  const int sw = shift_for(wmax);
  const double scale = pow2(s), inv = pow2(-s);
  const double scale_w = pow2(sw), inv_w = pow2(-sw);

  // The tile's candidates, sorted ascending with their columns (a stable
  // rank sort), unless they already ascend.
  const bool asc = __syncthreads_and(tid + 1 >= gt
                                     || cand[tid] <= cand[tid + 1]);
  if (!asc) {
    const float mine = tid < gt ? cand[tid] : 0.0f;
    int rank = 0;
    for (int i = 0; i < gt; ++i) {
      const float c = cand[i];
      rank += (c < mine) || (c == mine && i < tid);
    }
    __syncthreads();
    if (tid < gt) {
      cand[rank] = mine;
      idx[rank] = static_cast<unsigned char>(tid);
    }
    __syncthreads();
  }

  // Pass 2 (the row again, from L2): bucket the hours with w != 0, four
  // hours a thread side by side.  k = #(cand < f) is guessed from a uniform
  // grid's spacing and checked against the two candidates around it, else
  // found by a fixed-step binary search.
  const float c0 = cand[0];
  const float span = cand[gt - 1] - c0;
  const float per_cell = span > 0.0f && isfinite(span) ? (gt - 1) / span
                                                       : 0.0f;
  const int top = 1 << (31 - __clz(gt));
  auto bucket = [&](const float (&fv)[4], const float (&wv)[4]) {
    const bool any = wv[0] != 0.0f || wv[1] != 0.0f || wv[2] != 0.0f
                     || wv[3] != 0.0f;
    if (!__any_sync(kFull, any)) return;
    int k[4];
    bool found = true;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = ceilf((fv[q] - c0) * per_cell);
      k[q] = static_cast<int>(fminf(fmaxf(x, 0.0f), static_cast<float>(gt)));
      found &= wv[q] == 0.0f
               || ((k[q] == 0 || cand[k[q] - 1] < fv[q])
                   && (k[q] == gt || !(cand[k[q]] < fv[q])));
    }
    if (!found) {
#pragma unroll
      for (int q = 0; q < 4; ++q) k[q] = 0;
      for (int step = top; step > 0; step >>= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int at = k[q] + step;
          if (at <= gt && cand[at - 1] < fv[q]) k[q] = at;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (wv[q] == 0.0f) continue;
      const double wd = wv[q], fd = fv[q];
      const int kq = k[q];
      add(&bw[kq], fixed(__dmul_rn(wd, scale_w)));
      if (kq > 0) {
        add(&b1[kq], fixed(__dmul_rn(__dmul_rn(
            __dsub_rn(fd, static_cast<double>(cand[kq - 1])), wd), scale)));
      }
      if (kq < gt) {
        add(&b2[kq], fixed(__dmul_rn(__dmul_rn(
            __dsub_rn(static_cast<double>(cand[kq]), fd), wd), scale)));
      }
    }
  };
  for (int t0 = 0; t0 < T; t0 += kHours) {
    float fv[4], wv[4];
    load4(frow, wrow, t0 + 4 * tid, T, aligned, fv, wv);
    bucket(fv, wv);
  }
  __syncthreads();

  // Scan.  Warp 0 turns bw into W(>=k).  Then warp 0 sets
  //   b1[j] <- S1[j+1] + (c[j+1] - c[j]) W(>=j+2)   (the gap term: j <= gt-2)
  // and sums b1 towards j = 0 (over), while warp 1 sets
  //   b2[j] <- S2[j] + (c[j] - c[j-1]) W(<j)         (the gap term: j >= 1)
  // and sums b2 towards j = gt-1 (under).
  if (warp == 0) warp_scan(bw, gt + 1, true, lane);
  __syncthreads();
  if (warp > 1) return;
  const bool is_over = warp == 0;
  long long* acc = is_over ? b1 : b2;
  const long long total = bw[0];
  long long v[kTile / 32];
#pragma unroll
  for (int q = 0; q < kTile / 32; ++q) {
    const int j = lane + 32 * q;
    v[q] = 0;
    if (j >= gt) continue;
    // the gap between the column and its neighbour above (over) or below
    // (under), times the weight beyond that neighbour
    const int hi_col = is_over ? j + 1 : j;
    const bool has_gap = is_over ? j + 1 < gt : j >= 1;
    v[q] = is_over ? b1[j + 1] : b2[j];
    if (has_gap) {
      const double gap = __dsub_rn(static_cast<double>(cand[hi_col]),
                                   static_cast<double>(cand[hi_col - 1]));
      const long long beyond = is_over ? bw[j + 2] : total - bw[j];
      const double wt = __dmul_rn(__ll2double_rn(beyond), inv_w);
      v[q] += fixed(__dmul_rn(__dmul_rn(gap, wt), scale));
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kTile / 32; ++q) {
    const int j = lane + 32 * q;
    if (j < gt) acc[j] = v[q];
  }
  warp_scan(acc, gt, is_over, lane);
  float* out = is_over ? over : under;
  for (int j = lane; j < gt; j += 32) {
    out[p * G + g0 + idx[j]] =
        __double2float_rn(__dmul_rn(__ll2double_rn(acc[j]), inv));
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
  const dim3 grid(P, (G + kTile - 1) / kTile);
  sweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, w, cs, over, under, G, T);
  return static_cast<int>(cudaGetLastError());
}
