// Chunked RWKV6 linear recurrence for Hopper (sm_90a), CUDA C++ with a
// plain C entry point for ctypes.
//
// Per (batch, head), with state S (dk x dv), log-decay logw_t <= 0 and
// bonus u:
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//
// computed by chunks of L = 32 steps.  With cum_t the inclusive sum of
// logw over the chunk and cp_t = cum_t - logw_t:
//
//   y_t = (r_t * exp(cp_t)) . S_0
//       + sum_{s<t} [sum_i r_ti k_si exp(cp_ti - cum_si)] v_s
//       + (r_t . (u * k_t)) v_t
//   S_L = diag(exp(cum_L)) S_0 + sum_s (k_s * exp(cum_L - cum_s)) (x) v_s
//
// Every exponent is a sum of logw over a stretch of steps, so it is <= 0
// and no exp overflows, however strong the decay: the factored
// r*exp(cum) / k*exp(-cum) form would overflow float32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/linrec/linrec.py::rwkv6_kernel (body _rwkv6_kernel),
// which carries the state across its sequential chunk grid axis in VMEM.
// Here the chunk loop runs inside the block and the state stays in shared
// memory.
//
// Bound: at the serving prefill shape (1, 40, 2048, 64) the chunked form is
// ~2.2 GFLOP (a third of it the (L, L, dk) decay sum and its exps) against
// ~105 MB of r, k, v, logw and y, so the card could do it in ~0.03 ms
// either way; what limits this kernel is parallelism and latency.  One
// block per (batch, head) would give 40 blocks for 132 SMs, so the dv
// columns of the state, which are independent, are split over blocks of
// 32 columns: 80 blocks at that shape.  Each block recomputes the chunk's
// (L, L) decay matrix, which costs the split's extra exps and nothing in
// bytes.
//
// Layout: r, k, logw, v and y are given by element strides (batch, head,
// time; the channel dim contiguous), so the model's (B, T, H, hs)
// projections are read and y written in place.  u is (H, dk), s0 and s_out
// (B, H, dk, dv), all float32 and contiguous.  A ragged last chunk is
// masked here (its missing steps act as r = k = v = 0, logw = 0), so the
// caller pads nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;        // chunk length
constexpr int kMaxK = 64;     // max dk
constexpr int kCols = 32;     // dv columns per block
constexpr int kThreads = 256;
constexpr int kPad = kMaxK + 1;

struct Strides {
  long long b, h, t;
};

struct Smem {
  float r[kL][kPad];
  float k[kL][kPad];
  float cum[kL][kPad];   // inclusive log-decay sums
  float cp[kL][kPad];    // exclusive (cum - logw)
  float rdec[kL][kPad];  // r * exp(cp)
  float kdec[kL][kPad];  // k * exp(cum_L - cum)
  float v[kL][kCols];
  float att[kL][kL + 1];
  float diag[kL];
  float s[kMaxK][kCols];
};

__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ lw,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ s_out, int H, int T,
             int dk, int dv, Strides rs, Strides ks, Strides vs, Strides ws,
             Strides ys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * kCols;
  const int nc = min(kCols, dv - j0);
  const int tid = threadIdx.x;

  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* wb = lw + b * ws.b + h * ws.h;
  float* yb = y + b * ys.b + h * ys.h;
  const float* ub = u + static_cast<long long>(h) * dk;
  const long long sbase = (static_cast<long long>(b) * H + h) * dk * dv;

  for (int idx = tid; idx < dk * kCols; idx += kThreads) {
    const int i = idx / kCols, j = idx % kCols;
    sm.s[i][j] = j < nc ? s0[sbase + i * dv + j0 + j] : 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += kL) {
    const int n = min(kL, T - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < kL * dk; idx += kThreads) {
      const int t = idx / dk, i = idx % dk;
      const bool ok = t < n;
      const long long tt = t0 + t;
      sm.r[t][i] = ok ? rb[tt * rs.t + i] : 0.0f;
      sm.k[t][i] = ok ? kb[tt * ks.t + i] : 0.0f;
      sm.cp[t][i] = ok ? wb[tt * ws.t + i] : 0.0f;  // logw for now
    }
    for (int idx = tid; idx < kL * kCols; idx += kThreads) {
      const int t = idx / kCols, j = idx % kCols;
      sm.v[t][j] = (t < n && j < nc) ? vb[(t0 + t) * vs.t + j0 + j] : 0.0f;
    }
    __syncthreads();

    // Inclusive cumsum over the chunk, one thread per channel.
    if (tid < dk) {
      float c = 0.0f;
      for (int t = 0; t < kL; ++t) {
        const float w = sm.cp[t][tid];
        c += w;
        sm.cum[t][tid] = c;
        sm.cp[t][tid] = c - w;
      }
    }
    __syncthreads();

    // Decayed r and k, and the current-token bonus.
    for (int idx = tid; idx < kL * dk; idx += kThreads) {
      const int t = idx / dk, i = idx % dk;
      sm.rdec[t][i] = sm.r[t][i] * expf(sm.cp[t][i]);
      sm.kdec[t][i] = sm.k[t][i] * expf(sm.cum[kL - 1][i] - sm.cum[t][i]);
    }
    if (tid < kL) {
      float d = 0.0f;
      for (int i = 0; i < dk; ++i) d += sm.r[tid][i] * ub[i] * sm.k[tid][i];
      sm.diag[tid] = d;
    }
    // Intra-chunk scores att[t][s] = sum_i r_ti k_si exp(cp_ti - cum_si),
    // s < t (strictly causal).
    for (int idx = tid; idx < kL * kL; idx += kThreads) {
      const int t = idx / kL, s = idx % kL;
      float a = 0.0f;
      if (s < t) {
        for (int i = 0; i < dk; ++i) {
          a += sm.r[t][i] * sm.k[s][i] * expf(sm.cp[t][i] - sm.cum[s][i]);
        }
      }
      sm.att[t][s] = a;
    }
    __syncthreads();

    // y for this block's columns.
    for (int idx = tid; idx < kL * kCols; idx += kThreads) {
      const int t = idx / kCols, j = idx % kCols;
      float a = 0.0f;
      for (int i = 0; i < dk; ++i) a = fmaf(sm.rdec[t][i], sm.s[i][j], a);
      for (int s = 0; s < t; ++s) a = fmaf(sm.att[t][s], sm.v[s][j], a);
      a = fmaf(sm.diag[t], sm.v[t][j], a);
      if (t < n && j < nc) yb[(t0 + t) * ys.t + j0 + j] = a;
    }
    __syncthreads();

    // State carried to the next chunk.
    for (int idx = tid; idx < dk * kCols; idx += kThreads) {
      const int i = idx / kCols, j = idx % kCols;
      float a = expf(sm.cum[kL - 1][i]) * sm.s[i][j];
      for (int s = 0; s < kL; ++s) a = fmaf(sm.kdec[s][i], sm.v[s][j], a);
      sm.s[i][j] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < dk * kCols; idx += kThreads) {
    const int i = idx / kCols, j = idx % kCols;
    if (j < nc) s_out[sbase + i * dv + j0 + j] = sm.s[i][j];
  }
}

}  // namespace

// r, k, logw (B, H, T, dk), v and y (B, H, T, dv), each given by element
// strides {batch, head, time} in `strides` (15 int64 on the host: r, k, v,
// logw, y), channels contiguous; u (H, dk); s0, s_out (B, H, dk, dv); all
// float32.  dk <= 64.  Launches on `stream` and returns cudaGetLastError()
// as an int.
extern "C" int rwkv6_launch(const float* r, const float* k, const float* v,
                            const float* logw, const float* u,
                            const float* s0, float* y, float* s_out, int B,
                            int H, int T, int dk, int dv,
                            const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || dk <= 0 || dk > kMaxK || dv <= 0 ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides rs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides ws{strides[9], strides[10], strides[11]};
  const Strides ys{strides[12], strides[13], strides[14]};
  const dim3 grid((dv + kCols - 1) / kCols, H, B);
  rwkv6_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, logw, u, s0, y, s_out, H, T, dk, dv, rs, ks, vs, ws, ys);
  return static_cast<int>(cudaGetLastError());
}
