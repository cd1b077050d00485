// Chunk-parallel RWKV6 linear recurrence for Hopper (sm_90a), CUDA C++ with
// a plain C entry point for ctypes.
//
// Per (batch, head), with state S (dk x dv), log-decay logw_t <= 0,
// w_t = exp(logw_t) and bonus u:
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// computed by chunks of L = 32 steps.  Within a chunk, with every decay a
// product of the w_j over a stretch of steps:
//
//   y_t = (r_t * prod_{j<t} w_j) . S_entering                    (inter)
//       + sum_{s<t} [sum_i r_ti k_si prod_{s<j<t} w_ji] v_s        (intra)
//       + (r_t . (u * k_t)) v_t                                   (bonus)
//   S_next = diag(prod_j w_j) S_entering + dS,
//   dS = sum_s (k_s * prod_{j>s} w_j) (x) v_s
//
// Three kernels, launched in turn on one stream by rwkv6_launch:
//
//   rwkv6_chunk_kernel       one block per (chunk, head, batch): the chunk's
//                            intra and bonus terms into y, its dS (all dv
//                            columns) and its total decay into scratch;
//   rwkv6_state_scan_kernel  one thread per 4 elements of a (batch, head)
//                            state, sequential over the chunks: overwrites
//                            each chunk's dS slot with the state entering
//                            that chunk, writes the final state;
//   rwkv6_inter_kernel       one block per (chunk, head, batch):
//                            y += (r * prod_{j<t} w_j) . S_entering.
//
// Stability: every decay is exp(logw) (one exp per step and channel) or a
// product of such factors, each in [0, 1], over a stretch of steps; that
// is the exp of the stretch's logw sum taken directly, so nothing
// overflows however strong the decay, and an underflow to 0 is right (the
// true term is below float32's smallest normal).  The factored
// r*exp(cum) / k*exp(-cum) form would overflow, and decays taken as exp of
// differences of prefix sums from the chunk's start lose digits at the
// model's strongest decays (logw down to -e^10: the prefix sums reach
// ~1e4-1e5, where an ulp is ~1e-3-1e-2 of exponent).
//
// The intra term is cut into sub-chunks of 8 steps.  For a key s in an
// earlier sub-chunk than the query t, with q0 the query sub-chunk's first
// step, prod_{s<j<t} w_j = [prod_{q0<=j<t} w_j] * [prod_{s<j<q0} w_j]: the
// first factor goes with r (rq), the second with k (kq), and the block is a
// plain dot product over channels.  Only the diagonal sub-blocks keep a
// running product per (t, s, channel).  Each thread of the chunk kernel
// holds one sub-chunk of one channel in registers (r, k, exp(logw), read
// straight from device memory); a warp reduces its 36 diagonal (t, s <= t)
// terms over channels with a transposing shuffle reduction (31 shuffles
// for 32 sums), and k's decays to later sub-chunks and to the chunk's end
// are its own sub-chunk's suffix products times the sub-chunk totals in
// between, exchanged through shared memory.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/linrec/linrec.py::rwkv6_kernel (body _rwkv6_kernel),
// which carries the state across its sequential chunk grid axis in VMEM.
//
// Bound: at the serving prefill shape (1, 40, 2048, 64) the chunked form is
// ~2.2 GFLOP against ~105 MB of r, k, v, logw and y, so the card could do
// it in ~0.03 ms either way; what limits a recurrence is parallelism and
// latency.  The previous design walked the 64 chunks in order inside 80
// blocks (dv split in two) for 132 SMs; here 2,560 chunk blocks run at
// once and only the (dk x dv) state scan is sequential, 4 FMAs per chunk
// per thread over 41k threads, each with the next 4 chunks' loads in
// flight.  The design's own cost is the scratch,
// (B, H, C, dk, dv) float32, 42 MB at that shape: dS written by the chunk
// kernel, read and overwritten with the entering states by the scan, read
// by the inter kernel, 168 MB of traffic beside the work's 105 MB (and r
// and logw read twice, y read back once).  Products are float32 FMA
// on the CUDA cores: TF32 tensor cores (10-bit mantissa) over 32- to
// 64-term sums err ~4e-3 at |terms| ~ 1, above the 2e-3 tolerance, and
// the arithmetic is not what limits the kernel.
//
// Layout: r, k, logw, v and y are given by element strides (batch, head,
// time; the channel dim contiguous), so the model's (B, T, H, hs)
// projections are read and y written in place.  u is (H, dk), s0 and s_out
// (B, H, dk, dv), all float32 and contiguous.  A ragged last chunk is
// masked here (its missing steps act as r = k = v = 0, logw = 0), so the
// caller pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 32;                  // chunk length
constexpr int kSub = 8;                 // sub-chunk length
constexpr int kNSub = kL / kSub;
constexpr int kMaxK = 64;               // max dk
constexpr int kMaxV = 64;               // max dv
constexpr int kThreads = 256;
constexpr int kPad = kMaxK + 1;
constexpr int kPairs = kSub * (kSub + 1) / 2;       // (t, s <= t) pairs
constexpr int kQStride = kSub * (kNSub - 1) + 4;    // kq row, 16-byte rows
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == kNSub * kMaxK, "a thread per (sub-chunk, channel)");
static_assert(kMaxK == kMaxV, "16 x 16 threads tile both y and dS");
static_assert(kThreads == kL * kL / 4, "one thread per (row, 4 keys)");
static_assert(kPairs >= 32, "the transposing reduction folds 32 sums");

struct Strides {
  long long b, h, t;
};

struct ChunkSmem {
  float rq[kL][kPad];  // r_t * prod_{q0<=j<t} w_j (q0: t's sub-chunk start)
  float total[kNSub][kMaxK];             // each sub-chunk's prod_j w_j
  alignas(16) float v[kL][kMaxV];
  alignas(16) float kdec[kL][kMaxK];  // k_s * prod_{j>s} w_j
  // kq[Q - 1][i][s] = k_si * prod_{s<j<8Q} w_ji for s < 8Q (query
  // sub-chunk Q >= 1), transposed so four keys load as one float4
  alignas(16) float kq[kNSub - 1][kMaxK][kQStride];
  float att[kL][kL + 1];                 // att[t][s], 0 for s > t
  float part[2][kNSub][kPairs];          // diagonal sums per channel half
};

// One stage of the transposing reduction: lanes L and L ^ N swap halves of
// x[0 .. 2N), each keeping (and summing) the half its bit N selects.
template <int N>
__device__ __forceinline__ void fold(float* x, int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const float send = up ? x[p] : x[p + N];
    const float keep = up ? x[p + N] : x[p];
    x[p] = keep + __shfl_xor_sync(kFull, send, N);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
rwkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u, float* __restrict__ y,
                   float* __restrict__ d_state, float* __restrict__ decay,
                   int H, int T, int dk, int dv, Strides rs, Strides ks,
                   Strides vs, Strides ws, Strides ys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);

  const int c = blockIdx.x;
  const int C = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * kL;
  const int n = min(kL, T - t0);
  const long long bhc = (static_cast<long long>(b) * H + h) * C + c;

  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* wb = lw + b * ws.b + h * ws.h;

  // v for the products below, zero-padded past T and dv.
#pragma unroll 4
  for (int idx = tid; idx < kL * kMaxV; idx += kThreads) {
    const int t = idx / kMaxV, j = idx % kMaxV;
    sm.v[t][j] = (t < n && j < dv) ? vb[(t0 + t) * vs.t + j] : 0.0f;
  }

  // One thread per (sub-chunk q, channel i), its 8 steps in registers
  // (zero-padded past T and dk; padded steps have w = 1).
  const int q = tid / kMaxK, i = tid % kMaxK, lane = tid % 32;
  const int q0 = q * kSub;
  float rr[kSub], kk[kSub], ww[kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int t = q0 + a;
    const long long tt = t0 + t;
    const bool ok = t < n && i < dk;
    rr[a] = ok ? rb[tt * rs.t + i] : 0.0f;
    kk[a] = ok ? kb[tt * ks.t + i] : 0.0f;
    ww[a] = ok ? wb[tt * ws.t + i] : 0.0f;
  }
#pragma unroll
  for (int a = 0; a < kSub; ++a) ww[a] = expf(ww[a]);
  {
    const float ui = i < dk ? u[h * dk + i] : 0.0f;
    // The diagonal sub-block's terms, pair (t, s <= t) at t(t+1)/2 + s:
    // r_t k_s prod_{s<j<t} w_j, and the bonus r_t u k_t at s = t.
    float x[kPairs];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      float dec = 1.0f;
#pragma unroll
      for (int t = s; t < kSub; ++t) {
        const int p = t * (t + 1) / 2 + s;
        if (t == s) {
          x[p] = rr[t] * ui * kk[s];
        } else {
          x[p] = rr[t] * kk[s] * dec;
          dec *= ww[t];
        }
      }
    }
#pragma unroll
    for (int p = 32; p < kPairs; ++p) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x[p] += __shfl_xor_sync(kFull, x[p], off);
      }
    }
    fold<16>(x, lane);
    fold<8>(x, lane);
    fold<4>(x, lane);
    fold<2>(x, lane);
    fold<1>(x, lane);
    const int half = i / 32;
    sm.part[half][q][lane] = x[0];  // lane L now holds pair L's sum
    if (lane == 0) {
#pragma unroll
      for (int p = 32; p < kPairs; ++p) sm.part[half][q][p] = x[p];
    }
  }
  // rq, and k decayed to the end of its own sub-chunk (kk in place).
  float d = 1.0f;
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    sm.rq[q0 + t][i] = rr[t] * d;
    d *= ww[t];
  }
  d = 1.0f;
#pragma unroll
  for (int s = kSub - 1; s >= 0; --s) {
    kk[s] *= d;
    d *= ww[s];
  }
  sm.total[q][i] = d;
  __syncthreads();

  // kdec (to the chunk's end) and kq (to the start of each later query
  // sub-chunk Q): times the totals of the sub-chunks in between.
  {
    float tot[kNSub];
#pragma unroll
    for (int e = 0; e < kNSub; ++e) tot[e] = sm.total[e][i];
    float g = 1.0f;  // prod of the totals of sub-chunks q + 1 .. Q - 1
#pragma unroll
    for (int qq = 1; qq < kNSub; ++qq) {
      if (qq > q) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) sm.kq[qq - 1][i][q0 + s] = kk[s] * g;
        g *= tot[qq];
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) sm.kdec[q0 + s][i] = kk[s] * g;
    if (q == 0 && i < dk) decay[bhc * dk + i] = tot[0] * g;
  }
  __syncthreads();

  // att[t][s]: one thread per (row t, 4 keys s0 .. s0 + 3).
  {
    const int t = tid / 8, s0 = 4 * (tid % 8);
    const int qt = t / kSub, qs = s0 / kSub;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (qs < qt) {
#pragma unroll 8
      for (int i = 0; i < kMaxK; ++i) {
        const float rv = sm.rq[t][i];
        const float4 kv = *reinterpret_cast<const float4*>(
            &sm.kq[qt - 1][i][s0]);
        a[0] = fmaf(rv, kv.x, a[0]);
        a[1] = fmaf(rv, kv.y, a[1]);
        a[2] = fmaf(rv, kv.z, a[2]);
        a[3] = fmaf(rv, kv.w, a[3]);
      }
    } else if (qs == qt) {
      const int lt = t - qt * kSub;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ls = s0 + e - qt * kSub;
        if (ls <= lt) {
          const int p = lt * (lt + 1) / 2 + ls;
          a[e] = sm.part[0][qt][p] + sm.part[1][qt][p];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sm.att[t][s0 + e] = a[e];
  }
  __syncthreads();

  // y (intra + bonus) for rows t, t + 16 and columns 4jq .. 4jq + 3, and dS
  // for rows 4iq .. 4iq + 3 and the same columns.
  {
    const int hi = tid / 16, jq = tid % 16, j0 = 4 * jq;
    float acc[2][4] = {};
    float ds[4][4] = {};
#pragma unroll 4
    for (int s = 0; s < kL; ++s) {
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[s][j0]);
      const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
      const float a0 = sm.att[hi][s], a1 = sm.att[hi + 16][s];
      const float4 kd = *reinterpret_cast<const float4*>(&sm.kdec[s][4 * hi]);
      const float ki[4] = {kd.x, kd.y, kd.z, kd.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][e] = fmaf(a0, vj[e], acc[0][e]);
        acc[1][e] = fmaf(a1, vj[e], acc[1][e]);
#pragma unroll
        for (int m = 0; m < 4; ++m) ds[m][e] = fmaf(ki[m], vj[e], ds[m][e]);
      }
    }
    float* yb = y + b * ys.b + h * ys.h;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int t = hi + 16 * m;
      if (t >= n) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j0 + e < dv) yb[(t0 + t) * ys.t + j0 + e] = acc[m][e];
      }
    }
    float* db = d_state + bhc * dk * dv;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 4 * hi + m;
      if (i >= dk) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j0 + e < dv) db[i * dv + j0 + e] = ds[m][e];
      }
    }
  }
}

// S_c = decay_c * S_{c-1} + dS_c over the chunks, 4 state elements of one
// row per thread; each dS slot is overwritten with the state entering its
// chunk.  The next kAhead chunks' loads are issued before this group's
// stores and FMAs, so each thread keeps up to 2 * kAhead 16-byte loads in
// flight and the chain of dependent FMAs does not wait on memory.
__global__ void __launch_bounds__(kThreads)
rwkv6_state_scan_kernel(const float* __restrict__ s0,
                        float* __restrict__ s_out,
                        float* __restrict__ d_state,
                        const float* __restrict__ decay, long long BH, int C,
                        int dk, int dv) {
  constexpr int kAhead = 4;
  const long long elems = static_cast<long long>(dk) * dv;
  const long long g = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) * 4;
  if (g >= BH * elems) return;
  const long long bh = g / elems;
  const long long e = g % elems;
  float4* ds = reinterpret_cast<float4*>(d_state + bh * C * elems + e);
  const long long step = elems / 4;  // one chunk's slot, in float4
  const float* dc = decay + bh * C * dk + e / dv;
  float4 s = *reinterpret_cast<const float4*>(s0 + g);
  float4 nxt[kAhead];
  float nmul[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    if (a < C) {
      nxt[a] = __ldcg(ds + a * step);
      nmul[a] = dc[static_cast<long long>(a) * dk];
    }
  }
  for (int c0 = 0; c0 < C; c0 += kAhead) {
    float4 add[kAhead];
    float mul[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      add[a] = nxt[a];
      mul[a] = nmul[a];
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int cn = c0 + kAhead + a;
      if (cn < C) {
        nxt[a] = __ldcg(ds + cn * step);
        nmul[a] = dc[static_cast<long long>(cn) * dk];
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (c0 + a < C) {
        ds[(c0 + a) * step] = s;
        s.x = fmaf(mul[a], s.x, add[a].x);
        s.y = fmaf(mul[a], s.y, add[a].y);
        s.z = fmaf(mul[a], s.z, add[a].z);
        s.w = fmaf(mul[a], s.w, add[a].w);
      }
    }
  }
  *reinterpret_cast<float4*>(s_out + g) = s;
}

// y += (r_t * prod_{j<t} w_j) . S_entering, one block per chunk.
__global__ void __launch_bounds__(kThreads)
rwkv6_inter_kernel(const float* __restrict__ r, const float* __restrict__ lw,
                   const float* __restrict__ entering, float* __restrict__ y,
                   int H, int T, int dk, int dv, Strides rs, Strides ws,
                   Strides ys) {
  __shared__ __align__(16) float rdec[kL][kMaxK];
  __shared__ __align__(16) float st[kMaxK][kMaxV];
  __shared__ float seg[kNSub][kMaxK];

  const int c = blockIdx.x;
  const int C = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * kL;
  const int n = min(kL, T - t0);
  const long long bhc = (static_cast<long long>(b) * H + h) * C + c;

  const float* sb = entering + bhc * dk * dv;
  for (int idx = tid; idx < kMaxK * kMaxV; idx += kThreads) {
    const int i = idx / kMaxV, j = idx % kMaxV;
    st[i][j] = (i < dk && j < dv) ? sb[i * dv + j] : 0.0f;
  }

  // One thread per (8-step segment, channel): r times the decay from the
  // segment's start, then times the earlier segments' decays.
  const int g = tid / kMaxK, i = tid % kMaxK;
  {
    const float* rb = r + b * rs.b + h * rs.h;
    const float* wb = lw + b * ws.b + h * ws.h;
    float rv[kSub], wv[kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int t = g * kSub + a;
      const long long tt = t0 + t;
      const bool ok = t < n && i < dk;
      rv[a] = ok ? rb[tt * rs.t + i] : 0.0f;
      wv[a] = ok ? wb[tt * ws.t + i] : 0.0f;
    }
    float a = 1.0f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      rdec[g * kSub + t][i] = rv[t] * a;
      a *= expf(wv[t]);
    }
    seg[g][i] = a;
  }
  __syncthreads();
  {
    float f = 1.0f;
    for (int e = 0; e < g; ++e) f *= seg[e][i];
#pragma unroll
    for (int t = 0; t < kSub; ++t) rdec[g * kSub + t][i] *= f;
  }
  __syncthreads();

  const int hi = tid / 16, j0 = 4 * (tid % 16);
  float acc[2][4] = {};
#pragma unroll 8
  for (int ii = 0; ii < kMaxK; ++ii) {
    const float4 sv = *reinterpret_cast<const float4*>(&st[ii][j0]);
    const float a0 = rdec[hi][ii], a1 = rdec[hi + 16][ii];
    acc[0][0] = fmaf(a0, sv.x, acc[0][0]);
    acc[0][1] = fmaf(a0, sv.y, acc[0][1]);
    acc[0][2] = fmaf(a0, sv.z, acc[0][2]);
    acc[0][3] = fmaf(a0, sv.w, acc[0][3]);
    acc[1][0] = fmaf(a1, sv.x, acc[1][0]);
    acc[1][1] = fmaf(a1, sv.y, acc[1][1]);
    acc[1][2] = fmaf(a1, sv.z, acc[1][2]);
    acc[1][3] = fmaf(a1, sv.w, acc[1][3]);
  }
  float* yb = y + b * ys.b + h * ys.h;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int t = hi + 16 * m;
    if (t >= n) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j0 + e < dv) yb[(t0 + t) * ys.t + j0 + e] += acc[m][e];
    }
  }
}

}  // namespace

// r, k, logw (B, H, T, dk), v and y (B, H, T, dv), each given by element
// strides {batch, head, time} in `strides` (15 int64 on the host: r, k, v,
// logw, y), channels contiguous; u (H, dk); s0, s_out (B, H, dk, dv); all
// float32.  dk <= 64; dv <= 64 and a multiple of 4; s0, s_out and d_state
// 16-byte aligned (the scan moves 4 floats at a time).  Scratch, float32,
// C = ceil(T / 32) chunks:
// d_state (B, H, C, dk, dv), which ends holding the state entering each
// chunk, and decay (B, H, C, dk).  Launches the three kernels on `stream`
// and returns the first CUDA error as an int.
extern "C" int rwkv6_launch(const float* r, const float* k, const float* v,
                            const float* logw, const float* u,
                            const float* s0, float* y, float* s_out,
                            float* d_state, float* decay, int B, int H, int T,
                            int dk, int dv, const long long* strides,
                            void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || dk <= 0 || dk > kMaxK || dv <= 0 ||
      dv > kMaxV || dv % 4 != 0 || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(s0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s_out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_state) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides rs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides ws{strides[9], strides[10], strides[11]};
  const Strides ys{strides[12], strides[13], strides[14]};
  const int C = (T + kL - 1) / kL;
  cudaError_t err;
  if (C > 0) {
    // The shared-memory opt-in is a per-device attribute of the kernel:
    // set it at the first launch on each device.
    static bool smem_set[kMaxDevices] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!smem_set[dev]) {
      err = cudaFuncSetAttribute(rwkv6_chunk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(ChunkSmem)));
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[dev] = true;
    }
    const dim3 grid(C, H, B);
    rwkv6_chunk_kernel<<<grid, kThreads, sizeof(ChunkSmem), st>>>(
        r, k, v, logw, u, y, d_state, decay, H, T, dk, dv, rs, ks, vs, ws,
        ys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long BH = static_cast<long long>(B) * H;
  const long long elems = BH * dk * dv;
  rwkv6_state_scan_kernel<<<static_cast<unsigned>(
      (elems / 4 + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      s0, s_out, d_state, decay, BH, C, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess || C == 0) return static_cast<int>(err);
  const dim3 grid(C, H, B);
  rwkv6_inter_kernel<<<grid, kThreads, 0, st>>>(r, logw, d_state, y, H, T,
                                                dk, dv, rs, ws, ys);
  return static_cast<int>(cudaGetLastError());
}
