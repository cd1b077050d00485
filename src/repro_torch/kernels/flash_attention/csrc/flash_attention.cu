// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// entry point for ctypes.
//
//   o[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / group, j, :]
//                             masked) @ v[b, h / group, :, :]
//
// masked: column j is dropped when j >= kv_len[b], and, when causal, when
// j > kv_len[b] - Sq + i (the queries are the last Sq positions of a
// context of kv_len[b] tokens).  kv_len is a (B,) int32 device array, so one
// launch serves a batched decode in which every slot has its own fill
// level.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (body _flash_kernel), which walks the KV blocks on its sequential
// innermost grid axis and carries (m, l, acc) across them in VMEM.  Hopper's
// blocks run in no order, so the KV loop moves inside the block and
// (m, l, acc) live in registers.
//
// Routing: this SIMT kernel serves what the two Hopper kernels beside it
// do not take: float32 prefill (the reduced float32 models, whose 2e-5
// tolerance bf16 tensor cores cannot meet) and bf16 with head dim 32.
// bf16 prefill at head dim 64/128 goes to flash_prefill_tc.cu and every
// one-query decode to flash_decode_split.cu (flash_attention.py::route).
//
// Bound: a prefill call of (1, 32, 2048, 64) causal is 17.2 GFLOP of
// products against 33.6 MB of q, k, v and o in bf16 (67 MB in float32),
// so operations bound it.  This kernel computes on the CUDA cores in
// float32, so it runs far from the bf16 tensor-core bound and within
// reach of the 67 TFLOP/s float32 one; the design keeps K/V traffic to
// one read of each tile per block of 16 query rows and skips tiles past
// the causal diagonal and past kv_len.
//
// Design: one block of 4 warps per (16 query rows, q head, batch row).  The
// block stages the scaled query rows and, tile by tile, 32 keys and values
// in shared memory as float32.  Each warp owns 4 query rows; lane j scores
// key j of the tile for all 4 rows, the warp reduces the tile's row max and
// sum with shuffles, and lane d accumulates output dims d, d + 32, ... with
// the online-softmax rescale.  GQA reads kv head h / group; no K/V copy is
// made.  Layouts are given by element strides (batch, head, seq; the head
// dim is contiguous), so the model's (B, S, H, D) cache is read in place.
// Ragged Sq and Skv edges are masked here: the caller pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per tile (one per lane)
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int* __restrict__ kv_len, int Hq, int Hkv, int Sq,
             int Skv, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, int causal) {
  constexpr int kDimsPerLane = D / 32;
  __shared__ float qsm[kRows][D];
  __shared__ float ksm[kKeys][D + 1];  // +1: lanes read rows, no conflicts
  __shared__ float vsm[kKeys][D];
  __shared__ float psm[kWarps][kRowsPerWarp][kKeys];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int len = min(kv_len[b], Skv);
  const int row_offset = kv_len[b] - Sq;  // position of query row 0

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = q0 + r;
    qsm[r][d] = i < Sq ? scale * to_float(qb[i * qs.s + d]) : 0.0f;
  }

  // Keys this block needs: below kv_len and, when causal, up to the last
  // valid query row's position (the causal block skip).
  int kv_end = len;
  if (causal) {
    const int last_row = min(q0 + kRows, Sq) - 1;
    kv_end = min(kv_end, row_offset + last_row + 1);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) acc[rr][dd] = 0.0f;
  }

  for (int c0 = 0; c0 < kv_end; c0 += kKeys) {
    __syncthreads();  // previous tile fully read (and qsm written)
    for (int idx = threadIdx.x; idx < kKeys * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int col = c0 + j;
      const bool ok = col < kv_end;
      ksm[j][d] = ok ? to_float(kb[col * ks.s + d]) : 0.0f;
      vsm[j][d] = ok ? to_float(vb[col * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    const int col = c0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ksm[lane][d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        s[rr] = fmaf(qsm[warp * kRowsPerWarp + rr][d], kd, s[rr]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int i = q0 + warp * kRowsPerWarp + rr;
      bool valid = col < kv_end && i < Sq;
      if (causal) valid = valid && col <= row_offset + i;
      const float sv = valid ? s[rr] : -INFINITY;
      float tmax = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      }
      const float m_new = fmaxf(m[rr], tmax);
      float p = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {  // some key of this row is valid so far
        p = valid ? expf(sv - m_new) : 0.0f;
        alpha = expf(m[rr] - m_new);  // 0 when m[rr] is still -inf
      }
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      l[rr] = alpha * l[rr] + psum;
      m[rr] = m_new;
      psm[warp][rr][lane] = p;
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) acc[rr][dd] *= alpha;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const float vj = vsm[j][lane + 32 * dd];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          acc[rr][dd] = fmaf(psm[warp][rr][j], vj, acc[rr][dd]);
        }
      }
    }
    __syncwarp();
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp * kRowsPerWarp + rr;
    if (i >= Sq) continue;
    const float inv = l[rr] > 0.0f ? 1.0f / l[rr] : 0.0f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      store(ob + i * os.s + lane + 32 * dd, acc[rr][dd] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_len, int B, int Hq, int Hkv, int Sq, int Skv,
           const long long* strides, float scale, int causal,
           cudaStream_t stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_len, Hq, Hkv, Sq, Skv,
      qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             const int* kv_len, int B, int Hq, int Hkv, int Sq, int Skv,
             const long long* strides, float scale, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, kv_len, B, Hq, Hkv, Sq, Skv, strides,
                           scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, kv_len, B, Hq, Hkv, Sq, Skv, strides,
                           scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, kv_len, B, Hq, Hkv, Sq, Skv, strides,
                            scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q, each given by its
// element strides {batch, head, seq} in `strides` (12 int64 on the host:
// q, k, v, o), the head dim contiguous; dtype 0 = float32, 1 = bfloat16 for
// all four.  kv_len: (B,) int32 on the device.  D in {32, 64, 128}.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int* kv_len, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      const long long* strides, float scale,
                                      int causal, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || B > 65535 || Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(D, q, k, v, o, kv_len, B, Hq, Hkv, Sq, Skv,
                           strides, scale, causal, s);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(D, q, k, v, o, kv_len, B, Hq, Hkv, Sq,
                                   Skv, strides, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
