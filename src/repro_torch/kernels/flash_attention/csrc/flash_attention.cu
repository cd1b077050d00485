// Flash attention forward on the CUDA cores for Hopper (sm_90a), CUDA C++
// with a plain C entry point for ctypes.
//
//   o[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / group, j, :]
//                             masked) @ v[b, h / group, :, :]
//
// q and k have head dim DQK, v and o head dim DV: (32, 32), (64, 64),
// (128, 128), and MLA's prefill pairs (192, 128) and (96, 64).
//
// masked: column j is dropped when j >= kv_len[b], and, when causal, when
// j > kv_len[b] - Sq + i (the queries are the last Sq positions of a
// context of kv_len[b] tokens).  kv_len is a (B,) int32 device array.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (body _flash_kernel), which walks the KV blocks on its sequential
// innermost grid axis and carries (m, l, acc) across them in VMEM.  Hopper's
// blocks run in no order, so the KV loop moves inside the block and
// (m, l, acc) live in registers.
//
// Routing: this kernel serves what the two Hopper kernels beside it do not
// take: float32 prefill (the reduced float32 models, whose atol 2e-5 /
// rtol 1e-4 tolerance neither bf16 nor TF32 tensor cores meet) and bf16
// with head dim 32.  bf16 prefill at the other pairs goes to
// flash_prefill_tc.cu and every one-query decode with DQK = DV to
// flash_decode_split.cu (flash_attention.py::route).
//
// Bound: a float32 prefill call of (1, 32, 2048, 64) causal is 17.2 GFLOP
// of products against 67 MB of q, k, v and o, so operations bound it: 0.26
// ms at the 67 TFLOP/s float32 rate of the CUDA cores.  A design that
// feeds each FMA from shared memory is held below that: an SM's shared
// memory serves one 128-byte wavefront a clock against four warp-wide FMAs,
// so with 5 loads per 4 FMAs (the previous design: one key per lane, four
// query rows broadcast) it stalls at ~1/5 of the FMA rate.  Here a warp's
// 16-byte load moves 512 bytes, up to 4 wavefronts, so 12 of them per 128
// FMAs (S) or 3 per 32 (P V) can still cap the FMA rate near 2/3; an 8 x 8
// micro-tile would halve the loads but needs ~250 registers, which leaves
// too few warps per SM (it ran slower).
//
// Design: a register-tiled SGEMM inside the online softmax.  One block of
// 128 threads per (64 query rows, q head, batch row); K/V tiles of 64 keys.
// The scaled query tile stays in shared memory; K and V tiles go through a
// 2-stage cp.async ring, so the next tile loads while this one computes
// (at DQK = 192 two stages do not fit in 227 KB: one stage, loaded after
// each tile is done).
// Thread (row group g = tid / 8, column group c = tid % 8) holds a 4 x 8
// score micro-tile (rows 4g .. 4g + 3, keys c + 8n) and a 4 x D/8 output
// micro-tile (dims 4c + 32m .. + 3 of DV) in registers.  S = Q K^T reads
// Q and K as float4 along the head dim: 12 loads per 128 FMAs.  A row's max and sum
// are shuffles among the 8 threads of its row group.  P goes through shared
// memory once per tile, transposed, so O += P V reads 4 rows of P and 4
// dims of V per float4: (1 + D/32) loads per 4 x D/8 FMAs, 3 per 32 at
// D = 64.  Rows are padded by 16 bytes, so the 8 rows a quarter-warp reads
// fall on 8 different groups of banks.  Scores are in log2 units (q is
// pre-scaled by scale * log2(e)), so each probability is one exp2f.
// Causal blocks skip the tiles past the diagonal, and the grid hands out
// the row blocks with the most tiles first.  GQA reads kv head h / group;
// no K/V copy is made.  Layouts are given by element strides (batch, head,
// seq; the head dim contiguous), so the model's (B, S, H, D) cache is read
// in place; q, k and v must be 16-byte aligned with strides that are
// multiples of 16 bytes (the wrapper checks).  Ragged Sq and Skv edges are
// masked here (rows past kv_end load as zeros): the caller pads nothing.
// bf16 tiles are converted to float32 as they are stored, with plain loads
// (no cp.async, so no overlap; bf16 D = 32 is a minor route).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int kThreads = 128;  // 16 row groups (4 rows) x 8 column groups
constexpr int kPStride = kRows + 4;  // P^T row, 16-byte pad
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kRows == kKeys, "one tile loader for Q, K and V");

struct Strides {
  long long b, h, s;
};

// Shared memory in floats: Q tile, K and V rings of kStages stages (2,
// or 1 where 2 do not fit), P^T.
template <int DQK, int DV>
struct Smem {
  static constexpr int kQKStride = DQK + 4;  // row of Q or K, 16-byte pad
  static constexpr int kVStride = DV + 4;    // row of V
  static constexpr int kQKTile = kKeys * kQKStride;
  static constexpr int kVTile = kKeys * kVStride;
  static constexpr int kFloats2 =
      3 * kQKTile + 2 * kVTile + kKeys * kPStride;  // with 2 stages
  static constexpr int kStages = kFloats2 * 4 <= kSmemMax ? 2 : 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQKTile;
  static constexpr int kV = kK + kStages * kQKTile;
  static constexpr int kP = kV + kStages * kVTile;
  static constexpr int kBytes = (kP + kKeys * kPStride) * 4;
  static_assert(kBytes <= kSmemMax, "one stage must fit");
};

// 16 bytes of T as floats.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A tile of 64 rows x D from rows row0 .. of `base` (element stride
// `stride`), rows at or past `valid` as zeros, times `mul`, stored as
// float32 rows of SD floats with plain loads.
template <typename T, int D, int SD>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride, int row0,
                                          int valid, float mul) {
  constexpr int kVec = Pack<T>::N, kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < kKeys * kPerRow; idx += kThreads) {
    const int row = idx / kPerRow, c = (idx % kPerRow) * kVec;
    float f[kVec];
    if (row < valid) {
      Pack<T>::unpack(*reinterpret_cast<const uint4*>(
                          base + (row0 + row) * stride + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      store4(dst + row * SD + c + e, mul * f[e],
             mul * f[e + 1], mul * f[e + 2], mul * f[e + 3]);
    }
  }
}

// The same for a float32 K or V tile, through cp.async (zeros past
// `valid`, reading nothing there).
template <int D, int SD>
__device__ __forceinline__ void load_tile_async(float* dst, const float* base,
                                                long long stride, int row0,
                                                int valid) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kKeys * kPerRow; idx += kThreads) {
    const int row = idx / kPerRow, c = (idx % kPerRow) * 4;
    const bool ok = row < valid;
    cp_async16(dst + row * SD + c,
               ok ? base + (row0 + row) * stride + c : base, ok);
  }
}

template <typename T, int DQK, int DV>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const T* kb,
                                        const T* vb, long long kstride,
                                        long long vstride, int c0,
                                        int valid) {
  using L = Smem<DQK, DV>;
  if constexpr (std::is_same<T, float>::value) {
    load_tile_async<DQK, L::kQKStride>(ks, kb, kstride, c0, valid);
    load_tile_async<DV, L::kVStride>(vs, vb, vstride, c0, valid);
  } else {
    load_tile<T, DQK, L::kQKStride>(ks, kb, kstride, c0, valid, 1.0f);
    load_tile<T, DV, L::kVStride>(vs, vb, vstride, c0, valid, 1.0f);
  }
  cp_async_commit();  // an empty group for bf16
}


template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int* __restrict__ kv_len, int Hq, int Hkv, int Sq,
                  int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale_log2, int causal) {
  using L = Smem<DQK, DV>;
  constexpr int kStages = L::kStages;
  constexpr int kDims = DV / 8;   // output dims per thread
  constexpr int kDV = DV / 32;    // their float4 groups
  extern __shared__ __align__(16) float smem[];
  float* qsm = smem + L::kQ;
  float* psm = smem + L::kP;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int g = threadIdx.x / 8;  // row group: rows 4g .. 4g + 3
  const int c = threadIdx.x % 8;  // column group: keys c + 8n, dims 4c + 32m

  const int len = min(kv_len[b], Skv);
  const int row_offset = kv_len[b] - Sq;  // position of query row 0

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // Keys this block needs: below kv_len and, when causal, up to the last
  // valid query row's position (the causal block skip).
  int kv_end = len;
  if (causal) {
    const int last_row = min(q0 + kRows, Sq) - 1;
    kv_end = min(kv_end, row_offset + last_row + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kKeys - 1) / kKeys : 0;

  load_tile<T, DQK, L::kQKStride>(qsm, qb, qs.s, q0, Sq - q0, scale_log2);
  if (n_tiles > 0) {
    load_kv<T, DQK, DV>(smem + L::kK, smem + L::kV, kb, vb, ks.s, vs.s, 0,
                        min(kKeys, kv_end));
  }

  float m[4], l[4], acc[4][kDims];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[rr][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int c0 = it * kKeys;
    if (kStages == 2 && it + 1 < n_tiles) {
      // The stage it overwrites was last read in tile it - 1, which every
      // thread has finished (the barrier at the end of the loop).
      const int c1 = c0 + kKeys;
      load_kv<T, DQK, DV>(smem + L::kK + (1 - st) * L::kQKTile,
                          smem + L::kV + (1 - st) * L::kVTile, kb, vb, ks.s,
                          vs.s, c1, min(kKeys, kv_end - c1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ksm = smem + L::kK + st * L::kQKTile;
    const float* vsm = smem + L::kV + st * L::kVTile;

    // S = Q K^T for rows 4g + rr and keys c + 8n.
    float s[4][8];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int n = 0; n < 8; ++n) s[rr][n] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < DQK; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        qv[rr] = *reinterpret_cast<const float4*>(
            qsm + (4 * g + rr) * L::kQKStride + d);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        kv[n] = *reinterpret_cast<const float4*>(
            ksm + (c + 8 * n) * L::kQKStride + d);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float a = s[rr][n];
          a = fmaf(qv[rr].x, kv[n].x, a);
          a = fmaf(qv[rr].y, kv[n].y, a);
          a = fmaf(qv[rr].z, kv[n].z, a);
          a = fmaf(qv[rr].w, kv[n].w, a);
          s[rr][n] = a;
        }
      }
    }

    // Mask the tile where some key is past kv_len or past a row's
    // causal limit (the block's first row has the tightest one).
    const bool edge = c0 + kKeys > len ||
                      (causal && c0 + kKeys - 1 > row_offset + q0);
    if (edge) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int limit = causal ? min(len - 1, row_offset + q0 + 4 * g + rr)
                                 : len - 1;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (c0 + c + 8 * n > limit) s[rr][n] = -INFINITY;
        }
      }
    }

    // Online softmax; each row's 64 scores lie on the 8 threads of its
    // row group (lanes differing in bits 0-2).
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float mx = s[rr][0];
#pragma unroll
      for (int n = 1; n < 8; ++n) mx = fmaxf(mx, s[rr][n]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[rr], mx);
      float alpha = 1.0f, psum = 0.0f;
      if (m_new == -INFINITY) {  // no valid key for this row so far
#pragma unroll
        for (int n = 0; n < 8; ++n) s[rr][n] = 0.0f;
      } else {
        alpha = exp2f(m[rr] - m_new);  // 0 while m[rr] is still -inf
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[rr][n] = exp2f(s[rr][n] - m_new);
          psum += s[rr][n];
        }
      }
      psum += __shfl_xor_sync(kFull, psum, 1);
      psum += __shfl_xor_sync(kFull, psum, 2);
      psum += __shfl_xor_sync(kFull, psum, 4);
      l[rr] = fmaf(alpha, l[rr], psum);
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[rr][e] *= alpha;
    }

    // P^T: this row group's 4 rows of every key, read back only by this
    // row group's 8 threads (one warp).
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store4(psm + (c + 8 * n) * kPStride + 4 * g, s[0][n], s[1][n],
             s[2][n], s[3][n]);
    }
    __syncwarp();

    // O += P V for rows 4g + rr and dims 4c + 32m + e.
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(
          psm + j * kPStride + 4 * g);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int mm = 0; mm < kDV; ++mm) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vsm + j * L::kVStride + 4 * c + 32 * mm);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          acc[rr][4 * mm + 0] = fmaf(pr[rr], vv.x, acc[rr][4 * mm + 0]);
          acc[rr][4 * mm + 1] = fmaf(pr[rr], vv.y, acc[rr][4 * mm + 1]);
          acc[rr][4 * mm + 2] = fmaf(pr[rr], vv.z, acc[rr][4 * mm + 2]);
          acc[rr][4 * mm + 3] = fmaf(pr[rr], vv.w, acc[rr][4 * mm + 3]);
        }
      }
    }
    __syncthreads();  // this stage and P^T are read before they are reused
    if (kStages == 1 && it + 1 < n_tiles) {
      const int c1 = c0 + kKeys;
      load_kv<T, DQK, DV>(smem + L::kK, smem + L::kV, kb, vb, ks.s, vs.s, c1,
                          min(kKeys, kv_end - c1));
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = q0 + 4 * g + rr;
    if (i >= Sq) continue;
    const float inv = l[rr] > 0.0f ? 1.0f / l[rr] : 0.0f;
#pragma unroll
    for (int mm = 0; mm < kDV; ++mm) {
      store4(ob + i * os.s + 4 * c + 32 * mm, acc[rr][4 * mm] * inv,
             acc[rr][4 * mm + 1] * inv, acc[rr][4 * mm + 2] * inv,
             acc[rr][4 * mm + 3] * inv);
    }
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_len, int B, int Hq, int Hkv, int Sq, int Skv,
           const long long* strides, float scale, int causal,
           cudaStream_t stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const int smem = Smem<DQK, DV>::kBytes;
  // The shared-memory opt-in is a per-device attribute of each template's
  // kernel: set it at the first launch on each device.
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_simt_kernel<T, DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_simt_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_len, Hq, Hkv, Sq, Skv,
      qs, ks, vs, os, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, int Dv, const void* q, const void* k, const void* v,
             void* o, const int* kv_len, int B, int Hq, int Hkv, int Sq,
             int Skv, const long long* strides, float scale, int causal,
             cudaStream_t stream) {
#define SIMT_PAIR(DQK, DV)                                                  \
  if (D == DQK && Dv == DV)                                                 \
    return launch<T, DQK, DV>(q, k, v, o, kv_len, B, Hq, Hkv, Sq, Skv,      \
                              strides, scale, causal, stream);
  SIMT_PAIR(32, 32)
  SIMT_PAIR(64, 64)
  SIMT_PAIR(128, 128)
  SIMT_PAIR(192, 128)
  SIMT_PAIR(96, 64)
#undef SIMT_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), o (B, Hq, Sq,
// Dv), each given by its element strides {batch, head, seq} in `strides`
// (12 int64 on the host: q, k, v, o), the head dim contiguous; q, k and v
// 16-byte aligned with strides that are multiples of 16 bytes; dtype 0 =
// float32, 1 = bfloat16 for all four.  kv_len: (B,) int32 on the device.
// (D, Dv) in {(32, 32), (64, 64), (128, 128), (192, 128), (96, 64)}.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int* kv_len, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int Dv, const long long* strides,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || B > 65535 || Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(D, Dv, q, k, v, o, kv_len, B, Hq, Hkv, Sq, Skv,
                           strides, scale, causal, s);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(D, Dv, q, k, v, o, kv_len, B, Hq, Hkv,
                                   Sq, Skv, strides, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
