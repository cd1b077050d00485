// Split-KV flash decoding for Hopper (sm_90a), CUDA C++ with a plain C
// entry point for ctypes.  One query per (batch row, query head):
//
//   o[b, h, :] = softmax_j(scale * q[b, h, :] . k[b, j, h / group, :]
//                          for j < kv_len[b]) @ v[b, :, h / group, :]
//
// kv_len is a (B,) int32 device array (each slot of the engine's batched
// decode has its own fill level) and is never read by the host.  With one
// query, the causal mask and the kv_len mask coincide: the query sits at
// kv_len[b] - 1 and sees keys 0 .. kv_len[b] - 1.  A row with no key
// (kv_len <= 0) gets zeros.
//
// Replaces, for Sq = 1, the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (body _flash_kernel), which walks the KV blocks of one (batch, head) on
// its sequential innermost grid axis.
//
// Bound: the bytes of the cache.  Each key costs 4 * D flops for 4 * D
// bytes of K and V in bf16 (1 flop per byte), far below the ~295 flops per
// byte at which the tensor cores would limit, so the least time is the
// K/V bytes up to each row's kv_len over 3.35 TB/s.  The design therefore
// (1) fills the card: the grid is (num_splits, Hkv * group chunks, B), one
// block per split of `split` keys, so a 4096-long slot is read by 16
// blocks at once instead of one; (2) reads each K/V byte once: a block
// computes every query head of its kv head (up to 8 per block), so GQA
// does not re-read the cache; (3) moves 16 bytes per load: the lanes that
// hold one key row (D * sizeof(T) / 16 of them) each load one 16-byte
// vector of K and of V, straight from the (B, S, H, D) cache through its
// strides, the next 2-4 rows of each lane loading while the current ones
// are scored; a key's score is a shuffle reduction over the lanes of its
// row, and the rows of one step share one rescale of (l, acc).  Blocks
// whose split starts at or past kv_len write an empty partial
// (m = -inf, l = 0) and return.  Each block leaves (m, l, acc[D]) per head
// in float32 scratch; flash_decode_combine rescales the splits and writes
// the output in q's dtype.
//
// The int8 instance (flash_decode_split_int8_launch) reads the quantized KV
// cache: int8 K and V and one bf16 scale per (batch row, position, kv
// head).  Its bound is the cache's bytes, int8 values plus bf16 scales:
// about half the bf16 cache's.  Its own kernel splits the global loading
// from the compute layout:
//   (1) a block copies its split's K and V rows into shared memory by
//       16-byte cp.async, all at once (~64 KB in flight a block at D 128),
//       with one wait and one block barrier, and each row's two scales
//       once, as floats;
//   (2) each lane then reads from shared memory the VEC int8 values a
//       lane of the T instance holds, dequantizes them exactly as the
//       model's reference does, T(float(q) * float(scale)): q to float by
//       prmt into the mantissa of 2^23 (exact), the product (exact in
//       float32: 8 by 8 significant bits), then two values rounded to
//       bf16 at a time (cvt.rn.bf16x2.f32), the same bits as a scalar
//       cast;
//   (3) from there it runs the T instance's arithmetic in the same order
//       (scores, shuffle tree, rescale, warp merge, block merge, combine),
//       with the same rows per warp and step, so on the same cache
//       dequantized by PyTorch the two give the same bits;
//   (4) a lane holds only the block's live heads: at a GQA group of 6 it
//       keeps 6 heads in registers where the T instance's G = 8 also
//       carries 2 dead ones; the step loop is unrolled twice, so a step's
//       loads and dequantization overlap the last one's softmax, and the
//       launch bounds ask for 2 blocks an SM (174 registers a lane at
//       internlm2-20b's instance; without a minimum, or at 3 blocks, it ran
//       9-11% slower).
// What bounds it: instructions and their latency, not bytes.  The
// arithmetic it shares with the T instance (a 4-round shuffle tree and an
// online-softmax update per head and key, fixed by the equal-bits
// contract) is ~19 warp instructions a (head, key), the dequantization ~5
// a value, against ~2 bytes a (value, key) of HBM traffic.  Dealing the
// heads to two or three groups of warps (more warps an SM, the
// dequantization repeated per group) ran slower; skipping the rescale
// while the running max stands does not keep the T instance's bits
// (tools/kernel_ab.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// The int8 instance's shared memory holds the split's rows rounded up to
// this (a whole step of any instance: kStep <= 128 rows).
constexpr int kRowQuantum = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T as floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
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

struct Strides {
  long long b, h, s;
};

// Merge state (m2, l2, a2) into (m, l, a); m in log2 units, -inf = empty.
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2,
                                      float l2, const float* a2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  const float s1 = exp2f(m - mx), s2 = exp2f(m2 - mx);
  l = l * s1 + l2 * s2;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * s1 + a2[e] * s2;
  m = mx;
}

// Grid (num_splits, Hkv * num_chunks, B); block kThreads.  Partials:
// ml[((b * Hq + h) * num_splits + split) * 2 + {0: m, 1: l}] and
// acc[((b * Hq + h) * num_splits + split) * D + d], float32.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kv_len, float* __restrict__ ml,
                          float* __restrict__ acc_out, int Hq, int Hkv,
                          int Skv, int split, int num_chunks, Strides qs,
                          Strides ks, Strides vs, float scale_log2) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = D / VEC;      // lanes per key row
  constexpr int KPW = 32 / LPR;     // key rows per warp step
  constexpr int KPB = KPW * kWarps; // key rows per block step
  constexpr int U = G >= 4 ? 2 : 4; // key rows per lane per step
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int num_splits = gridDim.x;
  const int sp = blockIdx.x;
  const int hk = blockIdx.y / num_chunks;
  const int h0 = hk * (Hq / Hkv) + (blockIdx.y % num_chunks) * G;
  const int gn = min(G, hk * (Hq / Hkv) + Hq / Hkv - h0);  // heads here
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, part = lane % LPR;

  const int len = min(kv_len[b], Skv);
  const int s0 = sp * split;
  const int s1 = min(s0 + split, len);
  const long long pbase = (long long)(b * Hq + h0) * num_splits + sp;
  if (s0 >= s1) {  // past kv_len: an empty partial
    if (threadIdx.x < gn) {
      ml[(pbase + (long long)threadIdx.x * num_splits) * 2] = -INFINITY;
      ml[(pbase + (long long)threadIdx.x * num_splits) * 2 + 1] = 0.0f;
    }
    return;
  }

  float qv[G][VEC], m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[g][e] = 0.0f;
      qv[g][e] = g < gn ? scale_log2 * to_float(q[b * qs.b + (h0 + g) * qs.h +
                                                  part * VEC + e])
                        : 0.0f;
    }
  }

  const T* kb = k + b * ks.b + hk * ks.h + part * VEC;
  const T* vb = v + b * vs.b + hk * vs.h + part * VEC;
  // Rows wb + sub + u * KPB, u < U, as 16-byte vectors; zeros past s1.
  auto load = [&](int wb, uint4 (&kr)[U], uint4 (&vr)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = wb + sub + u * KPB;
      if (j < s1) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + j * ks.s));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + j * vs.s));
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
  };
  // The trip count is the warp's (not the lane's), so every shuffle below
  // has all 32 lanes.  The next U rows load while these U are scored; the
  // U scores of a head share one rescale of (l, acc).
  constexpr int kStep = KPB * U;
  uint4 kr[U], vr[U];
  load(s0 + warp * KPW, kr, vr);
  for (int wb = s0 + warp * KPW; wb < s1; wb += kStep) {
    uint4 kn[U], vn[U];
    load(wb + kStep, kn, vn);
    float sc[G][U], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      Vec<T>::unpack(kr[u], kf);
      Vec<T>::unpack(vr[u], vf[u]);
      const bool valid = wb + sub + u * KPB < s1;  // uniform over the row
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qv[g][e], kf[e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        sc[g][u] = valid ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mn = fmaxf(mn, sc[g][u]);
      if (mn != -INFINITY) {
        const float alpha = exp2f(m[g] - mn);  // 0 while m is -inf
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = exp2f(sc[g][u] - mn);  // 0 for a masked row
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
        }
        m[g] = mn;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // Merge the warp's KPW row groups (lanes part, part + LPR, ...).
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a2[VEC];
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
      merge<VEC>(m[g], l[g], acc[g], m2, l2, a2);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (part == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][part * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  // Merge the warps: thread -> (head g, dim d).
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.0f, a = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float s = exp2f(sm_m[w][g] - mx);
        lsum = fmaf(sm_l[w][g], s, lsum);
        a = fmaf(sm_acc[w][g][d], s, a);
      }
    }
    const long long p = pbase + (long long)g * num_splits;
    acc_out[p * D + d] = a;
    if (d == 0) {
      ml[p * 2] = mx;
      ml[p * 2 + 1] = lsum;
    }
  }
}

// ---------------------------------------------------------------- int8

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The four int8 of w (its bytes, low first) as exact floats: each byte,
// offset by 128 (w ^ 0x80808080: q + 128 in 0 .. 255), is put into the low
// mantissa byte of 2^23 by prmt (0x4B0000xx = 2^23 + q + 128), and
// 2^23 + 128 comes off (an exact difference).
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | i)) -
           8388736.0f;
  }
}

// A lane's VEC int8 values of one row in shared memory, times the row's
// scale, as T rounds them: T(float(q) * scale).  The product is exact in
// float32, so float32 needs no rounding and bf16 one, two values at a time.
template <typename T>
struct Int8Row;
template <>
struct Int8Row<float> {
  __device__ __forceinline__ static void load(const int8_t* p, float sc,
                                              float* f) {
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(p), f);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] *= sc;
  }
};
template <>
struct Int8Row<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const int8_t* p, float sc,
                                              float* f) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    float x[8];
    int8x4_to_float(w.x, x);
    int8x4_to_float(w.y, x + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 r =
          __floats2bfloat162_rn(x[2 * i] * sc, x[2 * i + 1] * sc);
      uint32_t bits;  // .x in the low half
      memcpy(&bits, &r, sizeof(bits));
      f[2 * i] = __uint_as_float(bits << 16);
      f[2 * i + 1] = __uint_as_float(bits & 0xffff0000u);
    }
  }
};

// The int8 instance.  Grid (num_splits, Hkv * num_chunks, B); block
// kThreads; a lane holds HPT <= G of the block's G heads (those that live:
// G = 8 at a GQA group of 6 keeps 6).  Dynamic shared memory: the split's
// K rows and V rows (cap rows of D int8 each),
// then their scales as floats (cap each); after the keys are read, the
// block merge's (m, l, acc) of every warp and head over the K rows.  The
// partials as flash_decode_split_kernel's, with the same bits.
template <typename T, int D, int G, int HPT>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_split_int8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ kv_len,
    float* __restrict__ ml, float* __restrict__ acc_out, int Hq, int Hkv,
    int Skv, int split, int cap, int num_chunks, Strides qs, Strides ks,
    Strides vs, Strides kss, Strides vss, float scale_log2) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = D / VEC;      // lanes per key row
  constexpr int KPW = 32 / LPR;     // key rows per warp step
  constexpr int KPB = KPW * kWarps; // key rows per block step
  constexpr int U = G >= 4 ? 2 : 4; // key rows per lane per step
  constexpr int kStep = KPB * U;
  constexpr int CPR = D / 16;       // 16-byte chunks a row
  static_assert(kRowQuantum % kStep == 0, "a step's rows fit the capacity");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_k = reinterpret_cast<int8_t*>(smem);
  int8_t* s_v = s_k + cap * D;
  float* s_ks = reinterpret_cast<float*>(s_v + cap * D);
  float* s_vs = s_ks + cap;
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;               // [kWarps][G]
  float* sm_acc = sm_l + kWarps * G;             // [kWarps][G][D]

  const int num_splits = gridDim.x;
  const int sp = blockIdx.x;
  const int group = Hq / Hkv;
  const int hk = blockIdx.y / num_chunks;
  const int h0 = hk * group + (blockIdx.y % num_chunks) * G;
  const int gn = min(G, hk * group + group - h0);  // heads here
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, part = lane % LPR;

  const int len = min(kv_len[b], Skv);
  const int s0 = sp * split;
  const int s1 = min(s0 + split, len);
  const long long pbase = (long long)(b * Hq + h0) * num_splits + sp;
  if (s0 >= s1) {  // past kv_len: an empty partial
    if (threadIdx.x < gn) {
      ml[(pbase + (long long)threadIdx.x * num_splits) * 2] = -INFINITY;
      ml[(pbase + (long long)threadIdx.x * num_splits) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int nrows = s1 - s0;

  // The split's rows at once (~64 KB in flight at D 128).
  {
    const int8_t* kg = k + b * ks.b + hk * ks.h + s0 * ks.s;
    const int8_t* vg = v + b * vs.b + hk * vs.h + s0 * vs.s;
    for (int i = threadIdx.x; i < nrows * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 16;
      cp_async16(s_k + r * D + c, kg + r * ks.s + c);
      cp_async16(s_v + r * D + c, vg + r * vs.s + c);
    }
    cp_async_commit();
  }
  // Each row's scales once, as floats; 0 past the split's keys (rows a
  // step reads there hold no keys: their values become +-0 and are masked).
  {
    const unsigned short* kq = reinterpret_cast<const unsigned short*>(
        k_scale + b * kss.b + hk * kss.h + s0 * kss.s);
    const unsigned short* vq = reinterpret_cast<const unsigned short*>(
        v_scale + b * vss.b + hk * vss.h + s0 * vss.s);
    for (int r = threadIdx.x; r < cap; r += kThreads) {
      float kc = 0.0f, vc = 0.0f;
      if (r < nrows) {
        kc = __uint_as_float(static_cast<uint32_t>(__ldg(kq + r * kss.s)) << 16);
        vc = __uint_as_float(static_cast<uint32_t>(__ldg(vq + r * vss.s)) << 16);
      }
      s_ks[r] = kc;
      s_vs[r] = vc;
    }
  }

  float qv[HPT][VEC], m[HPT], l[HPT], acc[HPT][VEC];
#pragma unroll
  for (int g = 0; g < HPT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[g][e] = 0.0f;
      qv[g][e] = g < gn ? scale_log2 * to_float(q[b * qs.b + (h0 + g) * qs.h +
                                                  part * VEC + e])
                        : 0.0f;
    }
  }

  cp_async_wait_all();
  __syncthreads();
  // The T instance's loop over rows (relative to s0): warp w's steps start
  // at w * KPW, kStep apart, each with rows + sub + u * KPB.
#pragma unroll 2
  for (int wr = warp * KPW; wr < nrows; wr += kStep) {
    float sc[HPT][U], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = wr + sub + u * KPB;
      float kf[VEC];
      Int8Row<T>::load(s_k + r * D + part * VEC, s_ks[r], kf);
      Int8Row<T>::load(s_v + r * D + part * VEC, s_vs[r], vf[u]);
      const bool valid = r < nrows;  // uniform over the row
#pragma unroll
      for (int g = 0; g < HPT; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qv[g][e], kf[e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        sc[g][u] = valid ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < HPT; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mn = fmaxf(mn, sc[g][u]);
      if (mn != -INFINITY) {
        const float alpha = exp2f(m[g] - mn);  // 0 while m is -inf
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = exp2f(sc[g][u] - mn);  // 0 for a masked row
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
        }
        m[g] = mn;
      }
    }
  }

  // Merge the warp's KPW row groups (lanes part, part + LPR, ...).
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < HPT; ++g) {
      float a2[VEC];
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
      merge<VEC>(m[g], l[g], acc[g], m2, l2, a2);
    }
  }
  __syncthreads();  // every warp is done with the keys the merge overwrites
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < HPT; ++g) {
      if (g >= gn) continue;
      if (part == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(warp * G + g) * D + part * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  // Merge the warps: thread -> (head g, dim d).
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.0f, a = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float s = exp2f(sm_m[w * G + g] - mx);
        lsum = fmaf(sm_l[w * G + g], s, lsum);
        a = fmaf(sm_acc[(w * G + g) * D + d], s, a);
      }
    }
    const long long p = pbase + (long long)g * num_splits;
    acc_out[p * D + d] = a;
    if (d == 0) {
      ml[p * 2] = mx;
      ml[p * 2 + 1] = lsum;
    }
  }
}

// Grid (Hq, B); block D threads.  Rescales the splits of (b, h) to their
// common max and writes o[b, h, :] = sum_s w_s acc_s / sum_s w_s l_s, or
// zeros when every split is empty.  An empty split's acc is never read.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ ml,
                            const float* __restrict__ acc, T* __restrict__ o,
                            int Hq, int num_splits, Strides os) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long p0 = (long long)(b * Hq + h) * num_splits;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < num_splits; ++s) mx = fmaxf(mx, ml[(p0 + s) * 2]);
  float lsum = 0.0f, a = 0.0f;
  if (mx != -INFINITY) {
#pragma unroll 8
    for (int s = 0; s < num_splits; ++s) {
      const float ms = ml[(p0 + s) * 2];
      if (ms == -INFINITY) continue;
      const float w = exp2f(ms - mx);
      lsum = fmaf(ml[(p0 + s) * 2 + 1], w, lsum);
      a = fmaf(acc[(p0 + s) * D + d], w, a);
    }
  }
  store(o + b * os.b + h * os.h + d, lsum > 0.0f ? a / lsum : 0.0f);
}

// One call's arguments; st holds the element strides {batch, head, seq}
// of q, k, v, o and, for the int8 instance, of k_scale and v_scale.
struct Args {
  const void *q, *k, *v, *k_scale, *v_scale;
  void* o;
  const int* kv_len;
  float *ml, *acc;
  int B, Hq, Hkv, Skv, split;
  const long long* st;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int combine(const Args& a, int num_splits) {
  const long long* st = a.st;
  const Strides os{st[9], st[10], st[11]};
  flash_decode_combine_kernel<T, D><<<dim3(a.Hq, a.B), D, 0, a.stream>>>(
      a.ml, a.acc, static_cast<T*>(a.o), a.Hq, num_splits, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int G>
int launch(const Args& a) {
  const long long* st = a.st;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]};
  const int num_splits = (a.Skv + a.split - 1) / a.split;
  const int group = a.Hq / a.Hkv;
  const int num_chunks = (group + G - 1) / G;
  const dim3 grid(num_splits, a.Hkv * num_chunks, a.B);
  flash_decode_split_kernel<T, D, G><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kv_len, a.ml, a.acc, a.Hq, a.Hkv, a.Skv,
      a.split, num_chunks, qs, ks, vs, a.scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine<T, D>(a, num_splits);
}

template <typename T, int D>
int launch_g(const Args& a) {
  const int group = a.Hq / a.Hkv;
  if (group == 1) return launch<T, D, 1>(a);
  if (group == 2) return launch<T, D, 2>(a);
  if (group <= 4) return launch<T, D, 4>(a);
  return launch<T, D, 8>(a);
}

// The int8 instance at the T instance's G (its chunks of heads and rows a
// step), heads dealt HPT to a head group.
template <typename T, int D, int G, int HPT>
int launch_int8(const Args& a) {
  const long long* st = a.st;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]};
  const Strides kss{st[12], st[13], st[14]}, vss{st[15], st[16], st[17]};
  const int num_splits = (a.Skv + a.split - 1) / a.split;
  const int group = a.Hq / a.Hkv;
  const int num_chunks = (group + G - 1) / G;
  const long long cap =
      ((long long)a.split + kRowQuantum - 1) / kRowQuantum * kRowQuantum;
  const long long bytes = cap * (2 * D + 2 * (long long)sizeof(float));
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_decode_split_int8_kernel<T, D, G, HPT>;
  static long long attr_bytes = 0;  // the largest size granted so far
  if (bytes > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = bytes;
  }
  const dim3 grid(num_splits, a.Hkv * num_chunks, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const int8_t*>(a.v),
      static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), a.kv_len, a.ml, a.acc,
      a.Hq, a.Hkv, a.Skv, a.split, static_cast<int>(cap), num_chunks, qs, ks,
      vs, kss, vss, a.scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine<T, D>(a, num_splits);
}

template <typename T, int D>
int launch_int8_g(const Args& a) {
  const int group = a.Hq / a.Hkv;
  if (group == 1) return launch_int8<T, D, 1, 1>(a);
  if (group == 2) return launch_int8<T, D, 2, 2>(a);
  if (group <= 4) return launch_int8<T, D, 4, 4>(a);
  if (group <= 6) return launch_int8<T, D, 8, 6>(a);  // 2 heads of G dead
  return launch_int8<T, D, 8, 8>(a);
}

template <typename T>
int launch_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return launch_g<T, 32>(a);
    case 64:
      return launch_g<T, 64>(a);
    case 128:
      return launch_g<T, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_int8_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return launch_int8_g<T, 32>(a);
    case 64:
      return launch_int8_g<T, 64>(a);
    case 128:
      return launch_int8_g<T, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int B, int Hq, int Hkv, int Skv, int split) {
  return B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 ||
         split <= 0 || B > 65535 || Hq > 65535 ||
         (long long)Hkv * ((Hq / Hkv + 7) / 8) > 65535;
}

}  // namespace

// q (B, Hq, 1, D) and o like it, k and v (B, Hkv, Skv, D), each given by
// its element strides {batch, head, seq} in `strides` (12 int64 on the
// host: q, k, v, o), the head dim contiguous; k and v 16-byte aligned with
// strides that are multiples of 16 bytes (checked by the wrapper).  dtype
// 0 = float32, 1 = bfloat16 for q, k, v and o.  kv_len: (B,) int32 on the
// device.  ml and acc: float32 scratch of B * Hq * ceil(Skv / split) * 2
// and * D elements.  D in {32, 64, 128}.  Launches the split kernel and the
// combine kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int flash_decode_split_launch(const void* q, const void* k,
                                         const void* v, void* o,
                                         const int* kv_len, float* ml,
                                         float* acc, int B, int Hq, int Hkv,
                                         int Skv, int D, int split,
                                         const long long* strides,
                                         float scale, int dtype,
                                         void* stream) {
  if (bad_shape(B, Hq, Hkv, Skv, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,   k,   v,   nullptr, nullptr, o,     kv_len,
               ml,  acc, B,   Hq,      Hkv,     Skv,   split,
               strides, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_d<float>(D, a);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same over an int8 cache: k and v int8 (B, Hkv, Skv, D), k_scale and
// v_scale bf16 (B, Hkv, Skv, 1), `strides` 18 int64 (q, k, v, o, k_scale,
// v_scale); dtype (q and o) 0 = float32, 1 = bfloat16.  Each K/V value is
// dequantized as the dtype's cast of float(value) * float(scale).  The
// split's keys are staged in dynamic shared memory: ceil(split / 128) * 128
// * (2 * D + 8) bytes, at most 227 KB (split <= 768 at D 128).
extern "C" int flash_decode_split_int8_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* o, const int* kv_len, float* ml, float* acc,
    int B, int Hq, int Hkv, int Skv, int D, int split,
    const long long* strides, float scale, int dtype, void* stream) {
  if (bad_shape(B, Hq, Hkv, Skv, split) || k_scale == nullptr ||
      v_scale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,   k,   v,   k_scale, v_scale, o,     kv_len,
               ml,  acc, B,   Hq,      Hkv,     Skv,   split,
               strides, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_int8_d<float>(D, a);
  if (dtype == 1) return launch_int8_d<__nv_bfloat16>(D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
