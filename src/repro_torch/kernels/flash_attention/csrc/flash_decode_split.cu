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
// head).  Each lane loads the VEC int8 values it would have read as T
// (8 bytes for bf16 q, 4 for float32) and the row's two scales, and
// dequantizes in registers exactly as the model's reference does,
// T(float(value) * float(scale)); everything after the dequantization is
// the T instance's code, so on the same cache dequantized by PyTorch the
// two give the same bits.  Its bound is the cache's bytes, int8 values
// plus bf16 scales: about half the bf16 cache's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

// x cast to T and back, rounded as a cast to T rounds (nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A lane's VEC values of one K or V row, as floats: 16 bytes of T, or VEC
// int8 values times the row's bf16 scale (rounded to T first).
template <typename T, typename KV>
struct Rows {  // KV == T: no scale
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const KV* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ static float scale(const __nv_bfloat16*,
                                                long long) {
    return 0.0f;
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float,
                                                float* f) {
    Vec<T>::unpack(r, f);
  }
};
template <typename T>
struct Rows<T, int8_t> {
  static constexpr int N = Vec<T>::N;  // int8 values (bytes) per lane
  using Raw = typename std::conditional<N == 8, uint2, uint32_t>::type;
  __device__ __forceinline__ static Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ __forceinline__ static Raw zero() { return Raw{}; }
  __device__ __forceinline__ static float scale(const __nv_bfloat16* p,
                                                long long off) {
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(p + off));
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float sc,
                                                float* f) {
    uint32_t w[N / 4];
    if constexpr (N == 8) {
      w[0] = r.x;
      w[1] = r.y;
    } else {
      w[0] = r;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int8_t q = static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xffu);
      f[e] = round_to<T>(static_cast<float>(q) * sc);
    }
  }
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
// KV is T, or int8_t with the bf16 scales k_scale, v_scale (strides kss,
// vss; unread when KV is T).
template <typename T, typename KV, int D, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                          const KV* __restrict__ v,
                          const __nv_bfloat16* __restrict__ k_scale,
                          const __nv_bfloat16* __restrict__ v_scale,
                          const int* __restrict__ kv_len, float* __restrict__ ml,
                          float* __restrict__ acc_out, int Hq, int Hkv,
                          int Skv, int split, int num_chunks, Strides qs,
                          Strides ks, Strides vs, Strides kss, Strides vss,
                          float scale_log2) {
  using R = Rows<T, KV>;
  using Raw = typename R::Raw;
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

  const KV* kb = k + b * ks.b + hk * ks.h + part * VEC;
  const KV* vb = v + b * vs.b + hk * vs.h + part * VEC;
  const __nv_bfloat16* ksb = k_scale + b * kss.b + hk * kss.h;
  const __nv_bfloat16* vsb = v_scale + b * vss.b + hk * vss.h;
  // Rows wb + sub + u * KPB, u < U, as vectors (and scales); zeros past s1.
  auto load = [&](int wb, Raw (&kr)[U], Raw (&vr)[U], float (&kc)[U],
                  float (&vc)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = wb + sub + u * KPB;
      if (j < s1) {
        kr[u] = R::load(kb + j * ks.s);
        vr[u] = R::load(vb + j * vs.s);
        kc[u] = R::scale(ksb, j * kss.s);
        vc[u] = R::scale(vsb, j * vss.s);
      } else {
        kr[u] = R::zero();
        vr[u] = R::zero();
        kc[u] = 0.0f;
        vc[u] = 0.0f;
      }
    }
  };
  // The trip count is the warp's (not the lane's), so every shuffle below
  // has all 32 lanes.  The next U rows load while these U are scored; the
  // U scores of a head share one rescale of (l, acc).
  constexpr int kStep = KPB * U;
  Raw kr[U], vr[U];
  float kc[U], vc[U];
  load(s0 + warp * KPW, kr, vr, kc, vc);
  for (int wb = s0 + warp * KPW; wb < s1; wb += kStep) {
    Raw kn[U], vn[U];
    float kcn[U], vcn[U];
    load(wb + kStep, kn, vn, kcn, vcn);
    float sc[G][U], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      R::unpack(kr[u], kc[u], kf);
      R::unpack(vr[u], vc[u], vf[u]);
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
      kc[u] = kcn[u];
      vc[u] = vcn[u];
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

template <typename T, typename KV, int D, int G>
int launch(const Args& a) {
  const long long* st = a.st;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  Strides kss{0, 0, 0}, vss{0, 0, 0};
  if (a.k_scale != nullptr) {
    kss = Strides{st[12], st[13], st[14]};
    vss = Strides{st[15], st[16], st[17]};
  }
  const int num_splits = (a.Skv + a.split - 1) / a.split;
  const int group = a.Hq / a.Hkv;
  const int num_chunks = (group + G - 1) / G;
  const dim3 grid(num_splits, a.Hkv * num_chunks, a.B);
  flash_decode_split_kernel<T, KV, D, G><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v),
      static_cast<const __nv_bfloat16*>(a.k_scale),
      static_cast<const __nv_bfloat16*>(a.v_scale), a.kv_len, a.ml, a.acc,
      a.Hq, a.Hkv, a.Skv, a.split, num_chunks, qs, ks, vs, kss, vss,
      a.scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T, D><<<dim3(a.Hq, a.B), D, 0, a.stream>>>(
      a.ml, a.acc, static_cast<T*>(a.o), a.Hq, num_splits, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int D>
int launch_g(const Args& a) {
  const int group = a.Hq / a.Hkv;
  if (group == 1) return launch<T, KV, D, 1>(a);
  if (group == 2) return launch<T, KV, D, 2>(a);
  if (group <= 4) return launch<T, KV, D, 4>(a);
  return launch<T, KV, D, 8>(a);
}

template <typename T, typename KV>
int launch_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return launch_g<T, KV, 32>(a);
    case 64:
      return launch_g<T, KV, 64>(a);
    case 128:
      return launch_g<T, KV, 128>(a);
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
  if (dtype == 0) return launch_d<float, float>(D, a);
  if (dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same over an int8 cache: k and v int8 (B, Hkv, Skv, D), k_scale and
// v_scale bf16 (B, Hkv, Skv, 1), `strides` 18 int64 (q, k, v, o, k_scale,
// v_scale); dtype (q and o) 0 = float32, 1 = bfloat16.  Each K/V value is
// dequantized as the dtype's cast of float(value) * float(scale).
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
  if (dtype == 0) return launch_d<float, int8_t>(D, a);
  if (dtype == 1) return launch_d<__nv_bfloat16, int8_t>(D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
