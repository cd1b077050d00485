// Flash attention forward on Hopper's tensor cores (sm_90a): bf16 inputs,
// head dims (Dqk, Dv) of q/k and of v in {(64, 64), (128, 128), (192, 128),
// (96, 64)} (the last two are MLA's prefill: deepseek-v2-lite, minicpm3),
// any number of query rows.  CUDA C++ with a plain C entry point for ctypes.
//
//   o[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / group, j, :]
//                             masked) @ v[b, h / group, :, :]
//
// masked: key j is dropped when j >= kv_len[b] and, when causal, when
// j > kv_len[b] - Sq + i (the queries are the last Sq positions of a
// context of kv_len[b] tokens).  kv_len is a (B,) int32 device array.  A
// row with no key left gets zeros, never a NaN.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (body _flash_kernel) for bf16 prefill.  On the TPU the KV blocks of one
// (batch, head, query block) are the sequential innermost grid axis and
// (m, l, acc) are carried across it in VMEM; here the KV loop runs inside
// the block and (m, l, acc) live in registers.
//
// Bound: operations.  The prefill call (1, 2048, 32, 64) causal is
// 17.2 GFLOP of products against 33.6 MB, ~510 flops per byte, above the
// ~295 at which the bf16 tensor cores (989 TFLOP/s) rather than HBM
// (3.35 TB/s) set the limit.  So both products run on `wgmma`, the only
// path to that rate, and the design keeps the tensor cores fed:
//   * a block is two consumer warpgroups of 64 query rows each (128 rows,
//     the m64 of wgmma per warpgroup) plus one producer warp;
//   * the producer warp loads Q once and K/V tiles (128 keys at D = 64, 64
//     at D = 128) through TMA (4-D tensor maps over the (B, S, H, D) or
//     (B, H, S, D) tensor by its element strides, 128-byte swizzle,
//     out-of-range rows zero-filled) into a ring of 3 stages guarded by
//     full/empty mbarriers, so the next tiles load while the consumers
//     compute;
//   * S = Q K^T is a shared-memory x shared-memory wgmma (K stored (keys,
//     D), which is the K-major B operand); the online softmax runs on the
//     f32 accumulator registers with quad shuffles for the row max, in
//     log2 units on the special-function unit's ex2; P is packed to bf16
//     in registers, where the S accumulator's layout already is wgmma's
//     register-A layout, and O += P V is a register x shared-memory wgmma
//     with V read through the transpose bit (V stored (keys, D) is
//     MN-major); O stays in f32 registers until the end;
//   * the softmax, not the products, is the longer part at D = 64 (the
//     exponentials alone need about as many cycles of the special-function
//     unit as the products need of the tensor cores), so it is hidden
//     behind products twice: within a warpgroup, tile j's softmax runs
//     while tile j - 1's P V product does; across the two, they take turns
//     issuing products (named barriers), so one's softmax runs while the
//     other's products hold the tensor cores;
//   * Dqk and Dv are counted in 64-column slices, QH of them for Q and K
//     (the S product's depth) and VH for V (the P V product's N and the O
//     accumulator); Dqk = 96 is one and a half slices, so its second slice
//     is loaded as a whole box whose last 32 columns lie past the tensor's
//     head dim and are zero-filled by TMA: they add nothing to S;
//   * causal: tiles wholly past the block's last row are never loaded, a
//     warpgroup skips tiles past its own last row, and only tiles that
//     reach past a row's limit are masked; the longest query blocks are
//     launched first.
// A row's limit folds kv_len and the causal diagonal into one column
// bound, read from the device array per block, so the host reads nothing
// and ragged Sq and Skv need no padding.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBr = 128;  // query rows per block: 2 consumer warpgroups
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxDevices = 64;  // devices whose smem opt-in is tracked

// Dynamic shared memory for QH 64-column slices of Q and K, VH of V, and
// BC keys per K/V tile.  A 64-column slice of a bf16 tile is 128 bytes a
// row, the span of the 128-byte swizzle; a wider tile is its slices
// ("halves") one after the other.  Every slice starts on 1024 bytes, the
// swizzle's period.
template <int QH, int VH, int BC>
struct Smem {
  static constexpr int kQHalf = kBr * 128;
  static constexpr int kKVHalf = BC * 128;
  static constexpr int kQBytes = QH * kQHalf;
  static constexpr int kKBytes = QH * kKVHalf;  // one K stage
  static constexpr int kVBytes = VH * kKVHalf;  // one V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kAlloc <= 232448, "a block's shared memory on sm_90");
};

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major
// operands (Q, K): the leading offset is unused, the stride offset is the
// 1024 bytes between groups of 8 rows.  The MN-major V passes 1024 for
// both: each of its products is N = 64 wide, one swizzle atom, so only
// the step between groups of 8 keys is read.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"
#define WG_OPS32(d)                                                    \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define WG_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_OPS64(d)                                                    \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x N, f32) (+)= A (64 x 16, smem, K-major) . B (16 x N, smem,
// K-major); scale_d = 0 overwrites d.  N = 64 or 128.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OPS32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OPS64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OPS32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit, subnormals flushed; 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barrier `id` over `count` threads: wait for it, or only arrive.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Grid (Hq, B, ceil(Sq / kBr)); block kThreads.  Accumulator layout of a
// consumer thread (warp w of its warpgroup, lane = 4 g + t): element
// 4 c + 2 r + e is row 16 w + g + 8 r, column 8 c + 2 t + e.  Each
// warpgroup overlaps the softmax of tile j with the P V product of tile
// j - 1: it issues S_j = Q K_j and O += P_{j-1} V_{j-1} together, waits
// for S_j alone, computes P_j while the second product runs, then waits
// for it, releases tile j - 1's stage and rescales O.
template <int QH, int VH, int BC>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o,
                        const int* __restrict__ kv_len, int Hq, int Hkv,
                        int Sq, int Skv, Strides os, float scale_log2,
                        int causal) {
  using L = Smem<QH, VH, BC>;
  constexpr int kS = BC / 2;  // score accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBr;  // longest rows first
  const int hk = h / (Hq / Hkv);
  const int len = min(kv_len[b], Skv);
  const int row_offset = kv_len[b] - Sq;  // position of query row 0
  // Keys the block needs: below kv_len and, when causal, up to its last
  // row's position.
  int kv_end = len;
  if (causal) kv_end = min(kv_end, row_offset + min(q0 + kBr, Sq));
  const int n_tiles = kv_end > 0 ? (kv_end + BC - 1) / BC : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp; one lane issues
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int hh = 0; hh < QH; ++hh) {
        tma_load_4d(q_s + hh * L::kQHalf, &tq, bar_q, 64 * hh, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages, round = j / kStages;
        if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, L::kKBytes + L::kVBytes);
        for (int hh = 0; hh < QH; ++hh) {
          tma_load_4d(k_s + s * L::kKBytes + hh * L::kKVHalf, &tk,
                      bar_full + 8 * s, 64 * hh, j * BC, hk, b);
        }
        for (int hh = 0; hh < VH; ++hh) {
          tma_load_4d(v_s + s * L::kVBytes + hh * L::kKVHalf, &tv,
                      bar_full + 8 * s, 64 * hh, j * BC, hk, b);
        }
      }
    }
    return;
  }

  // Consumers.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int i0 = q0 + wg * 64 + warp * 16 + lane / 4;  // row r: i0 + 8 r
  int lim[2];  // keys j < lim[r] are valid for row r
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lim[r] = causal ? min(len, row_offset + i0 + 8 * r + 1) : len;
  }
  const int lim_min = min(lim[0], lim[1]);
  // Tiles this warpgroup needs, up to its last row's limit; it only
  // releases the block's others (loaded for the other warpgroup).
  int n_mine = 0;
  if (q0 + wg * 64 < Sq) {
    const int last = min(q0 + wg * 64 + 63, Sq - 1);
    const int end = causal ? min(len, row_offset + last + 1) : len;
    n_mine = min(n_tiles, end > 0 ? (end + BC - 1) / BC : 0);
  }

  float oacc[VH][32];
#pragma unroll
  for (int hh = 0; hh < VH; ++hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[hh][i] = 0.0f;
  }
  float sacc[kS];
  uint32_t pa[BC / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
  const uint32_t qa = q_s + wg * 64 * 128;  // this warpgroup's 64 rows

  // S = Q K_j^T into sacc, committed as one group (not waited for).
  auto issue_s = [&](int j) {
    const uint32_t ks = k_s + (j % kStages) * L::kKBytes;
#pragma unroll
    for (int kk = 0; kk < QH * 4; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns: 32 bytes
      wgmma_ss(sacc, make_desc(qa + (kk / 4) * L::kQHalf + off, 16, 1024),
               make_desc(ks + (kk / 4) * L::kKVHalf + off, 16, 1024),
               kk > 0);
    }
    wg_commit();
  };
  // O += P V_j from pa, committed as one group (not waited for).
  auto issue_pv = [&](int j) {
    const uint32_t vs = v_s + (j % kStages) * L::kVBytes;
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
      for (int hh = 0; hh < VH; ++hh) {
        wgmma_rs(oacc[hh], pa[kk],
                 make_desc(vs + hh * L::kKVHalf + kk * 16 * 128, 1024, 1024));
      }
    }
    wg_commit();
  };
  // Mask tile j's scores, update m and l, leave p in sacc and the factor
  // that rescales O in alpha.
  auto softmax = [&](int j) {
    const int c0 = j * BC;
    if (c0 + BC > lim_min) {  // the tile reaches past a row's limit
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int col = c0 + (i / 4) * 8 + 2 * t + (i % 2);
        if (col >= lim[(i / 2) % 2]) sacc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]}, ms[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sacc[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with no valid key yet keeps m = -inf; its p and alpha are 0.
      ms[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * scale_log2;
      alpha[r] = fast_exp2(m[r] * scale_log2 - ms[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = (i / 2) % 2;
      sacc[i] = fast_exp2(fmaf(sacc[i], scale_log2, -ms[r]));
      rs[r] += sacc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  };
  // P as wgmma's register A: keys 16 kk .. 16 kk + 15 are accumulator
  // elements 8 kk .. 8 kk + 7.
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kk][x] = pack_bf16(sacc[8 * kk + 2 * x], sacc[8 * kk + 2 * x + 1]);
      }
    }
  };
  auto zero_s = [&]() {
#pragma unroll
    for (int i = 0; i < kS; ++i) sacc[i] = 0.0f;
  };

  // Ping-pong: the two warpgroups take turns issuing their products
  // (named barriers 1 and 2), so one's softmax runs while the other's
  // products hold the tensor cores.  Each takes n_tiles + 1 turns, idle
  // ones included; warpgroup 1 opens the first turn to warpgroup 0 and
  // does not pass on its last.
  int turn = 0;
  auto take_turn = [&]() { named_bar_sync(1 + wg, kConsumers); };
  auto pass_turn = [&]() {
    if (wg == 0 || ++turn < n_tiles + 1) named_bar_arrive(2 - wg, kConsumers);
  };

  if (n_tiles > 0) {
    mbar_wait(bar_q, 0);
    if (wg == 1) named_bar_arrive(1, kConsumers);
  }
  if (n_mine > 0) {
    mbar_wait(bar_full, 0);
    zero_s();
    wg_fence();
    take_turn();
    issue_s(0);
    pass_turn();
    wg_wait<0>();
    fence_regs(sacc);
    softmax(0);  // O is still zero: alpha is not needed
    pack();
    for (int j = 1; j < n_mine; ++j) {
      mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);
      zero_s();
      wg_fence();
      take_turn();
      issue_s(j);
      issue_pv(j - 1);
      pass_turn();
      wg_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      fence_regs(sacc);
      softmax(j);
      wg_wait<0>();
#pragma unroll
      for (int hh = 0; hh < VH; ++hh) fence_regs(oacc[hh]);
      mbar_arrive(bar_empty + 8 * ((j - 1) % kStages));
#pragma unroll
      for (int hh = 0; hh < VH; ++hh) {
#pragma unroll
        for (int i = 0; i < 32; ++i) oacc[hh][i] *= alpha[(i / 2) % 2];
      }
      pack();
    }
    wg_fence();
    take_turn();
    issue_pv(n_mine - 1);
    pass_turn();
    wg_wait<0>();
#pragma unroll
    for (int hh = 0; hh < VH; ++hh) fence_regs(oacc[hh]);
    mbar_arrive(bar_empty + 8 * ((n_mine - 1) % kStages));
  }
  if (n_mine == 0 && n_tiles > 0) {  // the idle turn of the first tile
    take_turn();
    pass_turn();
  }
  for (int j = n_mine; j < n_tiles; ++j) {  // loaded for the other group
    mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);
    mbar_arrive(bar_empty + 8 * (j % kStages));
    take_turn();
    pass_turn();
  }

  // Epilogue: the row sums over the quad, then o = acc / l (0 if no key).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = i0 + 8 * r;
    if (i >= Sq) continue;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + i * os.s;
#pragma unroll
    for (int hh = 0; hh < VH; ++hh) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t v2 = pack_bf16(oacc[hh][4 * c + 2 * r] * inv,
                                      oacc[hh][4 * c + 2 * r + 1] * inv);
        *reinterpret_cast<uint32_t*>(orow + 64 * hh + 8 * c + 2 * t) = v2;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the
// runtime's entry-point query, so the library links no libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a bf16 tensor with dims (D, S, H, B), innermost first,
// by its element strides {b, h, s}; boxes of 64 columns x `rows` rows of
// one (head, batch), columns past D zero-filled.  A dim of extent 1 is
// never stepped, so its stride is replaced by a legal one.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
              const long long* st, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long ext[3] = {S, H, B}, el[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    strides[i] = static_cast<cuuint64_t>(ext[i] == 1 ? 16 : el[i] * 2);
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QH, int VH, int BC>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_len, int B, int Hq, int Hkv, int Sq, int Skv, int D,
           int Dv, const long long* st, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, Hq, B, st, kBr) ||
      !make_map(&tk, k, D, Skv, Hkv, B, st + 3, BC) ||
      !make_map(&tv, v, Dv, Skv, Hkv, B, st + 6, BC)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides os{st[9], st[10], st[11]};
  const int smem = Smem<QH, VH, BC>::kAlloc;
  // The shared-memory opt-in is a per-device attribute of the kernel: set
  // it at the first launch on each device, not on every call (the tensor
  // maps hold this call's pointers, so they are encoded per call).
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_tc_kernel<QH, VH, BC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 grid(Hq, B, (Sq + kBr - 1) / kBr);
  flash_prefill_tc_kernel<QH, VH, BC><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), kv_len, Hq, Hkv, Sq, Skv,
      os, scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), o (B, Hq, Sq,
// Dv), all bfloat16, each given by its element strides {batch, head, seq}
// in `strides` (12 int64 on the host: q, k, v, o), the head dim
// contiguous.  q, k and v must be 16-byte aligned with strides that are
// multiples of 16 bytes (TMA's rule; the wrapper checks it).  kv_len: (B,)
// int32 on the device.  (D, Dv) in {(64, 64), (128, 128), (192, 128),
// (96, 64)}.  Launches on `stream` and returns a CUDA error code as an int
// (cudaErrorInvalidValue when a tensor map cannot be encoded).
extern "C" int flash_prefill_tc_launch(const void* q, const void* k,
                                       const void* v, void* o,
                                       const int* kv_len, int B, int Hq,
                                       int Hkv, int Sq, int Skv, int D,
                                       int Dv, const long long* strides,
                                       float scale, int causal,
                                       void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || B > 65535 || (Sq + kBr - 1) / kBr > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (Q/K slices, V slices, keys per tile): 128-key tiles where O is one
  // slice wide, 64-key tiles where it is two (registers: O, S and P).
#define TC_PAIR(DQK, DV, QH, VH, BC)                                       \
  if (D == DQK && Dv == DV)                                                \
    return launch<QH, VH, BC>(q, k, v, o, kv_len, B, Hq, Hkv, Sq, Skv, D,  \
                              Dv, strides, scale, causal, s);
  TC_PAIR(64, 64, 1, 1, 128)
  TC_PAIR(128, 128, 2, 2, 64)
  TC_PAIR(192, 128, 3, 2, 64)
  TC_PAIR(96, 64, 2, 1, 128)
#undef TC_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
