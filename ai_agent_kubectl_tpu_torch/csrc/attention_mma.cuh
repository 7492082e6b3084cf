// Code shared by the port's three attention kernels (ragged_attention.cu,
// flash_attention.cu, paged_attention.cu), for Hopper (sm_90a): the key
// split rule, 16-byte cp.async with zero-fill, ldmatrix, the bf16
// tensor-core product (mma.sync.m16n8k16, f32 accumulate), bf16 packing,
// reductions over the four lanes that hold one fragment row, one warp's
// FlashAttention-2 step over a K/V stage in shared memory (its rows padded,
// or in TMA's 128-byte swizzle), and the merge of a row's key splits.
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA): lane = 4 * g + c holds
// rows g and g + 8 of the 16-row tile, and columns 2c, 2c + 1 of each 8-wide
// n-tile. A warp's online softmax keeps one running max and sum per row it
// holds (m_a, l_a for row g; m_b, l_b for row g + 8), in the log2 domain.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr float kLog2e = 1.4426950408889634f;

// The key split rule of every attention kernel here, from the shapes alone:
// when `blocks` (the grid without a split) is under one per SM, the `span`
// keys are cut into `*splits` ranges of `*kps` keys, a multiple of
// kSplitKeys, aiming at two blocks per SM; otherwise one range covers them.
// A function of the shapes only, never of positions: a row's live splits
// follow from its own last key, and a block whose range starts past it
// exits.
constexpr int kSplitKeys = 64;      // a key split is a multiple of this
constexpr int kSplitBelow = 132;    // split keys when blocks < one per SM
constexpr int kTargetBlocks = 264;  // ... aiming for two per SM

inline void key_split(long long blocks, int span, int* splits, int* kps) {
  if (blocks >= kSplitBelow) {
    *splits = 1;
    *kps = (span + kSplitKeys - 1) / kSplitKeys * kSplitKeys;
    return;
  }
  const int want = int((kTargetBlocks + blocks - 1) / blocks);
  int per = (span + want - 1) / want;
  per = (per + kSplitKeys - 1) / kSplitKeys * kSplitKeys;
  *kps = per;
  *splits = (span + per - 1) / per;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float d[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Where element (row, col) of a K or V tile in shared memory lies, col a
// multiple of 8 (one 16-byte piece, the unit of ldmatrix). PaddedRows: rows
// of STRIDE bf16 (a stride of HD + 8 keeps ldmatrix free of bank
// conflicts). Swizzle128<ROWS>: the layout a TMA load in the 128-byte swizzle
// leaves, a tile of ROWS rows (a multiple of 8, from a 1024-byte aligned
// base) stored as HD / 64 column blocks [ROWS][64], where the 16-byte piece
// j of row r lies at piece j ^ (r & 7) of its 128-byte line. `base` may be
// any multiple of 8 rows into the tile.
template <int STRIDE>
struct PaddedRows {
  static __device__ __forceinline__ const __nv_bfloat16* at(const __nv_bfloat16* base, int row,
                                                            int col) {
    return base + row * STRIDE + col;
  }
};

template <int ROWS>
struct Swizzle128 {
  static __device__ __forceinline__ const __nv_bfloat16* at(const __nv_bfloat16* base, int row,
                                                            int col) {
    return base + (col >> 6) * (ROWS * 64) + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3);
  }
};

// One warp's FlashAttention-2 step over NK keys (a multiple of 16) held in
// shared memory: S = Q K^T for the warp's 16 query rows (sQw: row 0 of them,
// row stride STRIDE bf16; cK and cV laid out as KVT says, by default the
// same padded rows), then the online softmax and
// O += P V, with P rounded to bf16 for the product while the sum l takes the
// unrounded P. Key kb + j is cK's row j. `masked`: keys past a row's limit
// (lim_a for row g, lim_b for row g + 8; -1 sees none) get probability 0;
// a caller passes false only when every key of the step is within every
// limit. softcap > 0 applies tanh(s * scale / softcap) * softcap before the
// mask. The running max and sums are in the log2 domain.
template <int HD, int NK, int STRIDE, class KVT = PaddedRows<STRIDE>>
__device__ __forceinline__ void mma_attend_step(const __nv_bfloat16* sQw,
                                                const __nv_bfloat16* cK,
                                                const __nv_bfloat16* cV, int kb, int lim_a,
                                                int lim_b, bool masked, float scale,
                                                float softcap, float (&o)[HD / 8][4],
                                                float& m_a, float& m_b, float& l_a,
                                                float& l_b) {
  static_assert(NK % 16 == 0 && HD % 16 == 0, "tiles");
  constexpr int NT = NK / 8;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;

  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, sQw + (lane & 15) * STRIDE + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, KVT::at(cK, (nt + (lane >> 4)) * 8 + (lane & 7),
                             ks * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(s[nt], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(s[nt + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }

  // Scale (or softcap) into the log2 domain; the mask only where needed.
  const float sl = scale * kLog2e;
  const float cs = softcap > 0.f ? scale / softcap : 0.f;
  const float cl = softcap * kLog2e;
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = softcap > 0.f ? tanhf(s[nt][e] * cs) * cl : s[nt][e] * sl;
      if (masked) {
        const int kv = kb + nt * 8 + 2 * c + (e & 1);
        x = kv <= (e < 2 ? lim_a : lim_b) ? x : -INFINITY;
      }
      s[nt][e] = x;
      if (e < 2) mx_a = fmaxf(mx_a, x);
      else mx_b = fmaxf(mx_b, x);
    }
  const float mn_a = fmaxf(m_a, quad_max(mx_a));
  const float mn_b = fmaxf(m_b, quad_max(mx_b));
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float al_a = m_a == -INFINITY ? 0.f : exp2f(m_a - mn_a);
  const float al_b = m_b == -INFINITY ? 0.f : exp2f(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[nt][e] - (e < 2 ? base_a : base_b));
      s[nt][e] = p;
      if (e < 2) sum_a += p;
      else sum_b += p;
    }
  l_a = l_a * al_a + sum_a;
  l_b = l_b * al_b + sum_b;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    o[d][0] *= al_a;
    o[d][1] *= al_a;
    o[d][2] *= al_b;
    o[d][3] *= al_b;
  }

  // O += P V: P (rounded to bf16) is the A operand, 16 keys a step.
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t a0 = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t a1 = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t a2 = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < HD / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, KVT::at(cV, kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                   (dt + (lane >> 4)) * 8));
      mma_bf16(o[dt], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(o[dt + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

// The `live` key splits of one row merged in split order (a fixed order:
// the result does not depend on scheduling) into bf16 at orow. Split s left
// the row's running max (log2 domain) and sum at ws_ml[s * rows_total + row]
// and its unnormalised accumulator at ws_o[(s * rows_total + row) * HD]. One
// warp per row, HD / 32 columns a lane, one pass: each split rescales the
// running merge to the larger max, as the online softmax does. The loads of
// up to kCombineBatch splits are issued together before any is used, so a
// row costs one round trip per batch, not one per split. A row no split saw
// (live 0, or every max -inf) writes exact zeros. The partials are read
// through L2 only (ld.global.cg): other blocks of the same launch may have
// written them.
constexpr int kCombineBatch = 4;

template <int HD>
__device__ __forceinline__ void combine_row(const float* __restrict__ ws_o,
                                            const float* __restrict__ ws_ml, size_t row,
                                            size_t rows_total, int live,
                                            __nv_bfloat16* __restrict__ orow) {
  const int lane = threadIdx.x & 31;
  const float2* ml = reinterpret_cast<const float2*>(ws_ml);
  float m = -INFINITY, den = 0.f;
  float num[HD / 32];
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) num[i] = 0.f;
  for (int s0 = 0; s0 < live; s0 += kCombineBatch) {
    float2 p[kCombineBatch];
    float v[kCombineBatch][HD / 32];
#pragma unroll
    for (int b = 0; b < kCombineBatch; ++b) {
      p[b] = make_float2(-INFINITY, 0.f);
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) v[b][i] = 0.f;
      if (s0 + b < live) {
        const size_t r = (s0 + b) * rows_total + row;
        p[b] = __ldcg(ml + r);
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) v[b][i] = __ldcg(ws_o + r * HD + lane + 32 * i);
      }
    }
#pragma unroll
    for (int b = 0; b < kCombineBatch; ++b) {
      const float mn = fmaxf(m, p[b].x);
      if (s0 + b < live && mn != -INFINITY) {  // else past the row's splits, or nothing seen yet
        const float a = m == -INFINITY ? 0.f : exp2f(m - mn);
        const float w = p[b].x == -INFINITY ? 0.f : exp2f(p[b].x - mn);
        den = den * a + w * p[b].y;
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) num[i] = num[i] * a + w * v[b][i];
        m = mn;
      }
    }
  }
  const float inv = den != 0.f ? 1.f / den : 0.f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) orow[lane + 32 * i] = __float2bfloat16(num[i] * inv);
}

}  // namespace attn
