// Ragged block-paged attention over the shared KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ai_agent_kubectl_tpu/ops/ragged_attention.py
// (::ragged_attention_pool, body _ragged_pool_kernel). One kernel serves every
// attention shape the serving loop runs over the pool: per slot n, query
// columns j < q_lens[n] sit at absolute positions positions[n] + j and attend
// kv positions <= positions[n] + j, read through block_tables[n, page].
// q_len 1 is a decode step, k+1 a verify window, a prompt span a prefill.
//
// Shapes (all contiguous):
//   q, out        [N, W, H, HD]            bf16
//   k, v          [n_blocks, page, KV, HD] bf16
//   q_lens, pos   [N]                      int32
//   tables        [N, max_pages]           int32 (entries >= n_blocks are the
//                                          unmapped-page sentinel; clamped)
//
// What it keeps from the TPU kernel:
// - Rows are laid out per KV head: row r is query column r / G of query head
//   kvh*G + r % G, so the G heads sharing one KV head read each K/V row once.
// - Nothing past a tile's last live key (positions[n] + its last live
//   column) is ever read: 0 * NaN is NaN, so a masked-out row of a stale or
//   unmapped block would poison the sum. Keys past it are zero-filled by the
//   copy (cp.async with a source size of 0) and carry probability 0.
// - Rows of slots with q_len = 0, padded columns (j >= q_len) and rows whose
//   normaliser is 0 write exact zeros.
// - Types: q and the pool are bf16; scores, the online softmax (max, sum) and
//   the P.V accumulator are f32; P is rounded to bf16 before P.V (the TPU
//   kernel's pexp.astype(v.dtype)), while the normaliser sums the unrounded P.
//
// What bounds it on an H100. A long prefill is bound by its 4*W*G*kv*HD
// operations, which only the tensor cores reach; a decode step (q_len 1) by
// the bytes of the live K/V rows (a few hundred KB a layer), so by the
// latency of gathering them, and by how many SMs take part: Gemma-2B's decode
// is 8 slots x 1 KV head, 8 row tiles for 132 SMs.
//
// Design (FlashAttention-2 on mma.sync, with flash-decoding):
// - A block owns one (slot, KV head, tile of 64 rows), four warps of 16 rows,
//   and a range of keys. Q.K^T and P.V run on the tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate): Q and K come from shared
//   memory through ldmatrix, V through ldmatrix.trans, and the score
//   accumulator turns into P's bf16 A fragments in registers. The online
//   softmax runs in registers, a row's max and sum across its quad by
//   shuffles. A warp whose rows are all padded computes nothing.
// - K/V rows are gathered through the block table (read in the kernel, in
//   place of the TPU's scalar prefetch) with cp.async into a two-stage ring,
//   so the next gather overlaps this step's MMAs. A stage holds 64 keys (32
//   at head_dim 256, so that two blocks fit on an SM); each thread copies
//   one fixed key row a stage and reads its table entry once, before its
//   copies: the copies are volatile, so a table read per copy would wait on
//   one memory round trip after another.
// - When (slot, KV head, row tile) blocks alone are under one per SM, the
//   keys are split over blocks (grid.y) in ranges of keys_per_split, a
//   multiple of 64; the plan depends on the shapes only (plan below, the
//   one rule, which the wrapper reads through ragged_attention_plan to size
//   the workspaces). A block whose range starts past its tile's own
//   last live key exits, so a row's splits follow its own slot. Each block
//   writes its rows' running max, sum and unnormalised accumulator (f32) to
//   a workspace, and a second kernel combines them in split order: the
//   result does not depend on scheduling.
//
// Left for later: wgmma with Q in registers, TMA gathers (one per page run),
// a persistent schedule, and the combine folded into the last block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;  // cp.async, ldmatrix, mma_bf16, bf16 packing, quad reductions

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // query rows per block

template <int HD>
struct Layout {
  // Keys per stage: 32 at head_dim 256, so that Q and two stages of K and
  // V (99 KB) leave room for two blocks on an SM; 64 below.
  static constexpr int kKeys = HD == 256 ? 32 : 64;
  static constexpr int kStride = HD + 8;  // bf16; conflict-free ldmatrix rows
  static constexpr int kQTile = kRows * kStride;
  static constexpr int kKVTile = kKeys * kStride;
  static constexpr size_t kSmem =
      (size_t(kQTile) + 4 * size_t(kKVTile)) * sizeof(__nv_bfloat16);  // Q, 2 K, 2 V
  // The gather: kThreads / kKeys threads per key row, each a fixed key.
  static constexpr int kThreadsPerKey = kThreads / kKeys;
  static_assert(HD % 16 == 0 && kSplitKeys % kKeys == 0, "tiles");
  static_assert((HD / 8) % kThreadsPerKey == 0, "gather");
};

// Keys per split and number of splits, from the shapes alone.
void plan(int N, int KV, int W, int G, int max_pages, int page, int* splits, int* kps) {
  const int tiles = (W * G + kRows - 1) / kRows;
  key_split((long long)N * KV * tiles, max_pages * page, splits, kps);
}

// The tile's geometry, shared by the attention and the combine kernels.
struct Tile {
  int n, kvh, r0, r_end, q_len, pos, kv_cap, kv_last;  // kv_last < 0: dead tile
};

__device__ __forceinline__ Tile tile_of(int bx, const int32_t* q_lens, const int32_t* positions,
                                        int W, int G, int KV, int page, int max_pages) {
  Tile t;
  const int tiles = (W * G + kRows - 1) / kRows;
  t.n = bx / (KV * tiles);
  t.kvh = (bx / tiles) % KV;
  t.r0 = (bx % tiles) * kRows;
  t.r_end = min(t.r0 + kRows, W * G);
  t.q_len = min(q_lens[t.n], W);
  t.pos = positions[t.n];
  t.kv_cap = max_pages * page - 1;
  // Last live column of the tile, and the last key any of its rows sees.
  const int j_last = t.q_len > 0 ? min(t.q_len - 1, (t.r_end - 1) / G) : -1;
  t.kv_last = (j_last < t.r0 / G) ? -1 : min(t.pos + j_last, t.kv_cap);
  return t;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
ragged_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ q_lens,
                  const int32_t* __restrict__ positions, const int32_t* __restrict__ tables,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ ws_o,
                  float* __restrict__ ws_ml, int W, int H, int KV, int page, int n_blocks,
                  int max_pages, float scale, int kps) {
  using L = Layout<HD>;
  constexpr int kKeys = L::kKeys;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + L::kQTile;       // two stages
  __nv_bfloat16* sV = sK + 2 * L::kKVTile;  // two stages

  const int G = H / KV;
  const Tile t = tile_of(blockIdx.x, q_lens, positions, W, G, KV, page, max_pages);
  const int split = blockIdx.y;
  const bool split_mode = gridDim.y > 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;

  auto out_row = [&](int r) -> size_t {
    return ((size_t(t.n) * W + r / G) * H + t.kvh * G + r % G) * HD;
  };

  if (t.kv_last < 0) {
    // Dead tile (frozen slot, or only padded columns): exact zeros, written
    // here when nothing is split and by the combine otherwise.
    if (split_mode) return;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < (t.r_end - t.r0) * kChunks; i += kThreads) {
      const int r = t.r0 + i / kChunks;
      reinterpret_cast<uint4*>(out + out_row(r))[i % kChunks] = z;
    }
    return;
  }
  const int k_start = split * kps;
  if (k_start > t.kv_last) return;  // the combine counts this split out
  const int k_stop = min(k_start + kps - 1, t.kv_last);
  const int n_steps = (k_stop - k_start) / kKeys + 1;

  // Q tile: zeros for rows past the tile or past the slot's q_len.
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int rr = i / kChunks;
    const int cc = i % kChunks;
    const int r = t.r0 + rr;
    const bool ok = r < t.r_end && r / G < t.q_len;
    const __nv_bfloat16* src = ok ? q + out_row(r) + cc * 8 : q;
    cp_async16(sQ + rr * L::kStride + cc * 8, src, ok ? 16 : 0);
  }
  // Each thread gathers chunks of one fixed key row per stage, so it
  // reads one table entry a stage, before any of its copies.
  const int g_key = tid / L::kThreadsPerKey;
  const int g_part = tid % L::kThreadsPerKey;
  auto gather = [&](int step, int stage) {
    const int kv = k_start + step * kKeys + g_key;
    const bool live = kv <= t.kv_last;
    size_t off = 0;
    if (live) {
      int blk = tables[size_t(t.n) * max_pages + kv / page];
      blk = min(max(blk, 0), n_blocks - 1);
      off = ((size_t(blk) * page + kv % page) * KV + t.kvh) * HD;
    }
    __nv_bfloat16* dk = sK + stage * L::kKVTile + g_key * L::kStride;
    __nv_bfloat16* dv = sV + stage * L::kKVTile + g_key * L::kStride;
#pragma unroll
    for (int i = 0; i < kChunks / L::kThreadsPerKey; ++i) {
      const int cc = (g_part + i * L::kThreadsPerKey) * 8;
      cp_async16(dk + cc, k + off + cc, live ? 16 : 0);
      cp_async16(dv + cc, v + off + cc, live ? 16 : 0);
    }
  };
  gather(0, 0);
  cp_async_commit();

  // This thread's two rows (fragment rows g and g+8 of its warp) and the last
  // key each may see (-1: padded row).
  const int row_a = t.r0 + 16 * warp + g;
  const int row_b = row_a + 8;
  const int lim_a =
      (row_a < t.r_end && row_a / G < t.q_len) ? min(t.pos + row_a / G, t.kv_cap) : -1;
  const int lim_b =
      (row_b < t.r_end && row_b / G < t.q_len) ? min(t.pos + row_b / G, t.kv_cap) : -1;
  const int warp_r0 = t.r0 + 16 * warp;
  const bool warp_live = warp_r0 < t.r_end && warp_r0 / G < t.q_len;
  const float sl = scale * kLog2e;  // scores in the log2 domain

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      gather(step + 1, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (warp_live) {
      const __nv_bfloat16* cK = sK + (step & 1) * L::kKVTile;
      const __nv_bfloat16* cV = sV + (step & 1) * L::kKVTile;
      const int kb = k_start + step * kKeys;
      constexpr int NT = kKeys / 8;

      // S = Q K^T over the stage's keys: n-tiles of 8 keys.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, sQ + (16 * warp + (lane & 15)) * L::kStride + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, cK + ((nt + (lane >> 4)) * 8 + (lane & 7)) * L::kStride + ks * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(s[nt], a[0], a[1], a[2], a[3], b[0], b[1]);
          mma_bf16(s[nt + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
        }
      }

      // Mask (causal within the window, live rows only), online softmax.
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = kb + nt * 8 + 2 * c + (e & 1);
          const bool ok = kv <= (e < 2 ? lim_a : lim_b);
          s[nt][e] = ok ? s[nt][e] * sl : -INFINITY;
          if (e < 2) mx_a = fmaxf(mx_a, s[nt][e]);
          else mx_b = fmaxf(mx_b, s[nt][e]);
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
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t a0 = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        const uint32_t a1 = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        const uint32_t a2 = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        const uint32_t a3 = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < HD / 8; dt += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kStride +
                                   (dt + (lane >> 4)) * 8);
          mma_bf16(o[dt], a0, a1, a2, a3, b[0], b[1]);
          mma_bf16(o[dt + 1], a0, a1, a2, a3, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next gather may overwrite it
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (split_mode) {
    // Partials for the combine: the running max (log2 domain), the sum and
    // the unnormalised accumulator of each row.
    const size_t rows_total = size_t(gridDim.x) * kRows;
    const size_t ga = size_t(split) * rows_total + size_t(blockIdx.x) * kRows + 16 * warp + g;
    const size_t gb = ga + 8;
    // Only live rows: the combine reads no other.
    if (lim_a >= 0) {
      if (c == 0) reinterpret_cast<float2*>(ws_ml)[ga] = make_float2(m_a, l_a);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        reinterpret_cast<float2*>(ws_o + ga * HD + d * 8)[c] = make_float2(o[d][0], o[d][1]);
    }
    if (lim_b >= 0) {
      if (c == 0) reinterpret_cast<float2*>(ws_ml)[gb] = make_float2(m_b, l_b);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        reinterpret_cast<float2*>(ws_o + gb * HD + d * 8)[c] = make_float2(o[d][2], o[d][3]);
    }
    return;
  }
  const float inv_a = (lim_a >= 0 && l_a != 0.f) ? 1.f / l_a : 0.f;
  const float inv_b = (lim_b >= 0 && l_b != 0.f) ? 1.f / l_b : 0.f;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (row_a < t.r_end)
      reinterpret_cast<uint32_t*>(out + out_row(row_a) + d * 8)[c] =
          pack_bf16x2(o[d][0] * inv_a, o[d][1] * inv_a);
    if (row_b < t.r_end)
      reinterpret_cast<uint32_t*>(out + out_row(row_b) + d * 8)[c] =
          pack_bf16x2(o[d][2] * inv_b, o[d][3] * inv_b);
  }
}

// The key splits of each row, combined in split order. A warp takes a row;
// each lane HD/32 of its columns.
template <int HD>
__global__ void __launch_bounds__(kThreads)
ragged_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                      const int32_t* __restrict__ q_lens, const int32_t* __restrict__ positions,
                      __nv_bfloat16* __restrict__ out, int W, int H, int KV, int page,
                      int max_pages, int kps, int splits) {
  const int G = H / KV;
  const Tile t = tile_of(blockIdx.x, q_lens, positions, W, G, KV, page, max_pages);
  const int live = t.kv_last < 0 ? 0 : min(splits, t.kv_last / kps + 1);
  const size_t rows_total = size_t(gridDim.x) * kRows;
  const float2* ml = reinterpret_cast<const float2*>(ws_ml);
  const int lane = threadIdx.x & 31;
  for (int r = t.r0 + (threadIdx.x >> 5); r < t.r_end; r += kWarps) {
    const size_t row = size_t(blockIdx.x) * kRows + (r - t.r0);
    float m = -INFINITY;
    if (r / G < t.q_len) {  // a live row: every live split wrote it
      for (int s = 0; s < live; ++s) m = fmaxf(m, ml[s * rows_total + row].x);
    }
    float num[HD / 32];
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) num[i] = 0.f;
    float den = 0.f;
    if (m != -INFINITY) {
      for (int s = 0; s < live; ++s) {
        const float2 p = ml[s * rows_total + row];
        const float w = exp2f(p.x - m);  // 0 for a split the row saw nothing of
        den += w * p.y;
        const float* o = ws_o + (s * rows_total + row) * HD;
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) num[i] += w * o[lane + 32 * i];
      }
    }
    const float inv = den != 0.f ? 1.f / den : 0.f;
    __nv_bfloat16* orow = out + ((size_t(t.n) * W + r / G) * H + t.kvh * G + r % G) * HD;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) orow[lane + 32 * i] = __float2bfloat16(num[i] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* q_lens,
           const void* positions, const void* tables, void* out, void* ws_o, void* ws_ml,
           int N, int W, int H, int KV, int page, int n_blocks, int max_pages, float scale,
           int kps, int splits, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (W * (H / KV) + kRows - 1) / kRows;
  const dim3 grid(N * KV * tiles, splits);
  const auto* i_ql = static_cast<const int32_t*>(q_lens);
  const auto* i_pos = static_cast<const int32_t*>(positions);
  auto* o = static_cast<__nv_bfloat16*>(out);
  ragged_mma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), i_ql, i_pos, static_cast<const int32_t*>(tables), o,
      static_cast<float*>(ws_o), static_cast<float*>(ws_ml), W, H, KV, page, n_blocks,
      max_pages, scale, kps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  ragged_combine_kernel<HD><<<N * KV * tiles, kThreads, 0, stream>>>(
      static_cast<const float*>(ws_o), static_cast<const float*>(ws_ml), i_ql, i_pos, o, W, H,
      KV, page, max_pages, kps, splits);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// The key split for these shapes: `*splits` ranges of `*keys_per_split`
// keys, and `*ws_rows` rows (every row of every 64-row tile) in each
// split's workspaces. Returns 0, or cudaErrorInvalidValue for shapes the
// kernel does not take. A split grid has under kSplitBelow blocks of 64 rows
// and at most kTargetBlocks / blocks + 1 splits, so the workspaces stay
// under 4 * (264 + 132) * 64 * (head_dim + 2) bytes: 26.2 MB at 256.
extern "C" int ragged_attention_plan(int N, int W, int H, int KV, int max_pages, int page,
                                     int* splits, int* keys_per_split, long long* ws_rows) {
  if (N <= 0 || W <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || max_pages <= 0)
    return int(cudaErrorInvalidValue);
  plan(N, KV, W, H / KV, max_pages, page, splits, keys_per_split);
  *ws_rows = (long long)N * KV * ((W * (H / KV) + kRows - 1) / kRows) * kRows;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller allocates `out` and, when `splits` > 1, the f32 workspaces ws_o
// [splits, ws_rows, head_dim] and ws_ml [splits, ws_rows, 2].
// `keys_per_split` and `splits` must be ragged_attention_plan's: anything
// else is refused with cudaErrorInvalidValue.
extern "C" int ragged_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* q_lens, const void* positions,
                                     const void* tables, void* out, void* ws_o, void* ws_ml,
                                     int N, int W, int H, int KV, int head_dim, int page,
                                     int n_blocks, int max_pages, float scale,
                                     int keys_per_split, int splits, void* stream) {
  if (N <= 0 || W <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || n_blocks <= 0 ||
      max_pages <= 0)
    return int(cudaErrorInvalidValue);
  int want_splits = 0, want_kps = 0;
  plan(N, KV, W, H / KV, max_pages, page, &want_splits, &want_kps);
  if (splits != want_splits || keys_per_split != want_kps) return int(cudaErrorInvalidValue);
  if (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)) return int(cudaErrorInvalidValue);
  const int kps = keys_per_split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, q_lens, positions, tables, out, ws_o, ws_ml, N, W, H, KV,
                        page, n_blocks, max_pages, scale, kps, splits, s);
    case 128:
      return launch<128>(q, k, v, q_lens, positions, tables, out, ws_o, ws_ml, N, W, H, KV,
                         page, n_blocks, max_pages, scale, kps, splits, s);
    case 256:
      return launch<256>(q, k, v, q_lens, positions, tables, out, ws_o, ws_ml, N, W, H, KV,
                         page, n_blocks, max_pages, scale, kps, splits, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* ragged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
