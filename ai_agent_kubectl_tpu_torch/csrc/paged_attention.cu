// Paged single-query decode attention, for Hopper (sm_90a). One kernel
// template, two entry points:
//
//   paged_decode_bf16       replaces ai_agent_kubectl_tpu/ops/paged_attention.py
//                           ::paged_decode_attention (body _paged_kernel): the
//                           contiguous per-slot caches [N, S, KV, HD];
//   paged_decode_pool_bf16  replaces ::paged_decode_attention_pool (body
//                           _paged_pool_kernel, which runs _paged_kernel): the
//                           shared pool [n_blocks, page, KV, HD] read through
//                           block_tables [N, max_pages].
//
// Per slot n, the one query of each head h at position positions[n] attends
// keys kv <= positions[n] of KV head h / G (G = H / KV, any G >= 1), scale
// 1/sqrt(HD) unless given. A slot whose position is negative writes zeros
// (the TPU kernel's l == 0 row).
//
// Shapes:
//   q, out     [N, H, HD]          bf16, contiguous
//   k, v       dense: [N, S, KV, HD] bf16 with a dense inner [S, KV, HD]; the slot
//              stride is an argument, so the model's cache view cache[:, :S]
//              (each slot carries one trash row past S) is read in place
//              pool:  [n_blocks, page, KV, HD] bf16, contiguous
//   positions  [N]                 int32
//   tables     [N, max_pages]      int32 (pool only; entries are clamped to
//                                  [0, n_blocks - 1], so a sentinel is safe)
//
// What it keeps from the TPU kernel:
// - Only keys <= min(positions[n], span - 1) are read, so the pages read are
//   exactly 0 .. pos / page, and a stale or NaN block past the live span (or
//   reached only by a clamped sentinel entry) never reaches the sum: a stage's
//   keys past the slot's last live key are zero-filled by the copy (cp.async
//   with a source size of 0) and carry probability 0.
// - Numerics: f32 scores and softmax state; P rounded to bf16 before P.V
//   while the normaliser sums the unrounded P; a row whose normaliser is 0
//   writes zeros; the output in bf16.
//
// What bounds it on an H100: a decode step reads the live K/V rows once
// (Llama-3-8B, 8 slots at about 200-750 positions: 9.3 MB a layer call, 2.8 us
// at 3.35 TB/s) and does 4 * G * HD operations per (slot, KV head, key), far
// below the bytes. So the bytes, and the latency of fetching them: with one
// block per (slot, KV head), Llama's 8 slots give 64 blocks for 132 SMs.
//
// Design (flash-decoding; the second design: the first walked each slot's
// keys in one block, one dependent table and V-row load per key, on the CUDA
// cores):
// - A block owns one (slot, KV head, tile of up to 16 of the G query heads,
//   padded to 16 rows) and a range of keys. When those blocks alone are under
//   one per SM the keys are split over blocks (grid.y) by
//   attention_mma.cuh's key_split, aiming at two blocks per SM: the plan
//   depends on the shapes (N, KV, G, the span max_pages * page or S) only,
//   lives here alone (paged_decode_plan) and is what the launch takes. A
//   block whose range starts past its slot's last live key exits.
// - The pool's block reads the table entries of its key range once, into
//   shared memory, clamped, while its position is still in flight. Its K and
//   V rows then stream through a cp.async ring, 16 bytes a copy: two stages
//   of 128 keys (three at head_dim 64; 64 keys at 256), so one stage is in
//   flight while one is computed; no copy waits on a load made for the
//   previous key.
// - The products run on the tensor cores (mma.sync.m16n8k16 through
//   attention_mma.cuh's mma_attend_step; the padded rows are free, since the
//   bytes bound the kernel): each warp (eight; four at head_dim 256) takes
//   16 keys of every stage with its own running max, sum and accumulator,
//   only a stage that crosses the last live key takes the mask, and the
//   partials merge in warp order in shared memory, leaving the block in
//   whole 16-byte pieces.
// - A slot whose live keys lie in one split is written by that block. Else
//   each live split leaves its rows' running max, sum and unnormalised
//   accumulator (f32) in a workspace that a second kernel merges in split
//   order, a warp per query head (attention_mma.cuh's combine_row). Nothing
//   depends on scheduling, and a slot's output depends on its own position
//   only.
// - The two layouts are one template; the flag kPool picks how a key row is
//   addressed (through the staged table, or by the slot stride).
//
// Left for later: TMA copies (one per page run), wgmma, a persistent
// schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int kRows = 16;      // query heads per block (padded)
constexpr int kWarpKeys = 16;  // keys per warp per stage
constexpr int kCombineWarps = 4;

template <int HD>
struct Layout {
  // Eight warps (128 keys a stage) below head_dim 256; four (64 keys) at
  // 256, where a 128-key stage of K and V alone would take 135 KB.
  static constexpr int kWarps = HD == 256 ? 4 : 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kKeys = kWarps * kWarpKeys;  // keys per stage
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kStride = HD + 8;  // bf16; conflict-free ldmatrix rows
  static constexpr int kQTile = kRows * kStride;
  static constexpr int kKVTile = kKeys * kStride;
  static constexpr size_t kRingBytes = size_t(2) * kStages * kKVTile * sizeof(__nv_bfloat16);
  static constexpr size_t kBytes = size_t(kQTile) * sizeof(__nv_bfloat16) + kRingBytes;
  // After the ring: each warp's partial, [warp][row][HD] and [warp][row] (m, l).
  static constexpr size_t kMergeBytes = size_t(kWarps) * kRows * (HD + 2) * sizeof(float);
  static constexpr int kThreadsPerKey = kThreads / kKeys;
  static_assert(kMergeBytes <= kRingBytes, "the merge reuses the ring");
  static_assert((HD / 8) % kThreadsPerKey == 0 && HD % 32 == 0, "copy");
};

// Table entries a block stages: its key range touches at most this many pages.
__host__ __device__ inline int table_entries(int kps, int page) { return kps / page + 2; }

void plan(int N, int H, int KV, int span, int* splits, int* kps) {
  const int rtiles = (H / KV + kRows - 1) / kRows;
  key_split((long long)N * KV * rtiles, span, splits, kps);
}

// The block's geometry, shared by the attention and the combine kernels.
struct Slot {
  int n, kvh, h0, rows, kv_last, live;  // kv_last < 0: no visible key
};

__device__ __forceinline__ Slot slot_of(int bx, const int32_t* __restrict__ positions, int H,
                                        int KV, int span, int kps, int splits) {
  Slot t;
  const int G = H / KV;
  const int rtiles = (G + kRows - 1) / kRows;
  t.n = bx / (KV * rtiles);
  t.kvh = (bx / rtiles) % KV;
  const int rt = bx % rtiles;
  t.h0 = t.kvh * G + rt * kRows;
  t.rows = min(kRows, G - rt * kRows);
  const int pos = positions[t.n];
  t.kv_last = pos < 0 ? -1 : min(pos, span - 1);
  t.live = t.kv_last < 0 ? 0 : min(splits, t.kv_last / kps + 1);
  return t;
}

template <int HD, bool kPool>
__global__ void __launch_bounds__(Layout<HD>::kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ positions,
                    const int32_t* __restrict__ tables, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ ws_o, float* __restrict__ ws_ml, int H, int KV,
                    int span, int page, int n_blocks, int max_pages, long long k_sstride,
                    long long v_sstride, float scale, int kps, int splits) {
  using L = Layout<HD>;
  constexpr int ST = L::kStages;
  constexpr int kWarps = L::kWarps;
  constexpr int kThreads = L::kThreads;
  constexpr int kKeys = L::kKeys;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + L::kQTile;        // ST stages
  __nv_bfloat16* sV = sK + ST * L::kKVTile;  // ST stages
  int32_t* sTab = reinterpret_cast<int32_t*>(smem + L::kBytes);

  const Slot t = slot_of(blockIdx.x, positions, H, KV, span, kps, splits);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int k_start = split * kps;
  const int p0 = k_start / page;
  if constexpr (kPool) {
    // The table entries of the block's key range, read once and clamped:
    // issued with the position's load, before the range is known, so a
    // dead block reads a few entries for nothing.
    const int32_t* row = tables + size_t(t.n) * max_pages;
    for (int i = tid; i < min(table_entries(kps, page), max_pages - p0); i += kThreads)
      sTab[i] = min(max(row[p0 + i], 0), n_blocks - 1);
  }
  __nv_bfloat16* o_tile = out + (size_t(t.n) * H + t.h0) * HD;

  if (t.live == 0) {
    // No visible key: exact zeros, from the first split.
    if (split != 0) return;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < t.rows * kChunks; i += kThreads) reinterpret_cast<uint4*>(o_tile)[i] = z;
    return;
  }
  if (k_start > t.kv_last) return;  // past the slot's last live key
  const int k_stop = min(k_start + kps - 1, t.kv_last);
  const int n_steps = (k_stop - k_start) / kKeys + 1;

  // The query heads of the tile; rows past it are zeros.
  const __nv_bfloat16* q_tile = q + (size_t(t.n) * H + t.h0) * HD;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int cc = (i % kChunks) * 8;
    const bool ok = r < t.rows;
    cp_async16(sQ + r * L::kStride + cc, ok ? q_tile + r * HD + cc : q, ok ? 16 : 0);
  }
  if constexpr (kPool) __syncthreads();  // the staged table

  // Each thread copies chunks of one fixed key row per stage.
  const int c_key = tid / L::kThreadsPerKey;
  const int c_part = tid % L::kThreadsPerKey;
  // A stage (128 keys) may reach past the block's range (a split may be 64
  // keys): keys past k_stop are zero-filled and masked like dead ones.
  auto load = [&](int step, int stage) {
    const int kv = k_start + step * kKeys + c_key;
    const bool live = kv <= k_stop;
    size_t ko = 0, vo = 0;
    if (live) {
      if constexpr (kPool) {
        ko = vo = ((size_t(sTab[kv / page - p0]) * page + kv % page) * KV + t.kvh) * HD;
      } else {
        const size_t row = (size_t(kv) * KV + t.kvh) * HD;
        ko = size_t(t.n) * size_t(k_sstride) + row;
        vo = size_t(t.n) * size_t(v_sstride) + row;
      }
    }
    __nv_bfloat16* dk = sK + stage * L::kKVTile + c_key * L::kStride;
    __nv_bfloat16* dv = sV + stage * L::kKVTile + c_key * L::kStride;
#pragma unroll
    for (int i = 0; i < kChunks / L::kThreadsPerKey; ++i) {
      const int cc = (c_part + i * L::kThreadsPerKey) * 8;
      cp_async16(dk + cc, k + ko + cc, live ? 16 : 0);
      cp_async16(dv + cc, v + vo + cc, live ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int next = step + ST - 1;
    if (next < n_steps) load(next, next % ST);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    const int stage = step % ST;
    const int kb = k_start + step * kKeys + warp * kWarpKeys;
    if (kb <= k_stop)
      mma_attend_step<HD, kWarpKeys, L::kStride>(
          sQ, sK + stage * L::kKVTile + warp * kWarpKeys * L::kStride,
          sV + stage * L::kKVTile + warp * kWarpKeys * L::kStride, kb, k_stop, k_stop,
          kb + kWarpKeys - 1 > k_stop, scale, 0.f, o, m_a, m_b, l_a, l_b);
    __syncthreads();  // this stage is read; the next copy may overwrite it
  }
  cp_async_wait<0>();

  // Each warp's partial into shared memory (over the ring), then the merge in
  // warp order, 8 columns a thread, so that the rows leave in whole 16-byte
  // (bf16) or 32-byte (f32) pieces, neighbouring threads on neighbouring
  // pieces.
  float* sO = reinterpret_cast<float*>(sK);
  float2* sML = reinterpret_cast<float2*>(sO + kWarps * kRows * HD);
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    reinterpret_cast<float2*>(sO + (warp * kRows + g) * HD + d * 8)[c] =
        make_float2(o[d][0], o[d][1]);
    reinterpret_cast<float2*>(sO + (warp * kRows + g + 8) * HD + d * 8)[c] =
        make_float2(o[d][2], o[d][3]);
  }
  if (c == 0) {
    sML[warp * kRows + g] = make_float2(m_a, l_a);
    sML[warp * kRows + g + 8] = make_float2(m_b, l_b);
  }
  __syncthreads();
  const size_t ws_row0 = size_t(split) * gridDim.x * kRows + size_t(blockIdx.x) * kRows;
  for (int i = tid; i < t.rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col0 = (i % kChunks) * 8;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sML[w * kRows + r].x);
    float den = 0.f, num[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) num[j] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 ml = sML[w * kRows + r];
      const float wt = ml.x == -INFINITY ? 0.f : exp2f(ml.x - m);
      den += wt * ml.y;
      const float4 a = *reinterpret_cast<const float4*>(sO + (w * kRows + r) * HD + col0);
      const float4 b = *reinterpret_cast<const float4*>(sO + (w * kRows + r) * HD + col0 + 4);
      num[0] += wt * a.x;
      num[1] += wt * a.y;
      num[2] += wt * a.z;
      num[3] += wt * a.w;
      num[4] += wt * b.x;
      num[5] += wt * b.y;
      num[6] += wt * b.z;
      num[7] += wt * b.w;
    }
    if (t.live > 1) {
      // Partials for the combine: max (log2 domain), sum, accumulator.
      if (col0 == 0) reinterpret_cast<float2*>(ws_ml)[ws_row0 + r] = make_float2(m, den);
      float4* dst = reinterpret_cast<float4*>(ws_o + (ws_row0 + r) * HD + col0);
      dst[0] = make_float4(num[0], num[1], num[2], num[3]);
      dst[1] = make_float4(num[4], num[5], num[6], num[7]);
    } else {
      const float inv = den != 0.f ? 1.f / den : 0.f;
      *reinterpret_cast<uint4*>(o_tile + r * HD + col0) =
          make_uint4(pack_bf16x2(num[0] * inv, num[1] * inv),
                     pack_bf16x2(num[2] * inv, num[3] * inv),
                     pack_bf16x2(num[4] * inv, num[5] * inv),
                     pack_bf16x2(num[6] * inv, num[7] * inv));
    }
  }
}

// The key splits of the slots with more than one live split, merged in split
// order (attention_mma.cuh's combine_row): block (tile, y) takes query heads
// y * kCombineWarps .. of the tile, a warp per head.
template <int HD>
__global__ void __launch_bounds__(kCombineWarps * 32)
paged_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                     const int32_t* __restrict__ positions, __nv_bfloat16* __restrict__ out,
                     int H, int KV, int span, int kps, int splits) {
  const Slot t = slot_of(blockIdx.x, positions, H, KV, span, kps, splits);
  const int r = blockIdx.y * kCombineWarps + (threadIdx.x >> 5);
  if (t.live <= 1 || r >= t.rows) return;  // written by the attention kernel
  combine_row<HD>(ws_o, ws_ml, size_t(blockIdx.x) * kRows + r, size_t(gridDim.x) * kRows,
                  t.live, out + (size_t(t.n) * H + t.h0 + r) * HD);
}

template <int HD, bool kPool>
int launch(const void* q, const void* k, const void* v, const void* positions,
           const void* tables, void* out, void* ws_o, void* ws_ml, int N, int H, int KV,
           int span, int page, int n_blocks, int max_pages, long long k_sstride,
           long long v_sstride, float scale, int kps, int splits, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kBytes + (kPool ? 4 * size_t(table_entries(kps, page)) : 0);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<HD, kPool>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int rtiles = (H / KV + kRows - 1) / kRows;
  const dim3 grid(N * KV * rtiles, splits);
  const auto* pos = static_cast<const int32_t*>(positions);
  auto* o = static_cast<__nv_bfloat16*>(out);
  paged_decode_kernel<HD, kPool><<<grid, Layout<HD>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, static_cast<const int32_t*>(tables), o,
      static_cast<float*>(ws_o), static_cast<float*>(ws_ml), H, KV, span, page, n_blocks,
      max_pages, k_sstride, v_sstride, scale, kps, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  paged_combine_kernel<HD><<<dim3(N * KV * rtiles, kRows / kCombineWarps), kCombineWarps * 32, 0,
                             stream>>>(static_cast<const float*>(ws_o),
                                       static_cast<const float*>(ws_ml), pos, o, H, KV, span, kps,
                                       splits);
  return int(cudaGetLastError());
}

template <bool kPool>
int dispatch(const void* q, const void* k, const void* v, const void* positions,
             const void* tables, void* out, void* ws_o, void* ws_ml, int N, int H, int KV,
             int head_dim, int span, int page, int n_blocks, int max_pages,
             long long k_sstride, long long v_sstride, float scale, int kps, int splits,
             void* stream) {
  if (N <= 0 || KV <= 0 || H % KV != 0 || span <= 0 || page <= 0)
    return int(cudaErrorInvalidValue);
  int want_splits = 0, want_kps = 0;
  plan(N, H, KV, span, &want_splits, &want_kps);
  if (splits != want_splits || kps != want_kps) return int(cudaErrorInvalidValue);
  if (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, kPool>(q, k, v, positions, tables, out, ws_o, ws_ml, N, H, KV,
                               span, page, n_blocks, max_pages, k_sstride, v_sstride, scale,
                               kps, splits, s);
    case 128:
      return launch<128, kPool>(q, k, v, positions, tables, out, ws_o, ws_ml, N, H,
                                KV, span, page, n_blocks, max_pages, k_sstride, v_sstride,
                                scale, kps, splits, s);
    case 256:
      return launch<256, kPool>(q, k, v, positions, tables, out, ws_o, ws_ml, N, H,
                                KV, span, page, n_blocks, max_pages, k_sstride, v_sstride,
                                scale, kps, splits, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// The key split for these shapes (span: S for the dense cache, max_pages *
// page for the pool): `*splits` ranges of `*keys_per_split` keys, and
// `*ws_rows` rows (16 per block) in each split's workspaces. Returns 0, or
// cudaErrorInvalidValue for shapes the kernel does not take. A split grid has
// under kSplitBelow blocks and at most kTargetBlocks / blocks + 1 splits, so
// the workspaces stay under 4 * (264 + 132) * 16 * (head_dim + 2) bytes:
// 6.5 MB at 256. Llama-3-8B's decode in serve_paged (8 slots, 8 KV heads:
// 64 blocks) splits the dense cache's span of 1088 keys 5 ways and the
// pool's 1024 4 ways, 256 keys a split: at most 5 * 1024 rows, 2.7 MB.
extern "C" int paged_decode_plan(int N, int H, int KV, int span, int* splits,
                                 int* keys_per_split, long long* ws_rows) {
  if (N <= 0 || KV <= 0 || H % KV != 0 || span <= 0) return int(cudaErrorInvalidValue);
  plan(N, H, KV, span, splits, keys_per_split);
  *ws_rows = (long long)N * KV * ((H / KV + kRows - 1) / kRows) * kRows;
  return 0;
}

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller allocates `out` and, when `splits` > 1, the f32 workspaces ws_o
// [splits, ws_rows, head_dim] and ws_ml [splits, ws_rows, 2]. Strides are in
// elements. `keys_per_split` and `splits` must be paged_decode_plan's:
// anything else is refused with cudaErrorInvalidValue.

// Contiguous per-slot caches: k/v [N, S, KV, head_dim] with slot strides
// k_sstride / v_sstride and a dense inner [S, KV, head_dim].
extern "C" int paged_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* positions, void* out, void* ws_o, void* ws_ml,
                                 int N, int H, int KV, int head_dim, int S, long long k_sstride,
                                 long long v_sstride, float scale, int keys_per_split,
                                 int splits, void* stream) {
  if (S <= 0 || k_sstride % 8 != 0 || v_sstride % 8 != 0) return int(cudaErrorInvalidValue);
  return dispatch<false>(q, k, v, positions, nullptr, out, ws_o, ws_ml, N, H, KV, head_dim, S,
                         1, 1, 1, k_sstride, v_sstride, scale, keys_per_split, splits, stream);
}

// The shared pool: k/v [n_blocks, page, KV, head_dim], tables [N, max_pages].
extern "C" int paged_decode_pool_bf16(const void* q, const void* k, const void* v,
                                      const void* positions, const void* tables, void* out,
                                      void* ws_o, void* ws_ml, int N, int H, int KV,
                                      int head_dim, int page, int n_blocks, int max_pages,
                                      float scale, int keys_per_split, int splits,
                                      void* stream) {
  if (n_blocks <= 0 || max_pages <= 0 || page <= 0) return int(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, positions, tables, out, ws_o, ws_ml, N, H, KV, head_dim,
                        max_pages * page, page, n_blocks, max_pages, 0, 0, scale,
                        keys_per_split, splits, stream);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
