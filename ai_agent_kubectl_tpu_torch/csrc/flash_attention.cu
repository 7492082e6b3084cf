// Causal flash attention over a KV cache region (the prefill path), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ai_agent_kubectl_tpu/ops/flash_attention.py
// (::flash_attention_cached, body _flash_kernel). Query row (b, s, h) sits at
// absolute position positions[b, s] and attends the cache slots
// kv <= positions[b, s] of KV head h / (H / KV).
//
// Shapes:
//   q, out     [B, S, H, HD]       bf16, contiguous
//   k, v       [B, KVLEN, KV, HD]  bf16, inner [KVLEN, KV, HD] dense; the batch
//                                  stride is an argument, so a cache[:, :limit]
//                                  view is read in place (no transposed copy --
//                                  the TPU wrapper transposed to [B, H, S, HD])
//   positions  [B, S]              int32
//
// What it keeps from the TPU kernel:
// - Rows are laid out per KV head: row r of KV head kvh is query column r / G
//   of query head kvh*G + r % G (G = H / KV), so the G heads that share a KV
//   head read each K/V row once (GQA by grouping, not by repeating heads).
// - Causal skipping: a tile stops at the largest position among its rows,
//   clamped to KVLEN - 1 (the TPU kernel's clamp of its tile count). Bucket
//   padding rows carry positions past the prompt, so a tile can reach
//   further than its valid rows; still no key at or past KVLEN, and no key
//   past the tile's last live key, is read (cp.async zero-fills the rest of
//   a stage: 0 * NaN is NaN, so a stale row would poison the sum).
// - Numerics: scores, the running max and sum, and the accumulator in f32;
//   the optional softcap (tanh(s / c) * c) before the mask; P rounded to bf16
//   before P.V while the normaliser sums the unrounded P; a row with no
//   visible key (position < 0) writes exact zeros; the output in bf16.
//
// What bounds it on an H100: a Gemma-7B prefill of 512 tokens is 2.15 GFLOP
// of causal attention per layer call against 5 MB of q, K/V and out, so the
// operations, which only the tensor cores reach; a short prefill (85 tokens)
// is a few blocks' work, bound by latency and by how many SMs take part.
//
// Design (FlashAttention-2 on mma.sync, with flash-decoding's key split;
// the second design: the first ran both products on the CUDA cores in f32,
// loaded K/V synchronously and masked every step):
// - A block owns one (batch, KV head, tile of 64 rows), four warps of 16 rows,
//   and a range of keys. Q.K^T and P.V run on the tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate; attention_mma.cuh's
//   mma_attend_step): Q and K through ldmatrix, V through ldmatrix.trans,
//   the score accumulator turned into P's bf16 A fragments in registers, the
//   online softmax in registers.
// - K/V stream through a two-stage cp.async ring (64 keys a stage, 32 at
//   head_dim 256 so that Q and the ring, 99 KB, leave room for two blocks on
//   an SM): the next stage's copy overlaps this stage's products.
// - Causal work only where it is needed: a block stops at its tile's last
//   live key; a warp skips a stage that starts past all its rows' positions;
//   only a stage that crosses a row's position takes the mask; and the tiles
//   are numbered bottom-up, so the longest start first.
// - When the (batch, KV head, row tile) blocks alone are under one per SM,
//   the keys are split over blocks (grid.y) by attention_mma.cuh's
//   key_split: the plan depends on the shapes only, lives here alone
//   (flash_attention_plan) and is what the launch takes. A tile whose live
//   keys lie in one split is written by that block; the others leave each
//   row's running max, sum and unnormalised accumulator (f32) in a workspace
//   that a second kernel merges in split order, a warp per row
//   (attention_mma.cuh's combine_row; deterministic).
// - The epilogue leaves through shared memory in 16-byte stores of whole
//   rows: the fragments' own 4-byte stores, 16 bytes of a row each, took
//   longer on the card than a block's products.
//
// Left for later: wgmma with Q in registers, TMA loads, a persistent
// schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // query rows per block

template <int HD>
struct Layout {
  static constexpr int kKeys = HD == 256 ? 32 : 64;  // keys per stage
  static constexpr int kStride = HD + 8;  // bf16; conflict-free ldmatrix rows
  static constexpr int kQTile = kRows * kStride;
  static constexpr int kKVTile = kKeys * kStride;
  static constexpr size_t kSmem =
      (size_t(kQTile) + 4 * size_t(kKVTile)) * sizeof(__nv_bfloat16);  // Q, 2 K, 2 V
  // The copy: kThreads / kKeys threads per key row, each a fixed key.
  static constexpr int kThreadsPerKey = kThreads / kKeys;
  static_assert(HD % 16 == 0 && kSplitKeys % kKeys == 0, "tiles");
  static_assert((HD / 8) % kThreadsPerKey == 0, "copy");
};

void plan(int B, int S, int H, int KV, int KVLEN, int* splits, int* kps) {
  const int tiles = (S * (H / KV) + kRows - 1) / kRows;
  key_split((long long)B * KV * tiles, KVLEN, splits, kps);
}

// The tile's geometry, shared by the attention and the combine kernels.
// Blocks run bottom tile first: with positions rising down the rows, the
// tiles with the most keys start first.
struct Tile {
  int b, kvh, r0, r_end, kv_last, live;  // kv_last < 0: no row sees a key
};

__device__ __forceinline__ Tile tile_of(int bx, const int32_t* __restrict__ positions, int B,
                                        int S, int G, int KV, int KVLEN, int kps, int splits) {
  Tile t;
  const int tiles = (S * G + kRows - 1) / kRows;
  const int tile = tiles - 1 - bx / (B * KV);
  t.b = (bx % (B * KV)) / KV;
  t.kvh = bx % KV;
  t.r0 = tile * kRows;
  t.r_end = min(t.r0 + kRows, S * G);
  // The last key any row of the tile sees: every warp reads the tile's
  // positions (at most 64) and takes their max.
  const int lane = threadIdx.x & 31;
  int pmax = -1;
  for (int s = t.r0 / G + lane; s <= (t.r_end - 1) / G; s += 32)
    pmax = max(pmax, positions[size_t(t.b) * S + s]);
  pmax = __reduce_max_sync(0xffffffffu, pmax);
  t.kv_last = pmax < 0 ? -1 : min(pmax, KVLEN - 1);
  t.live = t.kv_last < 0 ? 0 : min(splits, t.kv_last / kps + 1);
  return t;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ positions,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws_o,
                 float* __restrict__ ws_ml, int B, int S, int H, int KV, int KVLEN,
                 long long k_bstride, long long v_bstride, float scale, float softcap, int kps,
                 int splits) {
  using L = Layout<HD>;
  constexpr int kKeys = L::kKeys;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + L::kQTile;       // two stages
  __nv_bfloat16* sV = sK + 2 * L::kKVTile;  // two stages

  const int G = H / KV;
  const Tile t = tile_of(blockIdx.x, positions, B, S, G, KV, KVLEN, kps, splits);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;

  auto out_row = [&](int r) -> size_t {
    return ((size_t(t.b) * S + r / G) * H + t.kvh * G + r % G) * HD;
  };

  if (t.live == 0) {
    // No row of the tile sees a key: exact zeros, from the first split.
    if (split != 0) return;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < (t.r_end - t.r0) * kChunks; i += kThreads) {
      const int r = t.r0 + i / kChunks;
      reinterpret_cast<uint4*>(out + out_row(r))[i % kChunks] = z;
    }
    return;
  }
  const int k_start = split * kps;
  if (k_start > t.kv_last) return;  // past the tile's last live key
  const int k_stop = min(k_start + kps - 1, t.kv_last);
  const int n_steps = (k_stop - k_start) / kKeys + 1;

  // Q tile: zeros for rows past the tile.
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int rr = i / kChunks;
    const int cc = i % kChunks;
    const int r = t.r0 + rr;
    const bool ok = r < t.r_end;
    cp_async16(sQ + rr * L::kStride + cc * 8, ok ? q + out_row(r) + cc * 8 : q, ok ? 16 : 0);
  }
  // Each thread copies chunks of one fixed key row per stage; keys past the
  // tile's last live key are zero-filled, never read.
  const int c_key = tid / L::kThreadsPerKey;
  const int c_part = tid % L::kThreadsPerKey;
  const __nv_bfloat16* kb_ptr = k + size_t(t.b) * size_t(k_bstride) + size_t(t.kvh) * HD;
  const __nv_bfloat16* vb_ptr = v + size_t(t.b) * size_t(v_bstride) + size_t(t.kvh) * HD;
  auto load = [&](int step, int stage) {
    const int kv = k_start + step * kKeys + c_key;
    const bool live = kv <= t.kv_last;
    const size_t off = live ? size_t(kv) * KV * HD : 0;
    __nv_bfloat16* dk = sK + stage * L::kKVTile + c_key * L::kStride;
    __nv_bfloat16* dv = sV + stage * L::kKVTile + c_key * L::kStride;
#pragma unroll
    for (int i = 0; i < kChunks / L::kThreadsPerKey; ++i) {
      const int cc = (c_part + i * L::kThreadsPerKey) * 8;
      cp_async16(dk + cc, kb_ptr + off + cc, live ? 16 : 0);
      cp_async16(dv + cc, vb_ptr + off + cc, live ? 16 : 0);
    }
  };
  load(0, 0);
  cp_async_commit();

  // This thread's two rows (fragment rows g and g+8 of its warp) and the last
  // key each sees (negative: none). The warp skips a stage past all its rows'
  // limits and masks only a stage that crosses one of them.
  const int row_a = t.r0 + 16 * warp + g;
  const int row_b = row_a + 8;
  auto limit = [&](int r) {
    return r < t.r_end ? min(positions[size_t(t.b) * S + r / G], KVLEN - 1) : -1;
  };
  const int lim_a = limit(row_a);
  const int lim_b = limit(row_b);
  const int warp_max = __reduce_max_sync(0xffffffffu, max(lim_a, lim_b));
  const int warp_min = __reduce_min_sync(
      0xffffffffu, min(row_a < t.r_end ? lim_a : INT_MAX, row_b < t.r_end ? lim_b : INT_MAX));

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load(step + 1, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kb = k_start + step * kKeys;
    if (kb <= warp_max)
      mma_attend_step<HD, kKeys, L::kStride>(
          sQ + 16 * warp * L::kStride, sK + (step & 1) * L::kKVTile,
          sV + (step & 1) * L::kKVTile, kb, lim_a, lim_b, kb + kKeys - 1 > warp_min, scale,
          softcap, o, m_a, m_b, l_a, l_b);
    __syncthreads();  // this stage is read; the next copy may overwrite it
  }

  // The epilogue goes through shared memory (over Q and the ring, which the
  // loop's last barrier freed), so that the tile leaves in 16-byte stores of
  // whole rows.
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const int r_tile = t.r_end - t.r0;
  if (t.live > 1) {
    // Partials for the combine: the running max (log2 domain) and the sum
    // of each row, and the unnormalised accumulator staged in f32.
    constexpr int kWStride = HD + 4;
    float* sW = reinterpret_cast<float*>(smem);
    static_assert(size_t(kRows) * kWStride * sizeof(float) <= L::kSmem, "staging");
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      reinterpret_cast<float2*>(sW + (16 * warp + g) * kWStride + d * 8)[c] =
          make_float2(o[d][0], o[d][1]);
      reinterpret_cast<float2*>(sW + (16 * warp + g + 8) * kWStride + d * 8)[c] =
          make_float2(o[d][2], o[d][3]);
    }
    const size_t row0 = size_t(split) * gridDim.x * kRows + size_t(blockIdx.x) * kRows;
    if (c == 0) {
      if (row_a < t.r_end) reinterpret_cast<float2*>(ws_ml)[row0 + 16 * warp + g] =
          make_float2(m_a, l_a);
      if (row_b < t.r_end) reinterpret_cast<float2*>(ws_ml)[row0 + 16 * warp + g + 8] =
          make_float2(m_b, l_b);
    }
    __syncthreads();
    for (int i = tid; i < r_tile * (HD / 4); i += kThreads) {
      const int rr = i / (HD / 4);
      const int cc = (i % (HD / 4)) * 4;
      *reinterpret_cast<float4*>(ws_o + (row0 + rr) * HD + cc) =
          *reinterpret_cast<const float4*>(sW + rr * kWStride + cc);
    }
    return;
  }
  const float inv_a = (lim_a >= 0 && l_a != 0.f) ? 1.f / l_a : 0.f;
  const float inv_b = (lim_b >= 0 && l_b != 0.f) ? 1.f / l_b : 0.f;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    reinterpret_cast<uint32_t*>(sQ + (16 * warp + g) * L::kStride + d * 8)[c] =
        pack_bf16x2(o[d][0] * inv_a, o[d][1] * inv_a);
    reinterpret_cast<uint32_t*>(sQ + (16 * warp + g + 8) * L::kStride + d * 8)[c] =
        pack_bf16x2(o[d][2] * inv_b, o[d][3] * inv_b);
  }
  __syncthreads();
  for (int i = tid; i < r_tile * kChunks; i += kThreads) {
    const int rr = i / kChunks;
    const int cc = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(out + out_row(t.r0 + rr) + cc) =
        *reinterpret_cast<const uint4*>(sQ + rr * L::kStride + cc);
  }
}

// The key splits of the rows of tiles with more than one live split, merged
// in split order (attention_mma.cuh's combine_row): block (tile, y) takes
// rows y * kWarps .. of the tile, a warp per row, so that every row's
// merge runs at once.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                     const int32_t* __restrict__ positions, __nv_bfloat16* __restrict__ out,
                     int B, int S, int H, int KV, int KVLEN, int kps, int splits) {
  const int G = H / KV;
  const Tile t = tile_of(blockIdx.x, positions, B, S, G, KV, KVLEN, kps, splits);
  const int r = t.r0 + blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (t.live <= 1 || r >= t.r_end) return;  // written by the attention kernel
  combine_row<HD>(ws_o, ws_ml, size_t(blockIdx.x) * kRows + (r - t.r0),
                  size_t(gridDim.x) * kRows, t.live,
                  out + ((size_t(t.b) * S + r / G) * H + t.kvh * G + r % G) * HD);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* positions, void* out,
           void* ws_o, void* ws_ml, int B, int S, int H, int KV, int KVLEN,
           long long k_bstride, long long v_bstride, float scale, float softcap, int kps,
           int splits, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (S * (H / KV) + kRows - 1) / kRows;
  const dim3 grid(B * KV * tiles, splits);
  const auto* pos = static_cast<const int32_t*>(positions);
  auto* o = static_cast<__nv_bfloat16*>(out);
  flash_mma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, o, static_cast<float*>(ws_o),
      static_cast<float*>(ws_ml), B, S, H, KV, KVLEN, k_bstride, v_bstride, scale, softcap,
      kps, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  flash_combine_kernel<HD><<<dim3(B * KV * tiles, kRows / kWarps), kThreads, 0, stream>>>(
      static_cast<const float*>(ws_o), static_cast<const float*>(ws_ml), pos, o, B, S, H, KV,
      KVLEN, kps, splits);
  return int(cudaGetLastError());
}

bool shapes_ok(int B, int S, int H, int KV, int KVLEN) {
  return B > 0 && S > 0 && KV > 0 && H % KV == 0 && KVLEN > 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// The key split for these shapes: `*splits` ranges of `*keys_per_split`
// keys, and `*ws_rows` rows (every row of every 64-row tile) in each
// split's workspaces. Returns 0, or cudaErrorInvalidValue for shapes the
// kernel does not take. A split grid has under kSplitBelow blocks of 64 rows
// and at most kTargetBlocks / blocks + 1 splits, so the workspaces stay
// under 4 * (264 + 132) * 64 * (head_dim + 2) bytes: 26.2 MB at 256. The
// largest prefill served (Gemma-7B, S = KVLEN = 512: 128 blocks, 3 splits
// of 192 keys) takes 3 * 8192 rows, 25.4 MB.
extern "C" int flash_attention_plan(int B, int S, int H, int KV, int KVLEN, int* splits,
                                    int* keys_per_split, long long* ws_rows) {
  if (!shapes_ok(B, S, H, KV, KVLEN)) return int(cudaErrorInvalidValue);
  plan(B, S, H, KV, KVLEN, splits, keys_per_split);
  *ws_rows = (long long)B * KV * ((S * (H / KV) + kRows - 1) / kRows) * kRows;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller allocates `out` and, when `splits` > 1, the f32 workspaces ws_o
// [splits, ws_rows, head_dim] and ws_ml [splits, ws_rows, 2]. The strides are
// in elements. `keys_per_split` and `splits` must be flash_attention_plan's:
// anything else is refused with cudaErrorInvalidValue.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* positions, void* out, void* ws_o, void* ws_ml,
                                    int B, int S, int H, int KV, int head_dim, int KVLEN,
                                    long long k_bstride, long long v_bstride, float scale,
                                    float softcap, int keys_per_split, int splits,
                                    void* stream) {
  if (!shapes_ok(B, S, H, KV, KVLEN) || k_bstride % 8 != 0 || v_bstride % 8 != 0)
    return int(cudaErrorInvalidValue);
  int want_splits = 0, want_kps = 0;
  plan(B, S, H, KV, KVLEN, &want_splits, &want_kps);
  if (splits != want_splits || keys_per_split != want_kps) return int(cudaErrorInvalidValue);
  if (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, positions, out, ws_o, ws_ml, B, S, H, KV, KVLEN,
                        k_bstride, v_bstride, scale, softcap, keys_per_split, splits, s);
    case 128:
      return launch<128>(q, k, v, positions, out, ws_o, ws_ml, B, S, H, KV, KVLEN,
                         k_bstride, v_bstride, scale, softcap, keys_per_split, splits, s);
    case 256:
      return launch<256>(q, k, v, positions, out, ws_o, ws_ml, B, S, H, KV, KVLEN,
                         k_bstride, v_bstride, scale, softcap, keys_per_split, splits, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
