// Paged single-query decode attention, for Hopper (sm_90a). One kernel
// template, two entry points:
//
//   paged_decode_bf16       replaces ai_agent_kubectl_tpu/ops/paged_attention.py
//                           ::paged_decode_attention (body _paged_kernel): the
//                           contiguous per-slot caches [N, S, KV, HD];
//   paged_decode_pool_bf16  replaces ::paged_decode_attention_pool (body
//                           _paged_pool_kernel, which runs _paged_kernel): the
//                           shared pool [n_blocks, page, KV, HD] read through
//                           block_tables [N, max_pages]; ::paged_decode_
//                           attention_pool_sharded launches it once per shard.
//
// Per slot n, the one query of each head h at position positions[n] attends
// keys kv <= positions[n] of KV head h / G (G = H / KV, any G >= 1), scale
// 1/sqrt(HD) unless given. A slot whose position is negative writes zeros
// (the TPU kernel's l == 0 row).
//
// Shapes:
//   q, out     [N, H, HD]          bf16, contiguous; N <= kMaxSlots
//   k, v       dense: [N, S, KV, HD] bf16 with a dense inner [S, KV, HD]; the slot
//              stride is an argument, so the model's cache view cache[:, :S]
//              (each slot carries one trash row past S) is read in place
//              pool:  [n_blocks, page, KV, HD] bf16, contiguous; page divides 128
//   positions  [N]                 int32
//   tables     [N, max_pages]      int32 (pool only; entries are clamped to
//                                  [0, n_blocks - 1], so a sentinel is safe)
//
// What it keeps from the TPU kernel:
// - Only keys <= min(positions[n], span - 1) count, and only pages
//   0 .. pos / page are read: a page past the live span (or reached only by
//   a clamped sentinel entry) is never copied. A TMA box copies whole rows,
//   so the stage that holds a slot's last live key also holds rows past it
//   (whatever memory holds, NaN in the tests): their scores are *selected*
//   to -inf, and the one warp whose keys cross the last live key zeroes its
//   V rows past it in shared memory before P.V, since probability 0 times
//   NaN is NaN.
// - Numerics: f32 scores and softmax state; P rounded to bf16 before P.V
//   while the normaliser sums the unrounded P; a row whose normaliser is 0
//   writes zeros; the output in bf16.
// - Repeats are bit-identical (no atomics in a sum; every merge in a fixed
//   order) and a slot's output depends on its own position and the shapes
//   only: moving another slot changes none of its bits.
//
// What bounds it on an H100: the bytes. A decode step reads each slot's
// live K/V rows once and does 4 * G * HD operations per (slot, KV head,
// key): about G operations a byte, against the card's 295. The decode after
// a ring prefill (one Llama-3-8B tp=2 shard, 16 over 4 heads of 128, 8
// slots near 3,000 and 6,000) reads 71.5 MB, 21.4 us at 3.35 TB/s;
// serve_paged's Llama-3-8B decode (8 slots at 212 and 727) 9.2 MB a layer
// call, 2.75 us, so there the fixed cost of the launch and of the first
// dependent loads (positions, then tables, then rows) sets the pace.
//
// Design (the third; the first walked each slot's keys in one block on the
// CUDA cores, the second split the span over a grid of cp.async blocks and
// merged the splits in a second kernel):
// - Work items. A row tile is one (slot, KV head, tile of up to 16 of the G
//   query heads, padded to 16 rows). Its keys are cut into chunks of `chunk`
//   keys, a multiple of 64 fixed by the shapes alone (plan below: N, H, KV,
//   HD and the span max_pages * page or S), never by positions: a slot at
//   position p has min(p, span - 1) / chunk + 1 chunks, so its chunk edges
//   follow from its own position. An item is one chunk of one row tile.
// - The chunk aims at 198 items (3/2 of the 132 SMs) when every slot sits at
//   the span's end, at least 128 KB of K/V rows an item (an item's fixed
//   cost, its first copies' latency and, split, its partial's hand-off and
//   merge, is worth a few microseconds of streaming) and at most the span.
//   At the ring-decode shape (32 row tiles, span 8,256) that is 1,344 keys:
//   its slots near 3,000 and 6,000 give 3 and 5 items a row tile, 128 in
//   all, one wave of the 132 SMs (the second design's split of the span
//   gave 168 blocks of one per SM, 36 of them a second wave). At
//   serve_paged's (64 row tiles, span 1,088 or 1,024) it is 384: a slot at
//   212 is one item.
// - A persistent grid: one block per SM (its shared memory holds no second),
//   never more blocks than the most items the shapes allow. Every block reads
//   the N positions, takes the prefix sum of the items per slot in shared
//   memory and takes a contiguous run of about items / blocks items. The host
//   never reads positions and never waits. Which block takes an item depends
//   on every slot's position; what the item computes does not.
// - A block is one producer warp and two consumer groups of four warps (two
//   at HD 256) that take alternate stages, so two stages are computed at
//   once. The producer issues every K/V copy as a TMA tensor load into a
//   ring of stages, completing on the stage's "full" mbarrier with its byte
//   count; a group hands a stage back on its "empty" mbarrier, one arrival
//   a warp, and issues no K/V copy. The producer walks the same items as
//   the consumers, runs ahead across item boundaries, and skips the empty
//   waits of the ring's first round. A stage is 16 keys a warp of a group
//   (64; 32 at HD 256), K and V, and the ring has 8 stages of 16 KB at HD
//   64 (128 KB), 5 of 32 KB at 128 and at 256 (160 KB): at least three in
//   flight while two are computed. Both maps' descriptors are prefetched
//   while the positions load.
// - The tensor maps describe K and V as they lie in memory: the pool as
//   [n_blocks * page rows, KV, HD], one box a run of min(page, stage) rows of
//   one page for one KV head; the dense cache as [N, S, KV, HD] with its slot
//   stride, one box a stage's rows (rows past S come in as zeros). Boxes are
//   64 columns wide in the 128-byte swizzle (two a row at HD 128, four at
//   256), which keeps ldmatrix free of bank conflicts without padding; the
//   products address the tiles through the same swizzle (attention_mma.cuh's
//   Swizzle128). The maps are encoded once per (pointer, shape, strides) by
//   the wrapper (paged_decode_map_*) and passed as __grid_constant__
//   parameters. The pool's producer warp reads 32 table entries at a time,
//   clamped, and hands them out by shuffle.
// - The products stay on mma.sync.m16n8k16 through attention_mma.cuh's
//   mma_attend_step: the kernel is bound by bytes, and wgmma's 64-row A tile
//   would pad the G = 4 query heads of a GQA row tile to 64 rows, not 16.
//   Each consumer warp runs its own online softmax over its 16 keys of its
//   group's stages. At an item's end the second group's warp w merges into
//   the first's warp w in registers (the two hold the same fragment
//   positions), then the first group's warps merge in warp order, through
//   shared memory (a region of its own, the ring being busy with the next
//   item; rows padded by 8 floats against bank conflicts; only the rows of
//   real query heads). Q tiles are double-buffered (cp.async), the next
//   item's in flight while this one is computed.
// - The merge of a row tile's chunks happens inside the one launch. A row
//   tile of one chunk is written in bf16 at once. Otherwise each item leaves
//   its f32 partial (max, sum, accumulator) in the workspace, then raises the
//   row tile's arrival counter with one acquire-release atomic (which
//   publishes this block's partial and, for the last, acquires the others');
//   the block that arrives last merges the partials in chunk order
//   (attention_mma.cuh's combine_row), writes bf16 and sets the counter back
//   to 0. The counter's atomics order nothing that is summed, so the bits
//   stay fixed.
// - The counters and the workspace belong to one (device, stream): the
//   wrapper allocates them once for each, zeroes the counters once, and
//   grows them for larger shapes. Two launches on one stream never overlap,
//   and each leaves every counter at 0, which also holds under CUDA graph
//   capture. A launch on another stream takes that stream's own buffers.
// - The two layouts are one template; kPool picks how a stage's rows are
//   addressed (page runs through the table, or one box at the slot's rows).
//
// Left for later: the fixed cost of a call at serve_paged's shape (about
// five times its byte bound: the launch, the dependent loads of positions,
// tables and rows, a split row's hand-off); a split of an item's keys finer
// than its row tile's chunks when a batch's live keys are far below its
// span; the table entries of a slot read ahead of its first stage; HD 256
// at the register limit (255, a few spilled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_mma.cuh"
#include "hopper_tma.cuh"

namespace {

using namespace attn;
using namespace hopper;

constexpr int kRows = 16;             // query heads per row tile (padded)
constexpr int kWarpKeys = 16;         // keys per consumer warp per stage
constexpr int kChunkKeys = 64;        // a chunk is a multiple of this
constexpr int kTargetItems = 198;     // items with every slot at the span's end
constexpr int kMinItemBytes = 131072;  // K/V bytes of an item, at least
constexpr int kMaxSlots = 2048;        // N; the prefix sum lives in shared memory
constexpr int kSmemLimit = 232448;    // a block's shared memory on an H100

template <int HD>
struct Layout {
  static constexpr int kGroupWarps = HD == 256 ? 2 : 4;  // the warps that share a stage
  static constexpr int kCWarps = 2 * kGroupWarps;       // two groups, alternate stages
  static constexpr int kConsumers = kCWarps * 32;
  static constexpr int kThreads = kConsumers + 32;      // and the producer warp
  static constexpr int kKeys = kGroupWarps * kWarpKeys;  // keys per stage
  static constexpr int kHalves = HD / 64;               // 128-byte boxes a row
  static constexpr int kTileBytes = kKeys * HD * 2;     // K (or V) of a stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = HD == 64 ? 8 : 5;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kQStride = HD + 8;               // bf16; padded Q rows
  static constexpr int kQBytes = kRows * kQStride * 2;  // one of two Q tiles
  // One group's partials: [warp][row][kOStride] f32, then [warp][row] (m, l).
  // A row is padded by 8 floats: the 8 rows a warp's fragment pieces touch
  // then fall on distinct banks (two wavefronts an access, not eight).
  static constexpr int kOStride = HD + 8;
  static constexpr int kMergeBytes = kGroupWarps * kRows * (kOStride + 2) * 4;
  static constexpr int kQOff = kRing;
  static constexpr int kMergeOff = kQOff + 2 * kQBytes;
  static constexpr int kBarOff = kMergeOff + kMergeBytes;
  static constexpr int kScanOff = kBarOff + 2 * kStages * 8 + 16;  // + the merge flag
  static constexpr int kPreOff = kScanOff + kThreads * 4;
  // 1024: the ring's alignment slack; then the prefix sum, N + 1 entries.
  static constexpr int smem(int N) { return 1024 + kPreOff + 4 * (N + 1); }
  static_assert(smem(kMaxSlots) <= kSmemLimit, "shared memory");
  static_assert(kChunkKeys % kKeys == 0 && kTileBytes % 1024 == 0, "stages");
};

inline int round_up(long long x, int m) { return int((x + m - 1) / m * m); }

// The chunks of a slot at position `pos`: one for a negative position (its
// row tiles write zeros), else min(pos, span - 1) / chunk + 1.
__host__ __device__ inline int slot_chunks(int pos, int span, int chunk) {
  return pos < 0 ? 1 : min(pos, span - 1) / chunk + 1;
}

struct Plan {
  int chunk, max_chunks;
  long long row_tiles;
};

// The one chunk rule (see the note): shapes only.
bool plan(int N, int H, int KV, int head_dim, int span, Plan* p) {
  if (N <= 0 || N > kMaxSlots || KV <= 0 || H % KV != 0 || span <= 0) return false;
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) return false;
  const long long tiles = (long long)N * KV * ((H / KV + kRows - 1) / kRows);
  long long want = ((long long)span * tiles + kTargetItems - 1) / kTargetItems;
  const int floor_keys = kMinItemBytes / (4 * head_dim);
  if (want < floor_keys) want = floor_keys;
  int chunk = round_up(want, kChunkKeys);
  const int whole = round_up(span, kChunkKeys);
  if (chunk > whole) chunk = whole;
  p->chunk = chunk;
  p->max_chunks = (span + chunk - 1) / chunk;
  p->row_tiles = tiles;
  return true;
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  if (dev < 64) cached[dev] = n;
  return n;
}

// One work item, decoded from its index.
struct Item {
  int n, kvh, rt, c, cn, tile, kv_last;  // kv_last < 0: no visible key
};

__device__ __forceinline__ Item item_at(int i, const int* sPre, const int32_t* positions, int N,
                                        int rtiles, int per_slot, int span) {
  int lo = 0, hi = N - 1;  // the last slot whose first item is <= i
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sPre[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  Item it;
  it.n = lo;
  it.cn = (sPre[lo + 1] - sPre[lo]) / per_slot;
  const int j = i - sPre[lo];
  const int t = j / it.cn;  // the row tile within the slot
  it.c = j % it.cn;
  it.kvh = t / rtiles;
  it.rt = t % rtiles;
  it.tile = lo * per_slot + t;
  const int pos = __ldg(positions + lo);
  it.kv_last = pos < 0 ? -1 : min(pos, span - 1);
  return it;
}

// A consumer warp's partial into shared memory: the lane's two fragment
// pieces of each 8 columns of rows g and g + 8 (o_a, o_b), and the rows'
// running max and sum (ml, from the quad's first lane).
// Only the rows of real query heads (ok_a, ok_b) are stored.
template <int HD>
__device__ __forceinline__ void put_partial(const float (&o)[HD / 8][4], float m_a, float m_b,
                                            float l_a, float l_b, float* o_a, float* o_b,
                                            float2* ml, int c, bool ok_a, bool ok_b) {
  if (ok_a) {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(o_a + d * 8) = make_float2(o[d][0], o[d][1]);
    if (c == 0) ml[0] = make_float2(m_a, l_a);
  }
  if (ok_b) {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(o_b + d * 8) = make_float2(o[d][2], o[d][3]);
    if (c == 0) ml[8] = make_float2(m_b, l_b);
  }
}

template <int N_THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N_THREADS) : "memory");
}

template <int HD, bool kPool>
__global__ void __launch_bounds__(Layout<HD>::kThreads, 1)
paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __nv_bfloat16* __restrict__ q,
                    const int32_t* __restrict__ positions, const int32_t* __restrict__ tables,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ counters, int N, int H, int KV, int span, int page,
                    int n_blocks, int max_pages, float scale, int chunk, int max_chunks) {
  using L = Layout<HD>;
  constexpr int ST = L::kStages;
  constexpr int KEYS = L::kKeys;
  constexpr int CW = L::kCWarps;
  constexpr int GW = L::kGroupWarps;
  constexpr int kPieces = HD / 8;  // 16-byte pieces of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* sQbuf = reinterpret_cast<__nv_bfloat16*>(ring + L::kQOff);
  float* sO = reinterpret_cast<float*>(ring + L::kMergeOff);
  float2* sML = reinterpret_cast<float2*>(sO + L::kGroupWarps * kRows * L::kOStride);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kBarOff);
  uint64_t* empty = full + ST;
  volatile int* sFlag = reinterpret_cast<volatile int*>(empty + ST);
  int* sScan = reinterpret_cast<int*>(ring + L::kScanOff);
  int* sPre = reinterpret_cast<int*>(ring + L::kPreOff);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = H / KV;
  const int rtiles = (G + kRows - 1) / kRows;
  const int per_slot = KV * rtiles;
  if (tid == L::kConsumers) {
    // The maps' descriptors, fetched while the positions are.
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap))
                 : "memory");
  }

  // The items of every slot, prefix-summed into sPre: each thread a run of
  // slots, then one warp scans the runs' sums.
  const int seg = (N + L::kThreads - 1) / L::kThreads;
  const int n_lo = min(N, tid * seg);
  const int n_hi = min(N, n_lo + seg);
  int sum = 0;
  for (int n = n_lo; n < n_hi; ++n) sum += slot_chunks(__ldg(positions + n), span, chunk);
  sScan[tid] = sum * per_slot;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kPer = (L::kThreads + 31) / 32;
    int v[kPer], own = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = lane * kPer + i;
      v[i] = idx < L::kThreads ? sScan[idx] : 0;
      own += v[i];
    }
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    int run = incl - own;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = lane * kPer + i;
      if (idx < L::kThreads) sScan[idx] = run;
      run += v[i];
    }
  }
  __syncthreads();
  {
    int run = sScan[tid];
    for (int n = n_lo; n < n_hi; ++n) {
      sPre[n] = run;
      run += slot_chunks(__ldg(positions + n), span, chunk) * per_slot;
    }
    if (n_hi == N) sPre[N] = run;  // every such thread writes the same total
  }
  __syncthreads();
  // total * gridDim.x < 2^32: items are at most 198 + row tiles when a row
  // tile splits, else the row tiles (N * KV * ceil(G / 16)).
  const unsigned total = sPre[N];
  const int i0 = int(blockIdx.x * total / gridDim.x);
  const int i1 = int((blockIdx.x + 1) * total / gridDim.x);
  if (i0 >= i1) return;

  if (warp == CW) {
    // The producer: every K/V copy of the block's items, stage by stage.
    int g = 0;
    int tab_n = -1, tab_base = 0, tab_entry = 0;  // 32 clamped table entries, a lane each
    for (int i = i0; i < i1; ++i) {
      const Item it = item_at(i, sPre, positions, N, rtiles, per_slot, span);
      if (it.kv_last < 0) continue;
      const int k0 = it.c * chunk;
      const int kstop = min(k0 + chunk - 1, it.kv_last);
      for (int key = k0; key <= kstop; key += KEYS, ++g) {
        const int s = g % ST;
        if (g >= ST) mbar_wait(&empty[s], ((g / ST) & 1) ^ 1);  // the first round is free
        unsigned char* dk = ring + s * L::kStageBytes;
        unsigned char* dv = dk + L::kTileBytes;
        if constexpr (kPool) {
          // Page runs of R rows up to the slot's last live page.
          const int R = min(page, KEYS);
          const int p0 = key / page;
          const int boxes = min(KEYS / R, it.kv_last / page - p0 + 1);
          if (lane == 0) mbar_expect_tx(&full[s], uint32_t(boxes) * R * 128 * L::kHalves * 2);
          for (int b = 0; b < boxes; ++b) {
            const int p = p0 + b;
            if (it.n != tab_n || p < tab_base || p >= tab_base + 32) {
              tab_n = it.n;
              tab_base = p;
              const int e = p + lane;
              tab_entry = e < max_pages
                              ? min(max(tables[size_t(it.n) * max_pages + e], 0), n_blocks - 1)
                              : 0;
            }
            const int blk = __shfl_sync(0xffffffffu, tab_entry, p - tab_base);
            const int row = blk * page + key % page;  // key % page: a stage inside a page
            if (lane == 0) {
#pragma unroll
              for (int h = 0; h < L::kHalves; ++h) {
                const int off = h * KEYS * 128 + b * R * 128;
                tma_load_3d(dk + off, &kmap, &full[s], h * 64, it.kvh, row);
                tma_load_3d(dv + off, &vmap, &full[s], h * 64, it.kvh, row);
              }
            }
          }
        } else {
          if (lane == 0) {
            mbar_expect_tx(&full[s], L::kStageBytes);
#pragma unroll
            for (int h = 0; h < L::kHalves; ++h) {
              tma_load_4d(dk + h * KEYS * 128, &kmap, &full[s], h * 64, it.kvh, key, it.n);
              tma_load_4d(dv + h * KEYS * 128, &vmap, &full[s], h * 64, it.kvh, key, it.n);
            }
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // The consumers: group `grp` takes the stages g with g % 2 == grp, its
  // warp `wi` keys wi * 16 .. of each.
  const int g_ = lane >> 2;
  const int c_ = lane & 3;
  const int grp = warp / GW;
  const int wi = warp % GW;
  const size_t ws_rows = size_t(N) * per_slot * max_chunks * kRows;
  float* ws_o = ws;
  float* ws_ml = ws + ws_rows * HD;
  auto load_q = [&](int i, int buf) {
    const Item it = item_at(i, sPre, positions, N, rtiles, per_slot, span);
    const int rows = min(kRows, G - it.rt * kRows);
    const __nv_bfloat16* qt = q + (size_t(it.n) * H + it.kvh * G + it.rt * kRows) * HD;
    __nv_bfloat16* dst = sQbuf + buf * (kRows * L::kQStride);
    for (int x = tid; x < kRows * kPieces; x += L::kConsumers) {
      const int r = x / kPieces;
      const int cc = (x % kPieces) * 8;
      const bool ok = r < rows;
      cp_async16(dst + r * L::kQStride + cc, ok ? qt + r * HD + cc : q, ok ? 16 : 0);
    }
  };
  load_q(i0, 0);
  cp_async_commit();
  int g = 0;
  for (int i = i0; i < i1; ++i) {
    const int buf = (i - i0) & 1;
    cp_async_wait<0>();
    // This item's Q has landed, and every consumer is done with the last
    // item: its Q tile (the next prefetch's target) and its merge.
    consumer_sync<L::kConsumers>();
    if (i + 1 < i1) {
      load_q(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const Item it = item_at(i, sPre, positions, N, rtiles, per_slot, span);
    const int h0 = it.kvh * G + it.rt * kRows;
    const int rows = min(kRows, G - it.rt * kRows);
    __nv_bfloat16* o_tile = out + (size_t(it.n) * H + h0) * HD;
    if (it.kv_last < 0) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int x = tid; x < rows * kPieces; x += L::kConsumers)
        reinterpret_cast<uint4*>(o_tile)[x] = z;
      continue;
    }
    const int k0 = it.c * chunk;
    const int kstop = min(k0 + chunk - 1, it.kv_last);
    const __nv_bfloat16* sQ = sQbuf + buf * (kRows * L::kQStride);

    float o[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    for (int key = k0; key <= kstop; key += KEYS, ++g) {
      if ((g & 1) != grp) continue;
      const int s = g % ST;
      mbar_wait(&full[s], (g / ST) & 1);
      const int kb = key + wi * kWarpKeys;
      if (kb <= kstop) {
        __nv_bfloat16* sK =
            reinterpret_cast<__nv_bfloat16*>(ring + s * L::kStageBytes) + wi * kWarpKeys * 64;
        __nv_bfloat16* sV = sK + KEYS * HD;
        const bool crossing = kb + kWarpKeys - 1 > kstop;
        if (crossing) {
          // V rows past the last live key: zeros, whole 128-byte lines.
          const int keep = kstop - kb + 1;
          const int lines = (kWarpKeys - keep) * L::kHalves;
          for (int x = lane; x < lines * 8; x += 32) {
            const int line = x >> 3;
            const int h = line % L::kHalves;
            const int r = keep + line / L::kHalves;
            reinterpret_cast<uint4*>(sV + h * KEYS * 64 + r * 64)[x & 7] =
                make_uint4(0u, 0u, 0u, 0u);
          }
          __syncwarp();
        }
        mma_attend_step<HD, kWarpKeys, L::kQStride, Swizzle128<KEYS>>(
            sQ, sK, sV, kb, kstop, kstop, crossing, scale, 0.f, o, m_a, m_b, l_a, l_b);
        if (crossing) fence_proxy_async();  // before a later TMA write of the stage
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // The warps' partials merge in a fixed order: group 1's warp wi into
    // group 0's warp wi (in registers; the two hold the same fragment
    // positions), then group 0's warps in warp order, 8 columns a thread, so
    // that the rows leave in whole 16-byte (bf16) or 32-byte (f32) pieces,
    // neighbouring threads on neighbouring pieces.
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    float* o_a = sO + (wi * kRows + g_) * L::kOStride + 2 * c_;  // the lane's pieces of its rows
    float* o_b = o_a + 8 * L::kOStride;
    const bool ok_a = g_ < rows, ok_b = g_ + 8 < rows;  // rows of real query heads
    if (grp == 1)
      put_partial<HD>(o, m_a, m_b, l_a, l_b, o_a, o_b, sML + wi * kRows + g_, c_, ok_a, ok_b);
    consumer_sync<L::kConsumers>();
    if (grp == 0 && ok_a) {
      const float2 pa = sML[wi * kRows + g_];
      const float2 pb = ok_b ? sML[wi * kRows + g_ + 8] : make_float2(-INFINITY, 0.f);
      const float ma = fmaxf(m_a, pa.x), mb = fmaxf(m_b, pb.x);
      const float xa = m_a == -INFINITY ? 0.f : exp2f(m_a - ma);
      const float ya = pa.x == -INFINITY ? 0.f : exp2f(pa.x - ma);
      const float xb = m_b == -INFINITY ? 0.f : exp2f(m_b - mb);
      const float yb = pb.x == -INFINITY ? 0.f : exp2f(pb.x - mb);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const float2 a = *reinterpret_cast<const float2*>(o_a + d * 8);
        o[d][0] = o[d][0] * xa + a.x * ya;
        o[d][1] = o[d][1] * xa + a.y * ya;
      }
      if (ok_b) {
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const float2 b = *reinterpret_cast<const float2*>(o_b + d * 8);
          o[d][2] = o[d][2] * xb + b.x * yb;
          o[d][3] = o[d][3] * xb + b.y * yb;
        }
      }
      l_a = l_a * xa + pa.y * ya;
      l_b = l_b * xb + pb.y * yb;
      m_a = ma;
      m_b = mb;
    }
    if (grp == 0) {
      __syncwarp();  // the warp read its partner's slot; now it writes its own there
      put_partial<HD>(o, m_a, m_b, l_a, l_b, o_a, o_b, sML + wi * kRows + g_, c_, ok_a, ok_b);
    }
    consumer_sync<L::kConsumers>();
    const bool split = it.cn > 1;
    const size_t prow0 = (size_t(it.tile) * max_chunks + it.c) * kRows;
    for (int x = tid; x < rows * kPieces; x += L::kConsumers) {
      const int r = x / kPieces;
      const int col0 = (x % kPieces) * 8;
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < GW; ++w) m = fmaxf(m, sML[w * kRows + r].x);
      float den = 0.f, num[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) num[j] = 0.f;
#pragma unroll
      for (int w = 0; w < GW; ++w) {
        const float2 ml = sML[w * kRows + r];
        const float wt = ml.x == -INFINITY ? 0.f : exp2f(ml.x - m);
        den += wt * ml.y;
        const float* row = sO + (w * kRows + r) * L::kOStride + col0;
        const float4 a = *reinterpret_cast<const float4*>(row);
        const float4 b = *reinterpret_cast<const float4*>(row + 4);
        num[0] += wt * a.x;
        num[1] += wt * a.y;
        num[2] += wt * a.z;
        num[3] += wt * a.w;
        num[4] += wt * b.x;
        num[5] += wt * b.y;
        num[6] += wt * b.z;
        num[7] += wt * b.w;
      }
      if (split) {
        // The item's partial: max (log2 domain), sum, accumulator.
        if (col0 == 0) reinterpret_cast<float2*>(ws_ml)[prow0 + r] = make_float2(m, den);
        float4* dst = reinterpret_cast<float4*>(ws_o + (prow0 + r) * HD + col0);
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
    if (split) {
      // The row tile's last item to arrive merges its chunks in chunk order.
      // One thread publishes the block's partial and acquires the others'
      // with one acquire-release atomic (the barriers order every consumer's
      // stores before it and its acquire before their loads).
      consumer_sync<L::kConsumers>();
      if (tid == 0) {
        int old;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                     : "=r"(old)
                     : "l"(counters + it.tile)
                     : "memory");
        *sFlag = old == it.cn - 1;
      }
      consumer_sync<L::kConsumers>();
      if (*sFlag) {
        const size_t base = size_t(it.tile) * max_chunks * kRows;
        for (int r = warp; r < rows; r += CW)
          combine_row<HD>(ws_o, ws_ml, base + r, kRows, it.cn, o_tile + r * HD);
        if (tid == 0) counters[it.tile] = 0;
      }
    }
  }
}

template <int HD, bool kPool>
cudaError_t launch(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q,
                   const void* positions, const void* tables, void* out, void* ws,
                   void* counters, int N, int H, int KV, int span, int page, int n_blocks,
                   int max_pages, float scale, const Plan& p, cudaStream_t stream) {
  using L = Layout<HD>;
  auto kern = paged_decode_kernel<HD, kPool>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::smem(kMaxSlots));
  if (err != cudaSuccess) return err;
  const long long items = p.row_tiles * p.max_chunks;
  const int grid = int(items < sm_count() ? items : sm_count());
  kern<<<grid, L::kThreads, L::smem(N), stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(tables), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), N, H, KV, span, page, n_blocks,
      max_pages, scale, p.chunk, p.max_chunks);
  return cudaGetLastError();
}

template <bool kPool>
int dispatch(const void* q, const void* kmap, const void* vmap, const void* positions,
             const void* tables, void* out, void* ws, void* counters, int N, int H, int KV,
             int head_dim, int span, int page, int n_blocks, int max_pages, float scale,
             int chunk, void* stream) {
  Plan p;
  if (kmap == nullptr || vmap == nullptr || !plan(N, H, KV, head_dim, span, &p) ||
      p.chunk != chunk)
    return int(cudaErrorInvalidValue);
  if (p.max_chunks > 1 && (ws == nullptr || counters == nullptr)) return int(cudaErrorInvalidValue);
  CUtensorMap km, vm;
  memcpy(&km, kmap, sizeof(km));
  memcpy(&vm, vmap, sizeof(vm));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 64:
      err = launch<64, kPool>(km, vm, q, positions, tables, out, ws, counters, N, H, KV, span,
                              page, n_blocks, max_pages, scale, p, s);
      break;
    case 128:
      err = launch<128, kPool>(km, vm, q, positions, tables, out, ws, counters, N, H, KV, span,
                               page, n_blocks, max_pages, scale, p, s);
      break;
    default:
      err = launch<256, kPool>(km, vm, q, positions, tables, out, ws, counters, N, H, KV, span,
                               page, n_blocks, max_pages, scale, p, s);
  }
  return int(err);
}

// The keys of a stage (a box's rows for the dense cache) at head_dim.
int stage_keys(int head_dim) {
  return head_dim == 256 ? Layout<256>::kKeys : head_dim == 128 ? Layout<128>::kKeys
                                                                : Layout<64>::kKeys;
}

bool head_dim_ok(int head_dim) { return head_dim == 64 || head_dim == 128 || head_dim == 256; }

}  // namespace

// Plain C interface, loaded with ctypes.
//
// The chunk rule for these shapes (span: S for the dense cache, max_pages *
// page for the pool): `*max_chunks` chunks of `*chunk` keys cover the span,
// and there are `*row_tiles` row tiles (N * KV * ceil(G / 16)). Returns 0, or
// cudaErrorInvalidValue for shapes the kernel does not take. When
// max_chunks > 1 a launch needs the int32 counters [row_tiles], zero, and
// the f32 workspace of row_tiles * max_chunks * 16 * (head_dim + 2) floats
// (at most (198 + row_tiles) * 16 * 258 * 4 bytes: under 6.6 MB wherever
// the keys split, since a split needs fewer than 198 row tiles; 1.8 MB at
// the ring-decode shape, 1.6 MB at serve_paged's).
extern "C" int paged_decode_plan(int N, int H, int KV, int head_dim, int span, int* max_chunks,
                                 int* chunk, long long* row_tiles) {
  Plan p;
  if (!plan(N, H, KV, head_dim, span, &p)) return int(cudaErrorInvalidValue);
  *max_chunks = p.max_chunks;
  *chunk = p.chunk;
  *row_tiles = p.row_tiles;
  return 0;
}

// The tensor maps (CUtensorMap, 128 bytes, written to `map`). The dense
// cache [N, S, KV, head_dim] with slot stride `sstride` (elements, a
// multiple of 8) and a dense inner [S, KV, head_dim]; the pool [n_blocks,
// page, KV, head_dim], contiguous. `base` 16-byte aligned. Returns 0 or
// cudaErrorInvalidValue.
extern "C" int paged_decode_map_dense(const void* base, int N, int S, int KV, int head_dim,
                                      long long sstride, void* map) {
  if (!head_dim_ok(head_dim) || N <= 0 || S <= 0 || KV <= 0 || sstride % 8 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {uint64_t(head_dim), uint64_t(KV), uint64_t(S), uint64_t(N)};
  const cuuint64_t strides[3] = {uint64_t(head_dim) * 2, uint64_t(KV) * head_dim * 2,
                                 uint64_t(sstride) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(stage_keys(head_dim)), 1};
  return encode(static_cast<CUtensorMap*>(map), base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dims,
                strides, box, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B)
             ? 0
             : int(cudaErrorInvalidValue);
}

extern "C" int paged_decode_map_pool(const void* base, int n_blocks, int page, int KV,
                                     int head_dim, void* map) {
  if (!head_dim_ok(head_dim) || n_blocks <= 0 || page <= 0 || 128 % page != 0 || KV <= 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {uint64_t(head_dim), uint64_t(KV), uint64_t(n_blocks) * page};
  const cuuint64_t strides[2] = {uint64_t(head_dim) * 2, uint64_t(KV) * head_dim * 2};
  const int rows = page < stage_keys(head_dim) ? page : stage_keys(head_dim);
  const cuuint32_t box[3] = {64, 1, cuuint32_t(rows)};
  return encode(static_cast<CUtensorMap*>(map), base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims,
                strides, box, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B)
             ? 0
             : int(cudaErrorInvalidValue);
}

// Each launches on `stream` and returns the launch's error (0 = launched).
// The caller allocates `out`, encodes the maps of k and v
// (paged_decode_map_*), and, when the plan has more than one chunk, passes
// the zeroed counters and the workspace of its (device, stream). `chunk`
// must be paged_decode_plan's: anything else is refused with
// cudaErrorInvalidValue before anything launches.

// Contiguous per-slot caches: k/v [N, S, KV, head_dim].
extern "C" int paged_decode_bf16(const void* q, const void* kmap, const void* vmap,
                                 const void* positions, void* out, void* ws, void* counters,
                                 int N, int H, int KV, int head_dim, int S, float scale,
                                 int chunk, void* stream) {
  if (S <= 0) return int(cudaErrorInvalidValue);
  return dispatch<false>(q, kmap, vmap, positions, nullptr, out, ws, counters, N, H, KV,
                         head_dim, S, 1, 1, 1, scale, chunk, stream);
}

// The shared pool: k/v [n_blocks, page, KV, head_dim], tables [N, max_pages].
extern "C" int paged_decode_pool_bf16(const void* q, const void* kmap, const void* vmap,
                                      const void* positions, const void* tables, void* out,
                                      void* ws, void* counters, int N, int H, int KV,
                                      int head_dim, int page, int n_blocks, int max_pages,
                                      float scale, int chunk, void* stream) {
  if (n_blocks <= 0 || max_pages <= 0 || page <= 0 || 128 % page != 0)
    return int(cudaErrorInvalidValue);
  return dispatch<true>(q, kmap, vmap, positions, tables, out, ws, counters, N, H, KV, head_dim,
                        max_pages * page, page, n_blocks, max_pages, scale, chunk, stream);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
