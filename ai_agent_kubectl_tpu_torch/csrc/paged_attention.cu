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
// 1/sqrt(HD) unless given, online softmax in f32. A slot whose position is
// negative writes zeros (the TPU kernel's l == 0 row).
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
// Design, and where it differs from the TPU kernel:
// - The TPU grid (slot, page) carried the online-softmax state of all KV heads
//   from one page to the next in VMEM, clamping dead pages' fetches to the last
//   live page and skipping their compute. Here one block owns one (slot, KV
//   head, tile of up to 8 of the G query heads) and loops over the keys itself.
//   Its 8 warps split the keys: warp w takes the 32-key steps w, w + 8, ...,
//   with its own running max, sum and accumulator, and the 8 partials merge at
//   the end in warp order (a fixed order: the result does not depend on
//   scheduling). Nothing carries over between blocks.
// - Only keys <= min(positions[n], last slot of the cache) are ever read: a
//   lane whose key is past the live span loads nothing, and the P.V loop stops
//   at the last live key. So the pages read are exactly 0 .. pos / page, and a
//   stale or NaN block past the live span (or reached only by a clamped
//   sentinel entry) never reaches the sum. The page is the pool's addressing
//   unit; the dense cache needs none (its span S is page-padded by the caller).
// - The block table is read in the kernel, where the TPU kernel scalar-
//   prefetched it; a block's K/V rows of one KV head are HD contiguous values,
//   read 16 bytes a lane for the scores (lane = key) and HD/32 columns a lane
//   for P.V (coalesced over the row).
// - Numerics as the TPU kernel has them: f32 scores and softmax state; the
//   probabilities exp(s - m_running) rounded to bf16 before P.V while the
//   normaliser sums the unrounded ones; a row whose normaliser is 0 writes
//   zeros; the output in bf16.
//
// What bounds it on an H100: a decode step reads the live K/V rows once
// (Llama-3-8B, 8 slots at about 400 positions: 8 * 400 * 8 heads * 128 * 2 *
// 2 bytes = 13 MB per layer call, about 4 us at 3.35 TB/s) and does 4 * G * HD
// FLOPs per (slot, KV head, key), far below the bytes. So the bytes, and the
// latency of walking them with only N * KV blocks (64 for Llama with 8 slots).
// This first version computes both products on the CUDA cores in f32 and does
// not split the keys over blocks (flash-decoding), use TMA or wgmma: it is
// written to be right. Its times stand in PERF.md beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;   // query heads (of one KV head's group) per block
constexpr int kKeys = 32;  // keys per warp step, one per lane

template <int HD>
struct Layout {
  static constexpr int kCols = HD / 32;  // P.V output columns per lane
  static constexpr size_t kQBytes = size_t(kRows) * HD * sizeof(float);
  static constexpr size_t kPBytes = size_t(kWarps) * kRows * kKeys * sizeof(float);
  static constexpr size_t kAccBytes = size_t(kWarps) * kRows * HD * sizeof(float);
  static constexpr size_t kMLBytes = size_t(2) * kWarps * kRows * sizeof(float);
  static constexpr size_t kTotal = kQBytes + kPBytes + kAccBytes + kMLBytes;
  static_assert(HD == 64 || HD == 128 || HD == 256, "head_dim must be 64, 128 or 256");
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// C consecutive bf16 values (C = 2, 4 or 8; the address aligned to 2C bytes)
// as floats.
template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float* out) {
  if constexpr (C == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (C == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  }
}

// Where key kv of slot n, KV head kvh starts in k (or v): through the block
// table for the pool, by the slot stride for the dense cache.
template <bool kPool>
__device__ __forceinline__ size_t row_offset(int n, int kvh, int kv, int KV, int HD,
                                             const int32_t* __restrict__ tables,
                                             int page, int n_blocks, int max_pages,
                                             long long sstride) {
  if constexpr (kPool) {
    int blk = tables[size_t(n) * max_pages + kv / page];
    blk = min(max(blk, 0), n_blocks - 1);
    return ((size_t(blk) * page + kv % page) * KV + kvh) * HD;
  } else {
    return size_t(n) * size_t(sstride) + (size_t(kv) * KV + kvh) * HD;
  }
}

template <int HD, bool kPool>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int32_t* __restrict__ positions,
                    const int32_t* __restrict__ tables,
                    __nv_bfloat16* __restrict__ out, int H, int KV, int kv_span,
                    int page, int n_blocks, int max_pages, long long k_sstride,
                    long long v_sstride, float scale) {
  using L = Layout<HD>;
  constexpr int C = L::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sP = reinterpret_cast<float*>(smem + L::kQBytes);
  float* sAcc = reinterpret_cast<float*>(smem + L::kQBytes + L::kPBytes);
  float* sM = reinterpret_cast<float*>(smem + L::kQBytes + L::kPBytes + L::kAccBytes);
  float* sL = sM + kWarps * kRows;

  const int n = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int h0 = kvh * G + blockIdx.z * kRows;     // first query head of the tile
  const int rows = min(kRows, G - int(blockIdx.z) * kRows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = positions[n];
  const int kv_last = min(pos, kv_span - 1);
  __nv_bfloat16* o = out + (size_t(n) * H + h0) * HD;

  if (kv_last < 0) {
    // No visible key: zeros.
    for (int i = tid; i < rows * HD; i += kThreads) o[i] = __float2bfloat16(0.f);
    return;
  }

  // The tile's queries in f32; rows past the tile are zeros.
  const __nv_bfloat16* qt = q + (size_t(n) * H + h0) * HD;
  for (int i = tid; i < kRows * HD; i += kThreads) {
    sQ[i] = i < rows * HD ? __bfloat162float(qt[i]) : 0.f;
  }
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  float* wP = sP + warp * kRows * kKeys;

  for (int kbase = warp * kKeys; kbase <= kv_last; kbase += kWarps * kKeys) {
    // Scores: lane = key. A key past the live span is not read.
    const int kv = kbase + lane;
    const bool valid = kv <= kv_last;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    if (valid) {
      const __nv_bfloat16* krow =
          k + row_offset<kPool>(n, kvh, kv, KV, HD, tables, page, n_blocks, max_pages,
                                k_sstride);
#pragma unroll 2
      for (int c8 = 0; c8 < HD; c8 += 8) {
        float kf[8];
        load_cols<8>(krow + c8, kf);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(sQ + r * HD + c8);
          const float4 qb = *reinterpret_cast<const float4*>(sQ + r * HD + c8 + 4);
          float x = s[r];
          x = fmaf(qa.x, kf[0], x);
          x = fmaf(qa.y, kf[1], x);
          x = fmaf(qa.z, kf[2], x);
          x = fmaf(qa.w, kf[3], x);
          x = fmaf(qb.x, kf[4], x);
          x = fmaf(qb.y, kf[5], x);
          x = fmaf(qb.z, kf[6], x);
          x = fmaf(qb.w, kf[7], x);
          s[r] = x;
        }
      }
    }

    // Online softmax, one row at a time across the warp. Lane 0's key is
    // always live here, so the new max is finite.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sv = valid ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      wP[r * kKeys + lane] = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += P.V over this step's live keys; lane owns columns lane*C ..
    const int n_keys = min(kKeys, kv_last - kbase + 1);
    for (int kk = 0; kk < n_keys; ++kk) {
      float vf[C];
      load_cols<C>(v + row_offset<kPool>(n, kvh, kbase + kk, KV, HD, tables, page,
                                         n_blocks, max_pages, v_sstride) +
                       lane * C,
                   vf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = wP[r * kKeys + kk];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(p, vf[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

  // Each warp's partial (a warp that saw no key holds m = -inf, l = 0).
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      sM[warp * kRows + r] = m[r];
      sL[warp * kRows + r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) sAcc[(warp * kRows + r) * HD + lane * C + c] = acc[r][c];
  }
  __syncthreads();

  // Merge the warps' partials in warp order.
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w * kRows + r]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sM[w * kRows + r];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      lsum = fmaf(sL[w * kRows + r], f, lsum);
      osum = fmaf(sAcc[(w * kRows + r) * HD + i % HD], f, osum);
    }
    o[i] = __float2bfloat16(lsum != 0.f ? osum / lsum : 0.f);
  }
}

template <int HD, bool kPool>
int launch(const void* q, const void* k, const void* v, const void* positions,
           const void* tables, void* out, int N, int H, int KV, int kv_span, int page,
           int n_blocks, int max_pages, long long k_sstride, long long v_sstride,
           float scale, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<HD, kPool>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (H / KV + kRows - 1) / kRows;
  const dim3 grid(N, KV, tiles);
  paged_decode_kernel<HD, kPool><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(tables), static_cast<__nv_bfloat16*>(out), H, KV,
      kv_span, page, n_blocks, max_pages, k_sstride, v_sstride, scale);
  return int(cudaGetLastError());
}

template <bool kPool>
int dispatch(const void* q, const void* k, const void* v, const void* positions,
             const void* tables, void* out, int N, int H, int KV, int head_dim,
             int kv_span, int page, int n_blocks, int max_pages, long long k_sstride,
             long long v_sstride, float scale, void* stream) {
  if (N <= 0 || KV <= 0 || H % KV != 0 || kv_span <= 0 || page <= 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, kPool>(q, k, v, positions, tables, out, N, H, KV, kv_span, page,
                               n_blocks, max_pages, k_sstride, v_sstride, scale, s);
    case 128:
      return launch<128, kPool>(q, k, v, positions, tables, out, N, H, KV, kv_span,
                                page, n_blocks, max_pages, k_sstride, v_sstride, scale,
                                s);
    case 256:
      return launch<256, kPool>(q, k, v, positions, tables, out, N, H, KV, kv_span,
                                page, n_blocks, max_pages, k_sstride, v_sstride, scale,
                                s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched). The caller allocates `out`. Strides are in
// elements.

// Contiguous per-slot caches: k/v [N, S, KV, head_dim] with slot strides
// k_sstride / v_sstride and a dense inner [S, KV, head_dim].
extern "C" int paged_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* positions, void* out, int N, int H, int KV,
                                 int head_dim, int S, long long k_sstride,
                                 long long v_sstride, float scale, void* stream) {
  if (S <= 0 || k_sstride % 8 != 0 || v_sstride % 8 != 0)
    return int(cudaErrorInvalidValue);
  return dispatch<false>(q, k, v, positions, nullptr, out, N, H, KV, head_dim, S, 1, 1, 1,
                         k_sstride, v_sstride, scale, stream);
}

// The shared pool: k/v [n_blocks, page, KV, head_dim], tables [N, max_pages].
extern "C" int paged_decode_pool_bf16(const void* q, const void* k, const void* v,
                                      const void* positions, const void* tables,
                                      void* out, int N, int H, int KV, int head_dim,
                                      int page, int n_blocks, int max_pages, float scale,
                                      void* stream) {
  if (n_blocks <= 0 || max_pages <= 0 || page <= 0) return int(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, positions, tables, out, N, H, KV, head_dim,
                        max_pages * page, page, n_blocks, max_pages, 0, 0, scale,
                        stream);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
