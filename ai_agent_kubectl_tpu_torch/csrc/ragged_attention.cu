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
// Design, and where it differs from the TPU kernel:
// - The TPU grid (slot, page) carried the online-softmax state from one page
//   to the next in VMEM. Here one block owns one (slot, KV head, tile of 32
//   query rows) and walks the keys itself, 32 keys per step, gathering each
//   key row through the block table (the table is read in the kernel, in place
//   of the TPU's scalar prefetch). Rows are laid out as in the TPU kernel:
//   row r of a KV head is query column r / G of query head kvh*G + r % G, so
//   the G heads sharing one KV head read each K/V row once.
// - Query rows are tiled (32 per block): the TPU kernel held all W*G rows x HD
//   in f32 VMEM, which at a 512-wide prefill of Gemma-2B (G=8, HD=256) is
//   4 MB, far past the 227 KB of shared memory a block may use. Each tile stops
//   at its own last live key, positions[n] + (last live column of the tile).
// - Nothing past that key is ever read: 0 * NaN is NaN, so a masked-out row of
//   a stale or unmapped block would poison the sum. Keys past it are zero in
//   shared memory and carry probability 0.
// - Rows of slots with q_len = 0, padded columns (j >= q_len) and rows whose
//   normaliser is 0 write exact zeros, as the TPU kernel does.
// - Types: q and the pool are bf16; scores, the online softmax (max, sum) and
//   the P.V accumulator are f32; P is rounded to bf16 before P.V (the TPU
//   kernel's pexp.astype(v.dtype)), while the normaliser sums the unrounded P.
//
// What bounds it on an H100: at decode (q_len 1) the bytes of the live K/V
// rows (a few hundred KB per layer) against 3.35 TB/s, so the time is the
// latency of walking the pages; at a long prefill the 4*W*G*kv*HD FLOPs. This
// first version computes both products on the CUDA cores in f32 (no tensor
// cores, no TMA, no split over keys): it is written to be right. Making it
// fast (wgmma, TMA, splitting the keys of a decode step over blocks) is later
// work; its times stand in PERF.md beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per step, one per lane
constexpr int kPStride = kKeys + 4;           // float4-aligned rows of P

template <int HD>
struct Layout {
  // K rows padded by one bf16 pair: an odd word stride puts the 32 keys a
  // warp reads at one column in 32 different banks.
  static constexpr int kKStride = HD + 2;
  static constexpr size_t kQBytes = size_t(kRows) * HD * sizeof(float);
  static constexpr size_t kKBytes = size_t(kKeys) * kKStride * sizeof(__nv_bfloat16);
  static constexpr size_t kVBytes = size_t(kKeys) * HD * sizeof(__nv_bfloat16);
  static constexpr size_t kPBytes = size_t(kRows) * kPStride * sizeof(float);
  static constexpr size_t kVecBytes = size_t(2) * kRows * sizeof(float);
  static constexpr size_t kTotal = kQBytes + kKBytes + kVBytes + kPBytes + kVecBytes;
  // P.V: thread t owns column t % kColThreads of every kRowGroups-th row.
  static constexpr int kColThreads = HD < kThreads ? HD : kThreads;
  static constexpr int kRowGroups = kThreads / kColThreads;
  static constexpr int kAccRows = kRows / kRowGroups;
  static_assert(HD % 8 == 0 && HD <= kThreads, "head_dim must be 64, 128 or 256");
  static_assert(kKBytes % 16 == 0 && kQBytes % 16 == 0, "16-byte alignment");
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
ragged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int32_t* __restrict__ q_lens,
                        const int32_t* __restrict__ positions,
                        const int32_t* __restrict__ tables,
                        __nv_bfloat16* __restrict__ out,
                        int W, int H, int KV, int page, int n_blocks,
                        int max_pages, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes + L::kKBytes);
  float* sP = reinterpret_cast<float*>(smem + L::kQBytes + L::kKBytes + L::kVBytes);
  float* sAlpha = sP + kRows * kPStride;
  float* sL = sAlpha + kRows;

  const int n = blockIdx.x;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = H / KV;
  const int rows_total = W * G;
  const int r_end = min(r0 + kRows, rows_total);
  const int q_len = min(q_lens[n], W);
  const int pos = positions[n];

  // Row r of this tile -> its place in out/q.
  auto row_offset = [&](int r) -> size_t {
    const int j = r / G;
    const int h = kvh * G + r % G;
    return ((size_t(n) * W + j) * H + h) * HD;
  };

  // Last live column of the tile, and the last key any of its rows sees.
  const int j_last = q_len > 0 ? min(q_len - 1, (r_end - 1) / G) : -1;
  const long long kv_cap = (long long)max_pages * page - 1;
  long long kv_last = (long long)pos + j_last;
  if (kv_last > kv_cap) kv_last = kv_cap;
  if (j_last < r0 / G || kv_last < 0) {
    // Dead tile (frozen slot, or only padded columns): exact zeros.
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < (r_end - r0) * (HD / 2); i += kThreads) {
      const int r = r0 + i / (HD / 2);
      reinterpret_cast<__nv_bfloat162*>(out + row_offset(r))[i % (HD / 2)] = z;
    }
    return;
  }

  // Queries of the tile, in f32 (zeros for rows outside [r0, r_end) or past
  // the slot's q_len).
  for (int i = tid; i < kRows * (HD / 2); i += kThreads) {
    const int rr = i / (HD / 2);
    const int d2 = i % (HD / 2);
    const int r = r0 + rr;
    float2 val = make_float2(0.f, 0.f);
    if (r < r_end && r / G < q_len) {
      val = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(q + row_offset(r))[d2]);
    }
    reinterpret_cast<float2*>(sQ + rr * HD)[d2] = val;
  }

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int col = tid % L::kColThreads;
  const int rg = tid / L::kColThreads;
  float acc[L::kAccRows];
#pragma unroll
  for (int a = 0; a < L::kAccRows; ++a) acc[a] = 0.f;

  const int n_steps = int(kv_last / kKeys) + 1;
  for (int step = 0; step < n_steps; ++step) {
    const long long kbase = (long long)step * kKeys;

    // Gather this step's K/V rows through the block table, 16 bytes a load.
    for (int i = tid; i < kKeys * (HD / 8); i += kThreads) {
      const int kk = i / (HD / 8);
      const int c8 = i % (HD / 8);
      const long long kv = kbase + kk;
      uint4 kvec = make_uint4(0u, 0u, 0u, 0u);
      uint4 vvec = kvec;
      if (kv <= kv_last) {
        const int p = int(kv / page);
        const int row = int(kv % page);
        int blk = tables[size_t(n) * max_pages + p];
        blk = min(max(blk, 0), n_blocks - 1);
        const size_t off = ((size_t(blk) * page + row) * KV + kvh) * HD + c8 * 8;
        kvec = *reinterpret_cast<const uint4*>(k + off);
        vvec = *reinterpret_cast<const uint4*>(v + off);
      }
      uint32_t* dk = reinterpret_cast<uint32_t*>(sK + kk * L::kKStride + c8 * 8);
      dk[0] = kvec.x;
      dk[1] = kvec.y;
      dk[2] = kvec.z;
      dk[3] = kvec.w;
      *reinterpret_cast<uint4*>(sV + kk * HD + c8 * 8) = vvec;
    }
    __syncthreads();

    // Scores: warp w owns rows 4w..4w+3 of the tile, lane = key.
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const __nv_bfloat162* krow =
        reinterpret_cast<const __nv_bfloat162*>(sK + lane * L::kKStride);
#pragma unroll 4
    for (int d2 = 0; d2 < HD / 2; ++d2) {
      const float2 kf = __bfloat1622float2(krow[d2]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float2 qf =
            reinterpret_cast<const float2*>(sQ + (warp * kRowsPerWarp + i) * HD)[d2];
        s[i] = fmaf(qf.x, kf.x, s[i]);
        s[i] = fmaf(qf.y, kf.y, s[i]);
      }
    }

    // Mask (causal within the window, live columns only) and the online
    // softmax update, one row per iteration across the warp.
    const long long kv = kbase + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rr = warp * kRowsPerWarp + i;
      const int r = r0 + rr;
      const int j = r / G;
      const bool valid = r < r_end && j < q_len && kv <= (long long)pos + j &&
                         kv <= kv_last;
      const float sv = valid ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      sP[rr * kPStride + lane] = __bfloat162float(__float2bfloat16(p));
      if (lane == 0) sAlpha[rr] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P.V
#pragma unroll
    for (int a = 0; a < L::kAccRows; ++a) acc[a] *= sAlpha[rg + L::kRowGroups * a];
#pragma unroll 2
    for (int kk = 0; kk < kKeys; kk += 4) {
      const float v0 = __bfloat162float(sV[(kk + 0) * HD + col]);
      const float v1 = __bfloat162float(sV[(kk + 1) * HD + col]);
      const float v2 = __bfloat162float(sV[(kk + 2) * HD + col]);
      const float v3 = __bfloat162float(sV[(kk + 3) * HD + col]);
#pragma unroll
      for (int a = 0; a < L::kAccRows; ++a) {
        const float4 pp = *reinterpret_cast<const float4*>(
            sP + (rg + L::kRowGroups * a) * kPStride + kk);
        float x = acc[a];
        x = fmaf(pp.x, v0, x);
        x = fmaf(pp.y, v1, x);
        x = fmaf(pp.z, v2, x);
        x = fmaf(pp.w, v3, x);
        acc[a] = x;
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sL[warp * kRowsPerWarp + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < L::kAccRows; ++a) {
    const int rr = rg + L::kRowGroups * a;
    const int r = r0 + rr;
    if (r >= r_end) continue;
    const float lv = sL[rr];
    const float o = (r / G < q_len && lv != 0.f) ? acc[a] / lv : 0.f;
    out[row_offset(r) + col] = __float2bfloat16(o);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* q_lens,
           const void* positions, const void* tables, void* out, int N, int W,
           int H, int KV, int page, int n_blocks, int max_pages, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<HD>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (W * (H / KV) + kRows - 1) / kRows;
  const dim3 grid(N, KV, tiles);
  ragged_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(q_lens),
      static_cast<const int32_t*>(positions), static_cast<const int32_t*>(tables),
      static_cast<__nv_bfloat16*>(out), W, H, KV, page, n_blocks, max_pages, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched). The caller allocates `out`.
extern "C" int ragged_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* q_lens, const void* positions,
                                     const void* tables, void* out, int N, int W,
                                     int H, int KV, int head_dim, int page,
                                     int n_blocks, int max_pages, float scale,
                                     void* stream) {
  if (N <= 0 || W <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || n_blocks <= 0 ||
      max_pages <= 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, q_lens, positions, tables, out, N, W, H, KV, page,
                        n_blocks, max_pages, scale, s);
    case 128:
      return launch<128>(q, k, v, q_lens, positions, tables, out, N, W, H, KV, page,
                         n_blocks, max_pages, scale, s);
    case 256:
      return launch<256>(q, k, v, q_lens, positions, tables, out, N, W, H, KV, page,
                         n_blocks, max_pages, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* ragged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
