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
// Design, and where it differs from the TPU kernel:
// - The TPU grid (batch, head, q tile) held one head's whole KV context in
//   VMEM and looped over KV tiles. Here one block owns one (batch, KV head,
//   tile of 32 query rows) and walks the keys itself, 32 keys per step, into
//   shared memory. Row r of a KV head is query column r / G of query head
//   kvh*G + r % G (G = H / KV), so the G heads that share a KV head read each
//   K/V row once (GQA by grouping, not by repeating heads).
// - Causal skipping: the block stops at the largest position among its rows,
//   clamped to KVLEN - 1 (the TPU kernel's clamp of its tile count). Bucket
//   padding rows carry positions past the prompt, so a tile can reach further
//   than its valid rows; still no key at or past KVLEN is read.
// - head_dim is a template parameter (64, 128, 256). At 256 a block's tiles
//   (32 query rows in f32, 32 keys and values in bf16, the probabilities) take
//   about 70 KB of shared memory, above the 48 KB default: the launch raises
//   the limit with cudaFuncSetAttribute.
// - -inf arithmetic: exp(-inf - (-inf)) is NaN, so the rescale factor is 0
//   while the running max is still -inf (the TPU kernel's guard), masked keys
//   carry probability 0, and a row whose normaliser is 0 (no visible key)
//   writes exact zeros.
// - Numerics as the TPU kernel has them: scores, the running max and sum, and
//   the accumulator in f32; the optional softcap (tanh(s / c) * c) before the
//   mask; P rounded to bf16 before P.V while the normaliser sums the unrounded
//   P; the output in bf16.
//
// What bounds it on an H100: a Gemma-7B prefill of 512 tokens is about 4 *
// S^2 / 2 * HD * H = 4.4 GFLOP per layer, far above its bytes, so the FLOPs.
// This first version computes both products on the CUDA cores in f32 (no
// tensor cores, no TMA, no split over keys): it is written to be right.
// Making it fast (wgmma, TMA, a pipelined K/V ring) is later work; its times
// stand in PERF.md beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block (= 32)
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
  static constexpr size_t kVecBytes = size_t(3) * kRows * sizeof(float);
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

__device__ __forceinline__ int warp_max_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int32_t* __restrict__ positions,
                       __nv_bfloat16* __restrict__ out, int S, int H, int KV,
                       int KVLEN, long long k_bstride, long long v_bstride,
                       float scale, float softcap) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes + L::kKBytes);
  float* sP = reinterpret_cast<float*>(smem + L::kQBytes + L::kKBytes + L::kVBytes);
  float* sAlpha = sP + kRows * kPStride;
  float* sL = sAlpha + kRows;
  int* sPos = reinterpret_cast<int*>(sL + kRows);

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = H / KV;
  const int r_end = min(r0 + kRows, S * G);

  // Row r of this tile -> its place in q/out.
  auto row_offset = [&](int r) -> size_t {
    const int s = r / G;
    const int h = kvh * G + r % G;
    return ((size_t(b) * S + s) * H + h) * HD;
  };

  // Each row's position (-1 for rows past the end: they see no key), and the
  // last key any row of the tile sees, clamped to the cache.
  if (warp == 0) {
    const int r = r0 + lane;  // kRows == 32: one row per lane
    const int p = r < r_end ? positions[size_t(b) * S + r / G] : -1;
    sPos[lane] = p;
    const int pmax = warp_max_int(p);
    if (lane == 0) sL[0] = __int_as_float(min(pmax, KVLEN - 1));
  }
  __syncthreads();
  const int kv_last = __float_as_int(sL[0]);
  if (kv_last < 0) {
    // No row of the tile sees a key: exact zeros.
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < (r_end - r0) * (HD / 2); i += kThreads) {
      const int r = r0 + i / (HD / 2);
      reinterpret_cast<__nv_bfloat162*>(out + row_offset(r))[i % (HD / 2)] = z;
    }
    return;
  }

  // Queries of the tile, in f32 (zeros for rows past the end).
  for (int i = tid; i < kRows * (HD / 2); i += kThreads) {
    const int rr = i / (HD / 2);
    const int d2 = i % (HD / 2);
    const int r = r0 + rr;
    float2 val = make_float2(0.f, 0.f);
    if (r < r_end) {
      val = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(q + row_offset(r))[d2]);
    }
    reinterpret_cast<float2*>(sQ + rr * HD)[d2] = val;
  }

  int my_pos[kRowsPerWarp];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    my_pos[i] = sPos[warp * kRowsPerWarp + i];
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int col = tid % L::kColThreads;
  const int rg = tid / L::kColThreads;
  float acc[L::kAccRows];
#pragma unroll
  for (int a = 0; a < L::kAccRows; ++a) acc[a] = 0.f;

  const size_t kbase_b = size_t(b) * size_t(k_bstride);
  const size_t vbase_b = size_t(b) * size_t(v_bstride);
  const int n_steps = kv_last / kKeys + 1;
  for (int step = 0; step < n_steps; ++step) {
    const int kbase = step * kKeys;

    // This step's K/V rows, 16 bytes a load; keys past kv_last are zeros.
    for (int i = tid; i < kKeys * (HD / 8); i += kThreads) {
      const int kk = i / (HD / 8);
      const int c8 = i % (HD / 8);
      const int kv = kbase + kk;
      uint4 kvec = make_uint4(0u, 0u, 0u, 0u);
      uint4 vvec = kvec;
      if (kv <= kv_last) {
        const size_t off = (size_t(kv) * KV + kvh) * HD + c8 * 8;
        kvec = *reinterpret_cast<const uint4*>(k + kbase_b + off);
        vvec = *reinterpret_cast<const uint4*>(v + vbase_b + off);
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

    // Softcap, causal mask, and the online softmax update, one row per
    // iteration across the warp.
    const int kv = kbase + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rr = warp * kRowsPerWarp + i;
      const bool valid = kv <= my_pos[i] && kv <= kv_last;
      float sc = s[i] * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      const float sv = valid ? sc : -INFINITY;
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
    const float o = lv != 0.f ? acc[a] / lv : 0.f;
    out[row_offset(r) + col] = __float2bfloat16(o);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* positions,
           void* out, int B, int S, int H, int KV, int KVLEN, long long k_bstride,
           long long v_bstride, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles = (S * (H / KV) + kRows - 1) / kRows;
  const dim3 grid(B, KV, tiles);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(positions),
      static_cast<__nv_bfloat16*>(out), S, H, KV, KVLEN, k_bstride, v_bstride,
      scale, softcap);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched). The caller allocates `out`. The strides
// are in elements.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* positions, void* out, int B, int S,
                                    int H, int KV, int head_dim, int KVLEN,
                                    long long k_bstride, long long v_bstride,
                                    float scale, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || KVLEN <= 0 ||
      k_bstride % 8 != 0 || v_bstride % 8 != 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, positions, out, B, S, H, KV, KVLEN, k_bstride,
                        v_bstride, scale, softcap, s);
    case 128:
      return launch<128>(q, k, v, positions, out, B, S, H, KV, KVLEN, k_bstride,
                         v_bstride, scale, softcap, s);
    case 256:
      return launch<256>(q, k, v, positions, out, B, S, H, KV, KVLEN, k_bstride,
                         v_bstride, scale, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
