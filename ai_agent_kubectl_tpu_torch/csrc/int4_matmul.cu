// Weight-only int4 matmul over the packed-nibble format, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ai_agent_kubectl_tpu/ops/quant4.py::qmatmul4
// (launcher _int4_matmul_2d, body _int4_matmul_kernel):
//
//   y[t, o] = sum_g scale[g, o] * sum_{i in group g} x[t, i] * w[i, o]
//
// with each group's partial sum in f32, the scale applied to that partial sum,
// and y rounded once to bf16.
//
// Shapes (all contiguous; one layer's slice of a stacked leaf is passed as is):
//   x      [T, IN]               bf16
//   q      [IN, OUT/2]           int8, two nibbles per byte
//   scale  [IN/group_in, OUT]    f32
//   out    [T, OUT]              bf16
// The format is an argument: group_in in {128, 256, 512}, block_out in
// {256, 512}. Within each block_out column block, byte column j holds column j
// in its low nibble and column j + block_out/2 in its high nibble (not an
// interleaved pair). A nibble is sign-extended: low = (b << 28) >> 28,
// high = b >> 4 on the sign-extended byte; values lie in [-7, 7].
//
// Design. A thread reads 4 consecutive bytes of a row (one 32-bit load, 128
// contiguous bytes per warp), which unpack into 4 columns of the block's first
// half and the same 4 columns of its second half: 8 output columns, no shuffle.
// Two paths:
// - T <= 8 (decode): a GEMV over the packed bytes. A block owns 128 byte
//   columns (256 output columns); its 4 warps split each group's rows in four,
//   and the x rows of the group sit in shared memory as f32. When the columns
//   alone give too few blocks to fill 132 SMs, the contraction is cut into
//   slices of whole groups (grid.y); the slices write f32 partial rows to a
//   workspace, and a second kernel sums them in a fixed order, so the result
//   does not depend on scheduling. The TPU grid carried the sum across k-blocks
//   in VMEM scratch; blocks here run in no order, hence the second pass.
// - T > 8 (prefill): a tiled product. A block owns 64 rows x 64 byte columns
//   (128 output columns) and walks the contraction 32 rows at a time: the x tile
//   (transposed) and the unpacked weight tile in shared memory, a 4 x 8 register
//   tile per thread, the group partial scaled into the accumulator at each
//   group end. Each weight byte is read from device memory once per 64 rows.
//
// What bounds it on an H100: at decode the packed bytes and the scales
// (IN*OUT/2 + 4*OUT*IN/group_in), against 3.35 TB/s -- about 11 us for a
// Gemma-7B w_gate (3072 x 24576). At prefill the 2*T*IN*OUT FLOPs; this first
// version runs them on the CUDA cores in f32 (no tensor cores, no TMA, no
// pipelining of the tile loads), written to be right. Making it fast (unpack
// into wgmma operands, TMA rings) is later work; its times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- shared

// The 4 bytes of `word` (byte i at bits 8i..8i+7) -> w[0..3] their low
// nibbles, w[4..7] their high nibbles, each sign-extended.
__device__ __forceinline__ void unpack8(uint32_t word, float w[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = float(int32_t(word << (28 - 8 * i)) >> 28);
    w[4 + i] = float(int32_t(word << (24 - 8 * i)) >> 28);
  }
}

// ----------------------------------------------------- small T (decode)

constexpr int kSkinnyWarps = 4;
constexpr int kSkinnyThreads = kSkinnyWarps * 32;
constexpr int kSkinnyBytes = 32 * 4;  // byte columns per block
constexpr int kMaxGroupIn = 512;

template <int RT>
__global__ void __launch_bounds__(kSkinnyThreads)
int4_skinny_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint32_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int T, int IN, int OUT, int gi, int bo, int gps) {
  __shared__ float sx[RT][kMaxGroupIn];
  __shared__ float sred[kSkinnyWarps - 1][RT][32 * 8 + 4];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words_per_row = OUT / 8;  // OUT/2 bytes, 4 per word
  const int b0 = blockIdx.x * kSkinnyBytes + lane * 4;
  const int half_bo = bo / 2;
  const int col_lo = (b0 / half_bo) * bo + b0 % half_bo;
  const int col_hi = col_lo + half_bo;
  const int G = IN / gi;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(G, g0 + gps);
  const int t0 = blockIdx.z * RT;
  const int nr = min(RT, T - t0);
  const int rows_per_warp = gi / kSkinnyWarps;
  const int kbeg = warp * rows_per_warp;

  float acc[RT][8];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[t][c] = 0.f;

  for (int g = g0; g < g1; ++g) {
    __syncthreads();  // the previous group's reads of sx are done
    for (int i = threadIdx.x; i < RT * gi; i += kSkinnyThreads) {
      const int t = i / gi;
      const int k = i % gi;
      sx[t][k] = t < nr ? __bfloat162float(x[size_t(t0 + t) * IN + size_t(g) * gi + k])
                        : 0.f;
    }
    __syncthreads();

    float p[RT][8];
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int c = 0; c < 8; ++c) p[t][c] = 0.f;
    const uint32_t* qrow =
        q + size_t(g * gi + kbeg) * words_per_row + (b0 >> 2);
#pragma unroll 4
    for (int k = 0; k < rows_per_warp; ++k) {
      const uint32_t word = __ldg(qrow + size_t(k) * words_per_row);
      float w[8];
      unpack8(word, w);
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const float xv = sx[t][kbeg + k];
#pragma unroll
        for (int c = 0; c < 8; ++c) p[t][c] = fmaf(xv, w[c], p[t][c]);
      }
    }
    const float* srow = scale + size_t(g) * OUT;
    float s[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = srow[col_lo + c];
      s[4 + c] = srow[col_hi + c];
    }
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[t][c] = fmaf(p[t][c], s[c], acc[t][c]);
  }

  // The four warps' sums of the same columns, added in a fixed order.
  if (warp > 0) {
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int c = 0; c < 8; ++c) sred[warp - 1][t][lane * 8 + c] = acc[t][c];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    if (t >= nr) break;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[t][c];
#pragma unroll
      for (int w2 = 0; w2 < kSkinnyWarps - 1; ++w2) v += sred[w2][t][lane * 8 + c];
      const int col = c < 4 ? col_lo + c : col_hi + (c - 4);
      const size_t row = size_t(t0 + t);
      if (gridDim.y == 1) {
        out[row * OUT + col] = __float2bfloat16(v);
      } else {
        part[(size_t(blockIdx.y) * T + row) * OUT + col] = v;
      }
    }
  }
}

// Sum the contraction slices' partial rows in slice order, round once.
__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   __nv_bfloat16* __restrict__ out, int splits,
                                   size_t n) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[size_t(s) * n + i];
  out[i] = __float2bfloat16(v);
}

// ------------------------------------------------------- large T (prefill)

constexpr int kTileT = 64;      // rows of x per block
constexpr int kTileB = 64;      // byte columns per block (128 output columns)
constexpr int kTileK = 32;      // contraction rows per step
constexpr int kTileThreads = 256;
constexpr int kSxStride = kTileT + 4;

__global__ void __launch_bounds__(kTileThreads)
int4_tiled_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint32_t* __restrict__ q,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int T, int IN, int OUT,
                  int gi, int bo) {
  __shared__ __align__(16) float sx[kTileK][kSxStride];   // x tile, k-major
  __shared__ __align__(16) float sw[kTileK][2 * kTileB];  // lo cols | hi cols

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // byte columns tx*4 .. tx*4+3 of the tile
  const int words_per_row = OUT / 8;
  const int cb0 = blockIdx.x * kTileB;
  const int half_bo = bo / 2;
  const int col_lo = (cb0 / half_bo) * bo + cb0 % half_bo + tx * 4;
  const int col_hi = col_lo + half_bo;
  const int t0 = blockIdx.y * kTileT;

  float acc[4][8];
  float p[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[i][c] = 0.f;
      p[i][c] = 0.f;
    }

  for (int k0 = 0; k0 < IN; k0 += kTileK) {
    {
      // x tile: 64 rows x 32 columns, 8 bf16 (16 bytes) per thread.
      const int r = tid / 4;
      const int kc = (tid % 4) * 8;
      float v[8];
      if (t0 + r < T) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(x + size_t(t0 + r) * IN + k0 + kc);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          v[2 * e] = f.x;
          v[2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sx[kc + e][r] = v[e];
    }
    // Weight tile: 32 rows x 64 bytes = 16 words a row, unpacked.
    for (int i = tid; i < kTileK * (kTileB / 4); i += kTileThreads) {
      const int kr = i / (kTileB / 4);
      const int wc = i % (kTileB / 4);
      const uint32_t word =
          __ldg(q + size_t(k0 + kr) * words_per_row + (cb0 >> 2) + wc);
      float w[8];
      unpack8(word, w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sw[kr][wc * 4 + e] = w[e];
        sw[kr][kTileB + wc * 4 + e] = w[4 + e];
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sx[kk][ty * 4]);
      const float4 blo = *reinterpret_cast<const float4*>(&sw[kk][tx * 4]);
      const float4 bhi = *reinterpret_cast<const float4*>(&sw[kk][kTileB + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {blo.x, blo.y, blo.z, blo.w, bhi.x, bhi.y, bhi.z, bhi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) p[i][c] = fmaf(av[i], bv[c], p[i][c]);
    }
    __syncthreads();

    if ((k0 + kTileK) % gi == 0) {
      // Group end: scale the group's partial sums into the accumulator.
      const float* srow = scale + size_t(k0 / gi) * OUT;
      float s[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[c] = srow[col_lo + c];
        s[4 + c] = srow[col_hi + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[i][c] = fmaf(p[i][c], s[c], acc[i][c]);
          p[i][c] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + ty * 4 + i;
    if (row >= T) continue;
    __nv_bfloat16* orow = out + size_t(row) * OUT;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      orow[col_lo + c] = __float2bfloat16(acc[i][c]);
      orow[col_hi + c] = __float2bfloat16(acc[i][4 + c]);
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched). The caller allocates `out` and, when
// `splits` > 1, the f32 workspace [splits, T, OUT]. `splits` must be what the
// wrapper's plan gives (whole groups per slice; 1 when T > 8).
extern "C" int int4_matmul_bf16(const void* x, const void* q, const void* scale,
                                void* out, void* workspace, int T, int IN, int OUT,
                                int group_in, int block_out, int splits,
                                void* stream) {
  if (T <= 0 || IN <= 0 || OUT <= 0 || splits <= 0) return int(cudaErrorInvalidValue);
  if (group_in != 128 && group_in != 256 && group_in != 512) return int(cudaErrorInvalidValue);
  if (block_out != 256 && block_out != 512) return int(cudaErrorInvalidValue);
  if (IN % group_in || OUT % block_out) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qw = static_cast<const uint32_t*>(q);
  const auto* sc = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (T <= 8) {
    const int G = IN / group_in;
    const int gps = (G + splits - 1) / splits;
    if ((G + gps - 1) / gps != splits) return int(cudaErrorInvalidValue);
    if (splits > 1 && workspace == nullptr) return int(cudaErrorInvalidValue);
    auto* part = static_cast<float*>(workspace);
    const dim3 grid((OUT / 2) / kSkinnyBytes, splits, 1);
    if (T == 1) {
      int4_skinny_kernel<1><<<grid, kSkinnyThreads, 0, s>>>(
          xb, qw, sc, ob, part, T, IN, OUT, group_in, block_out, gps);
    } else {
      int4_skinny_kernel<8><<<grid, kSkinnyThreads, 0, s>>>(
          xb, qw, sc, ob, part, T, IN, OUT, group_in, block_out, gps);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return int(err);
    const size_t n = size_t(T) * OUT;
    int4_reduce_kernel<<<unsigned((n + 255) / 256), 256, 0, s>>>(part, ob, splits, n);
    return int(cudaGetLastError());
  }
  if (splits != 1) return int(cudaErrorInvalidValue);
  const dim3 grid((OUT / 2) / kTileB, (T + kTileT - 1) / kTileT);
  int4_tiled_kernel<<<grid, kTileThreads, 0, s>>>(xb, qw, sc, ob, T, IN, OUT,
                                                  group_in, block_out);
  return int(cudaGetLastError());
}

extern "C" const char* int4_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
