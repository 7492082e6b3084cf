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
// interleaved pair). A nibble is two's complement, -8..7.
//
// What bounds it on an H100. At decode (T <= 8) the bytes: the packed weight
// and its scales, IN*OUT/2 + 4*OUT*IN/group_in, over 3.35 TB/s (about 11 us
// for a Gemma-7B w_gate, 3072 x 24576); what stands between the kernel and
// that bound is memory latency, so enough bytes must be in flight on every
// SM. At prefill (T of 64 to 512) the 2*T*IN*OUT operations: 78 us at 989
// TFLOP/s for w_gate at T=512, which only the tensor cores reach.
//
// Design: one kernel for both regimes, on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 accumulate), computing the product swapped,
// y^T = W^T x^T: output columns fill the MMA's 16 M rows, tokens its 8 N
// columns, so a decode step wastes no more than 7 of 8 columns of an MMA that
// costs nothing beside the bytes, and T = 9..64 pads to a multiple of 8.
// - The A operand (weights) is built in registers from the packed bytes. The
//   epilogue maps fragment rows to output columns freely: row g of m-tile t
//   is the LOW nibble of byte column 4g+t and row g+8 its HIGH nibble, so one
//   32-bit shared-memory load of four byte columns of a row feeds four
//   m-tiles, and a thread's four k rows (2c, 2c+1, 2c+8, 2c+9 of a k16 step)
//   are four such loads. A nibble becomes bf16 exactly with the magic-number
//   trick: (n ^ 8) | 0x4300 is the bf16 of 136 + n, minus 136.
// - The B operand (x) comes from shared memory through ldmatrix.
// - Each warp keeps one f32 accumulator for the current group's partial sum
//   and folds it into the main accumulator with the scales of its rows at
//   each group end (a group is 8, 16 or 32 k16 steps), so the scale
//   multiplies the f32 partial, as the function says.
// - The packed bytes and the x tile stream through a ring of shared-memory
//   stages with cp.async (16 bytes a copy, zero-fill past T), so loads of
//   later stages overlap the MMAs of this one.
// - Two configurations: T <= 8 (the GEMV) takes 256 output columns by 8
//   tokens a block and a 6-stage ring (over 40 KB in flight a block); T > 8
//   takes 128 columns by 64 tokens, four warps each 64 columns by 32 tokens.
// - When the grid of output tiles x token tiles is under one block per SM,
//   the contraction is cut into slices of whole groups (grid.z); the slices
//   write f32 partial rows to a workspace and a second kernel sums them in
//   slice order, so the result does not depend on scheduling. The plan is a
//   function of (T, IN, OUT, group_in) only: plan_splits below is the one
//   rule. The wrapper asks int4_matmul_plan for it to size the workspace,
//   and the launch refuses any other.
//
// Left for later: wgmma with the weights as the register A operand (the
// issue rate of mma.sync and of the unpacking caps the prefill well below the
// tensor cores' peak), TMA for the x tile, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;               // contraction rows per stage
constexpr int kSplitBelow = 132;      // split when tiles < one block per SM
constexpr int kTargetBlocks = 264;    // ... aiming for two per SM

template <int WM_, int WN_, int NT_, int STAGES_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, NT = NT_, STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kBB = 32 * WM;            // byte columns per block
  static constexpr int kBN = 8 * NT * WN;        // tokens per block
  static constexpr int kQStride = kBB + 16;      // bytes: conflict-free rows
  static constexpr int kXStride = kBK + 8;       // bf16: conflict-free ldmatrix
  static constexpr int kQBytes = kBK * kQStride;
  static constexpr int kXBytes = kBN * kXStride * 2;
  static constexpr int kStageBytes = kQBytes + kXBytes;
  static constexpr int kSmem = STAGES * kStageBytes;
  static_assert(kQBytes % 16 == 0 && kXBytes % 16 == 0, "16-byte stages");
  static_assert(NT == 1 || NT % 2 == 0, "ldmatrix pairs");
};

// T <= 8: 4 warps side by side over 256 output columns, 8 tokens.
using Skinny = Cfg<4, 1, 1, 6>;
// T > 8: 2 x 2 warps over 128 output columns, 64 tokens.
using Tiled = Cfg<2, 2, 4, 4>;

int plan_splits(int T, int IN, int OUT, int gi) {
  const int tiles = T <= 8 ? (OUT / 2) / Skinny::kBB
                           : ((OUT / 2) / Tiled::kBB) * ((T + Tiled::kBN - 1) / Tiled::kBN);
  if (tiles >= kSplitBelow) return 1;
  const int G = IN / gi;
  int want = (kTargetBlocks + tiles - 1) / tiles;
  if (want > G) want = G;
  const int per = (G + want - 1) / want;
  return (G + per - 1) / per;
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two nibbles (bits 0..3 and 16..19 of v) -> bf16x2 of their signed values:
// (n ^ 8) | 0x4300 is the bf16 of 136 + n (exact), then subtract 136.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  uint32_t r = (v & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&r);
  const __nv_bfloat162 magic = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                  __ushort_as_bfloat16(0x4308));
  h = __hsub2(h, magic);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment of m-tile t from the four words of a thread's k rows
// (2c, 2c+1, 2c+8, 2c+9): byte t of each word; low nibbles -> row g, high
// nibbles -> row g+8.
template <int t>
__device__ __forceinline__ void unpack_a(uint32_t w0, uint32_t w1, uint32_t w8, uint32_t w9,
                                         uint32_t a[4]) {
  constexpr unsigned sel = t | (t << 4) | ((4 + t) << 8) | ((4 + t) << 12);
  const uint32_t v01 = __byte_perm(w0, w1, sel);
  const uint32_t v89 = __byte_perm(w8, w9, sel);
  a[0] = nibbles_to_bf16x2(v01);
  a[1] = nibbles_to_bf16x2(v01 >> 4);
  a[2] = nibbles_to_bf16x2(v89);
  a[3] = nibbles_to_bf16x2(v89 >> 4);
}

// m-tile t of one k16 step against every live n-tile of the warp.
template <int t, int NT>
__device__ __forceinline__ void mma_tile(uint32_t w0, uint32_t w1, uint32_t w8, uint32_t w9,
                                         const uint32_t (&bf)[NT][2], float (&pt)[NT][4],
                                         int live_nt) {
  uint32_t a[4];
  unpack_a<t>(w0, w1, w8, w9, a);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < live_nt) mma_bf16(pt[j], a, bf[j]);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                float* __restrict__ part, int T, int IN, int OUT, int gi, int bo,
                int gps) {
  constexpr int WM = C::WM, NT = C::NT, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int half_bo = bo >> 1;
  const int row_bytes = OUT >> 1;
  const int cb0 = blockIdx.x * C::kBB;
  const int t0 = blockIdx.y * C::kBN;
  const int G = IN / gi;
  const int g0 = blockIdx.z * gps;
  const int g1 = min(G, g0 + gps);
  const int k_begin = g0 * gi;
  const int steps_per_group = gi / kBK;
  const int n_steps = (g1 - g0) * steps_per_group;

  // This thread's four byte columns b..b+3 and their output columns.
  const int b = cb0 + 32 * wm + 4 * g;
  const int col_lo = (b / half_bo) * bo + b % half_bo;
  const int col_hi = col_lo + half_bo;
  const int n_warp = 8 * NT * wn;  // first token of this warp in the tile
  int live_nt = (T - t0 - n_warp + 7) / 8;
  live_nt = live_nt < 0 ? 0 : (live_nt > NT ? NT : live_nt);

  auto load_stage = [&](int step, int slot) {
    unsigned char* sq = smem + slot * C::kStageBytes;
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(sq + C::kQBytes);
    const int k0 = k_begin + step * kBK;
    constexpr int kQChunks = kBK * C::kBB / 16;
#pragma unroll
    for (int i = tid; i < kQChunks; i += C::kThreads) {
      const int r = i / (C::kBB / 16);
      const int cc = i % (C::kBB / 16);
      cp_async16(sq + r * C::kQStride + cc * 16,
                 q + size_t(k0 + r) * row_bytes + cb0 + cc * 16, 16);
    }
    constexpr int kXChunks = C::kBN * kBK / 8;
#pragma unroll
    for (int i = tid; i < kXChunks; i += C::kThreads) {
      const int r = i / (kBK / 8);
      const int cc = i % (kBK / 8);
      const bool ok = t0 + r < T;
      const __nv_bfloat16* src = x + size_t(ok ? t0 + r : 0) * IN + k0 + cc * 8;
      cp_async16(sx + r * C::kXStride + cc * 8, src, ok ? 16 : 0);
    }
  };

  float acc[4][NT][4];
  float p[4][NT][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[t][j][e] = 0.f;
        p[t][j][e] = 0.f;
      }
  float4 s_lo = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s_hi = s_lo;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < n_steps; ++it) {
    if (it % steps_per_group == 0) {
      // This group's scales: in registers long before the fold needs them.
      const float* srow = scale + size_t(g0 + it / steps_per_group) * OUT;
      s_lo = __ldg(reinterpret_cast<const float4*>(srow + col_lo));
      s_hi = __ldg(reinterpret_cast<const float4*>(srow + col_hi));
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; stage it-1 is no longer read
    {
      const int nx = it + STAGES - 1;
      if (nx < n_steps) load_stage(nx, nx % STAGES);
      cp_async_commit();
    }

    if (live_nt > 0) {
      const unsigned char* sq = smem + (it % STAGES) * C::kStageBytes;
      const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(sq + C::kQBytes);
      const unsigned char* qb = sq + 32 * wm + 4 * g;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const int kr = ks * 16 + 2 * c;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qb + kr * C::kQStride);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qb + (kr + 1) * C::kQStride);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(qb + (kr + 8) * C::kQStride);
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(qb + (kr + 9) * C::kQStride);
        uint32_t bf[NT][2];
        const int mi = (lane >> 3) & 3;
        if constexpr (NT == 1) {
          const __nv_bfloat16* pb =
              sx + (n_warp + (lane & 7)) * C::kXStride + ks * 16 + (mi & 1) * 8;
          ldmatrix_x2(bf[0], pb);
        } else {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            const __nv_bfloat16* pb = sx +
                                      (n_warp + (j + (mi >> 1)) * 8 + (lane & 7)) * C::kXStride +
                                      ks * 16 + (mi & 1) * 8;
            uint32_t r[4];
            ldmatrix_x4(r, pb);
            bf[j][0] = r[0];
            bf[j][1] = r[1];
            bf[j + 1][0] = r[2];
            bf[j + 1][1] = r[3];
          }
        }
        mma_tile<0>(w0, w1, w8, w9, bf, p[0], live_nt);
        mma_tile<1>(w0, w1, w8, w9, bf, p[1], live_nt);
        mma_tile<2>(w0, w1, w8, w9, bf, p[2], live_nt);
        mma_tile<3>(w0, w1, w8, w9, bf, p[3], live_nt);
      }
    }

    if ((it + 1) % steps_per_group == 0) {
      // Group end: scale the group's f32 partials into the accumulator.
      const float lo[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
      const float hi[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[t][j][0] = fmaf(p[t][j][0], lo[t], acc[t][j][0]);
          acc[t][j][1] = fmaf(p[t][j][1], lo[t], acc[t][j][1]);
          acc[t][j][2] = fmaf(p[t][j][2], hi[t], acc[t][j][2]);
          acc[t][j][3] = fmaf(p[t][j][3], hi[t], acc[t][j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) p[t][j][e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  // Fragment (row g, token 2c+e) of m-tile t is column col_lo + t, and row
  // g+8 is col_hi + t: four consecutive columns per token and half.
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int token = t0 + n_warp + 8 * j + 2 * c + e;
      if (token >= T) continue;
      if (gridDim.z == 1) {
        __nv_bfloat16* orow = out + size_t(token) * OUT;
        const __nv_bfloat162 l01 = __floats2bfloat162_rn(acc[0][j][e], acc[1][j][e]);
        const __nv_bfloat162 l23 = __floats2bfloat162_rn(acc[2][j][e], acc[3][j][e]);
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(acc[0][j][2 + e], acc[1][j][2 + e]);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(acc[2][j][2 + e], acc[3][j][2 + e]);
        uint2 lo, hi;
        lo.x = *reinterpret_cast<const uint32_t*>(&l01);
        lo.y = *reinterpret_cast<const uint32_t*>(&l23);
        hi.x = *reinterpret_cast<const uint32_t*>(&h01);
        hi.y = *reinterpret_cast<const uint32_t*>(&h23);
        *reinterpret_cast<uint2*>(orow + col_lo) = lo;
        *reinterpret_cast<uint2*>(orow + col_hi) = hi;
      } else {
        float* prow = part + (size_t(blockIdx.z) * T + token) * OUT;
        *reinterpret_cast<float4*>(prow + col_lo) =
            make_float4(acc[0][j][e], acc[1][j][e], acc[2][j][e], acc[3][j][e]);
        *reinterpret_cast<float4*>(prow + col_hi) =
            make_float4(acc[0][j][2 + e], acc[1][j][2 + e], acc[2][j][2 + e], acc[3][j][2 + e]);
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

template <class C>
cudaError_t launch_mma(const __nv_bfloat16* x, const uint8_t* q, const float* sc,
                       __nv_bfloat16* out, float* part, int T, int IN, int OUT, int gi,
                       int bo, int splits, cudaStream_t s) {
  auto kern = int4_mma_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const int G = IN / gi;
  const int gps = (G + splits - 1) / splits;
  const dim3 grid((OUT / 2) / C::kBB, (T + C::kBN - 1) / C::kBN, splits);
  kern<<<grid, C::kThreads, C::kSmem, s>>>(x, q, sc, out, part, T, IN, OUT, gi, bo, gps);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// The contraction split for these shapes: the number of slices (1 = none),
// or 0 for shapes the kernel does not take. A split grid has under
// kSplitBelow tiles and at most kTargetBlocks / tiles + 1 slices, so the
// workspace [splits, T, OUT] f32 stays under 4 * (264 + 132) * 128 * 64
// bytes (12.9 MB) for T > 8 and 4 * (264 + 132) * 256 * 8 (3.2 MB) below.
extern "C" int int4_matmul_plan(int T, int IN, int OUT, int group_in) {
  if (T <= 0 || IN <= 0 || OUT <= 0) return 0;
  if (group_in != 128 && group_in != 256 && group_in != 512) return 0;
  if (IN % group_in || OUT % 256) return 0;
  return plan_splits(T, IN, OUT, group_in);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller allocates `out` and, when `splits` > 1, the f32 workspace
// [splits, T, OUT]. `splits` must be int4_matmul_plan's: anything else is
// refused with cudaErrorInvalidValue.
extern "C" int int4_matmul_bf16(const void* x, const void* q, const void* scale,
                                void* out, void* workspace, int T, int IN, int OUT,
                                int group_in, int block_out, int splits,
                                void* stream) {
  if (T <= 0 || IN <= 0 || OUT <= 0 || splits <= 0) return int(cudaErrorInvalidValue);
  if (group_in != 128 && group_in != 256 && group_in != 512) return int(cudaErrorInvalidValue);
  if (block_out != 256 && block_out != 512) return int(cudaErrorInvalidValue);
  if (IN % group_in || OUT % block_out) return int(cudaErrorInvalidValue);
  if (splits != plan_splits(T, IN, OUT, group_in)) return int(cudaErrorInvalidValue);
  if (splits > 1 && workspace == nullptr) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sc = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(workspace);
  const cudaError_t err =
      T <= 8 ? launch_mma<Skinny>(xb, qb, sc, ob, part, T, IN, OUT, group_in, block_out,
                                  splits, s)
             : launch_mma<Tiled>(xb, qb, sc, ob, part, T, IN, OUT, group_in, block_out,
                                 splits, s);
  if (err != cudaSuccess || splits == 1) return int(err);
  const size_t n = size_t(T) * OUT;
  int4_reduce_kernel<<<unsigned((n + 255) / 256), 256, 0, s>>>(part, ob, splits, n);
  return int(cudaGetLastError());
}

extern "C" const char* int4_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
