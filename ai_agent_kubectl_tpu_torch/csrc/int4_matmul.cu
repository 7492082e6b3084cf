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
// for a Gemma-7B w_gate, 3072 x 24576). At prefill (T of 64 to 512) the
// 2*T*IN*OUT operations: 78 us at 989 TFLOP/s for w_gate at T=512, which only
// wgmma reaches, and only if each weight nibble is unpacked once for many
// tokens.
//
// Design: one warp-specialised kernel for both regimes, one launch a call.
// - A block is one producer warpgroup (one thread issues every copy; it keeps
//   40 registers, 24 where blocks share an SM) and consumer warpgroups, which
//   setmaxnreg gives the rest. A block covers 128 output columns.
// - The producer streams each 128 contraction rows into a ring of
//   shared-memory stages with two TMA copies completing on the stage's "full"
//   mbarrier: x as a 3-D box, two [BN tokens, 64 rows] bf16 sub-tiles in the
//   128-byte swizzle (K-major, wgmma's B layout as it lies; tokens past T come
//   in as zeros), and the packed weight [128 rows, the block's 64 byte
//   columns] in the 64-byte swizzle. Consumers hand a stage back on its
//   "empty" mbarrier, one arrival per warp. A block's stages land at about one
//   per memory round trip however deep the ring, so a stage carries 128 rows.
// - The product runs swapped, y^T = W^T x^T: output columns are wgmma's M,
//   tokens its N (BN), wgmma.mma_async.m64nBNk16.f32.bf16.bf16 with the
//   weights as the register A operand and x from shared memory through a
//   descriptor. wgmma's register A fragment is, warp by warp, mma.sync's
//   m16n8k16 fragment, so the unpacking is the old one: row g of a warp's 16
//   is the LOW nibble of a byte column and row g+8 its HIGH nibble; a thread's
//   four k rows (2c, 2c+1, 2c+8, 2c+9) are four shared-memory loads (the
//   swizzle keeps the lanes of a load in distinct banks), and a nibble becomes
//   bf16 exactly with the magic-number trick: (n ^ 8) | 0x4300 (one lop3) is
//   the bf16 of 136 + n, minus 136. Each nibble is unpacked once per BN
//   tokens. One wgmma.fence covers a batch of two 16-row steps, whose wgmmas
//   then run back to back while the next batch's fragments are built.
// - BN is round_up(T, 8) up to 64 (so T = 40 computes 40 token columns) and
//   128 above; a width that is no power of two is issued as wgmma pieces of
//   64/32/16/8 on the same A registers. Each consumer thread holds two
//   accumulator sets: the current group's partial sum (the first wgmma of a
//   group overwrites it, scale-d = 0) and the running sum, into which each
//   group end folds the partial times its rows' scales. Two sets of 64 at
//   BN = 128 are why BN stops there.
// - Above T = 8 two consumer warpgroups own 64 output columns each (32 byte
//   columns, one a thread). The GEMV (T <= 8, BN = 8, wgmma m64n8k16) is
//   bound by the unpacking, not by the tensor cores: one consumer warpgroup,
//   each thread unpacking two adjacent byte columns (a 16-bit load a row, two
//   m64 wgmmas a step), and three blocks an SM.
// - Schedule: one block per (output tile, token tile); three blocks an SM for
//   the GEMV, two up to BN = 64, one at 128. A grid under half a wave of
//   resident blocks cuts the contraction into slices of whole groups, into at
//   most one wave, and the slices of one output tile are the blocks of one
//   thread-block cluster (at most 16, the H100's non-portable limit; 12 for
//   the GEMV, 8 at BN = 128), only as many as the card holds at once
//   (cudaOccupancyMaxActiveClusters; a cluster's blocks share one GPC). Each
//   rank pushes each chunk of its f32 partials through distributed shared
//   memory to the rank that owns it; after a cluster barrier every rank sums
//   its chunks over the ranks in rank order, rounds once and stores. No
//   workspace, the same bits on every run. A persistent block walking tiles
//   was not built: the split grids are one resident wave, and the unsplit
//   one at T = 512 is 5.8 waves of 128 x 128 tiles. plan_splits below is the
//   one rule; the launch refuses any other split.
//
// Left for later: the GEMV at half its byte bound (its unpacking issues about
// 3.5 instructions a weight byte), a persistent schedule whose epilogue
// overlaps the next tile's loads, stores through shared memory (each thread
// writes single bf16 values), 256 output columns a block at T = 512 (x is
// read from L2 once per 128 columns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 128;           // contraction rows per ring stage
constexpr int kBlk = 64;           // rows of one x sub-tile ([BN, 64] bf16, 128-byte rows)
constexpr int kBatch = 2;          // 16-row steps a wgmma batch (one fence, then back to back)
constexpr int kSMs = 132;
constexpr int kMaxCluster = 16;    // cudaFuncAttributeNonPortableClusterSizeAllowed

// The token tile for T rows: round_up(T, 8) up to 64, 128 above.
int tile_bn(int T) { return T <= 64 ? (T + 7) / 8 * 8 : 128; }

// Byte columns a thread unpacks: two for the GEMV (BN = 8), whose cost is
// the unpacking, one where the accumulators fill the registers. The GEMV's
// block has one consumer warpgroup, the others two: 128 output columns.
constexpr int cols_for(int bn) { return bn == 8 ? 2 : 1; }
constexpr int wgs_for(int bn) { return bn == 8 ? 1 : 2; }
constexpr int kBlockCols = 128;
constexpr int kRowBytes = kBlockCols / 2;  // a weight tile row: the block's byte columns
// Blocks an SM holds.
constexpr int blocks_per_sm(int bn) { return bn > 64 ? 1 : (wgs_for(bn) == 1 ? 3 : 2); }
// The largest cluster: 16 (the H100's non-portable limit) where two blocks
// share an SM; 12 for the GEMV's three (a cluster of 16 would need six SMs
// of one GPC, and fewer of them fit at once than its grid holds); 8 at
// BN = 128.
constexpr int max_cluster(int bn) { return bn > 64 ? 8 : (wgs_for(bn) == 1 ? 12 : kMaxCluster); }

template <int BN_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr bool kWide = BN > 64;
  static constexpr int kBlocksPerSM = blocks_per_sm(BN);
  static constexpr int kConsumers = 128 * wgs_for(BN);
  static constexpr int kThreads = 128 + kConsumers;      // the producer warpgroup first
  static constexpr int kProducerRegs = kWide ? 40 : 24;
  static constexpr int kConsumerRegs = kWide ? 232 : (kConsumers == 128 ? 128 : 104);
  static constexpr int kCols = cols_for(BN);
  static constexpr int kBatches = kBK / (16 * kBatch);   // a stage
  static constexpr int kXBlock = BN * kBlk * 2;
  static constexpr int kXBytes = (kBK / kBlk) * kXBlock; // [kBK/64][BN][64] bf16
  static constexpr int kWBytes = kBK * kRowBytes;       // [kBK, 64] bytes
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kBudget = (kWide ? 196608 : 221184 / kBlocksPerSM) - 2048;  // smem a block
  static constexpr int STAGES = kBudget / kStageBytes < 6 ? kBudget / kStageBytes : 6;
  static constexpr int kRing = STAGES * kStageBytes;
  static constexpr int kSmem = 1024 + kRing + 2 * STAGES * 8;  // 1024: alignment slack
  static_assert(kBatches % 2 == 0 && STAGES >= 2, "batches come in pairs");
  static_assert(kXBlock % 1024 == 0, "128-byte swizzle atoms");
  static_assert(kConsumers * kCols * (BN / 2) * 4 + kMaxCluster * 16 <= kRing,
                "split partials fit the ring");
  static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <=
                    (65536 / (kBlocksPerSM * kThreads)) / 8 * 8 * kThreads,
                "setmaxnreg stays inside the block's registers");
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Four floats into rank `rank`'s shared memory at this block's address
// `local` (16-byte aligned), through distributed shared memory.
__device__ __forceinline__ void st_cluster4(uint32_t local, uint32_t rank, float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Descriptor of a K-major bf16 tile with 128-byte rows in the 128-byte
// swizzle: start address, stride 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Two nibbles (bits 0..3 and 16..19 of v) -> bf16x2 of their signed values:
// (n ^ 8) | 0x4300 is the bf16 of 136 + n (exact), then subtract 136.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(r) : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&r);
  const __nv_bfloat162 magic = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                  __ushort_as_bfloat16(0x4308));
  h = __hsub2(h, magic);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragments of one 16-row step for this thread's COLS adjacent byte
// columns (fragment t from column t): their bytes at k rows 2c and 2c+8 (`ev`
// points at row 2c) and 2c+1 and 2c+9 (`od` at row 2c+1), rows kRowBytes
// apart. Low nibbles -> row g, high nibbles -> row g+8.
template <int COLS>
__device__ __forceinline__ void load_frag(const unsigned char* ev, const unsigned char* od,
                                          uint32_t (&a)[COLS][4]) {
  uint32_t w0, w1, w8, w9;
  if constexpr (COLS == 2) {
    w0 = *reinterpret_cast<const uint16_t*>(ev);
    w1 = *reinterpret_cast<const uint16_t*>(od);
    w8 = *reinterpret_cast<const uint16_t*>(ev + 8 * kRowBytes);
    w9 = *reinterpret_cast<const uint16_t*>(od + 8 * kRowBytes);
  } else {
    w0 = ev[0];
    w1 = od[0];
    w8 = ev[8 * kRowBytes];
    w9 = od[8 * kRowBytes];
  }
#pragma unroll
  for (int t = 0; t < COLS; ++t) {
    const unsigned sel = t | ((4 + t) << 8);  // byte t of each row -> bytes 0 and 2
    const uint32_t v01 = __byte_perm(w0, w1, sel);
    const uint32_t v89 = __byte_perm(w8, w9, sel);
    a[t][0] = nibbles_to_bf16x2(v01);
    a[t][1] = nibbles_to_bf16x2(v01 >> 4);
    a[t][2] = nibbles_to_bf16x2(v89);
    a[t][3] = nibbles_to_bf16x2(v89 >> 4);
  }
}

// The fragments of a batch of 16-row steps from `rows` (the batch's first row of a
// weight tile); this thread's bytes of rows 2c and 2c+1 are at off_ev and
// off_od from there.
template <int COLS>
__device__ __forceinline__ void load_batch(const unsigned char* rows, int off_ev, int off_od,
                                           uint32_t (&a)[kBatch][COLS][4]) {
#pragma unroll
  for (int ks = 0; ks < kBatch; ++ks)
    load_frag<COLS>(rows + 16 * ks * kRowBytes + off_ev, rows + 16 * ks * kRowBytes + off_od,
                    a[ks]);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A from registers, B (K-major)
// through `desc`; acc = 0 overwrites d with the product.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t desc,
                                         uint32_t acc);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                            uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                             uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                             uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                             uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                              uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// One 16-row step over the BN token columns: pieces of 128/64/32/16/8 on the
// same A registers, piece at token OFF reading B rows OFF.. (128 bytes each).
template <int BN, int OFF = 0>
__device__ __forceinline__ void mma_step(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t desc, uint32_t acc) {
  constexpr int left = BN - OFF;
  constexpr int n = left >= 128 ? 128 : left >= 64 ? 64 : left >= 32 ? 32 : left >= 16 ? 16 : 8;
  wgmma_rs<n>(d + OFF / 2, a, desc + ((OFF * 128) >> 4), acc);
  if constexpr (OFF + n < BN) mma_step<BN, OFF + n>(d, a, desc, acc);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kBlocksPerSM)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap qmap, const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int T, int OUT, int gi, int bo, int splits,
                  int gps, int G) {
  constexpr int BN = C::BN, STAGES = C::STAGES, COLS = C::kCols, W = kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                              // [STAGES][kBK/64][BN][64] bf16
  unsigned char* ws = smem + STAGES * C::kXBytes;        // [STAGES][kBK][W] bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kRing);
  uint64_t* empty = full + STAGES;

  const int rank = blockIdx.x % splits;                  // = %cluster_ctarank
  const int t0 = (blockIdx.x / splits) * BN;
  const int cb0 = blockIdx.y * W;
  const int g0 = rank * gps;
  const int g1 = min(G, g0 + gps);
  const int k_begin = g0 * gi;
  const int spg = gi / kBK;                              // stages per group
  const int n_stages = (g1 - g0) * spg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_stages; ++it) {
        const int slot = it % STAGES;
        mbar_wait(&empty[slot], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[slot], C::kXBytes + C::kWBytes);
        const int k = k_begin + it * kBK;
        tma_load_3d(xs + slot * C::kXBytes, &xmap, &full[slot], 0, t0, k / kBlk);
        tma_load_2d(ws + slot * C::kWBytes, &qmap, &full[slot], cb0, k);
      }
    }
    __syncwarp();
    if (splits > 1) {
      cluster_sync();  // the rings are free
      cluster_sync();  // the partials have landed
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int ct = threadIdx.x - 128;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  // This thread's COLS byte columns: warpgroup ct/128 owns 32 COLS of the
  // block's, each of its warps 8 COLS; fragment t reads column bl + t.
  const int bl = COLS * (32 * (ct >> 7) + 8 * ((ct >> 5) & 3) + g);
  const int half_bo = bo >> 1;
  int col_lo[COLS], col_hi[COLS];
#pragma unroll
  for (int t = 0; t < COLS; ++t) {
    const int bcol = cb0 + bl + t;
    col_lo[t] = (bcol / half_bo) * bo + bcol % half_bo;
    col_hi[t] = col_lo[t] + half_bo;
  }
  // Its bytes in rows 2c and 2c+1 of a weight tile: the 64-byte swizzle
  // XORs byte bits 4-5 with row bits 1-2, which are c for rows 2c, 2c+1,
  // 2c+8 and 2c+9 of every 16-row step.
  const int off_ev = 2 * c * W + (bl ^ (c << 4));
  const int off_od = off_ev + W;

  float part[COLS][BN / 2], run[COLS][BN / 2];
#pragma unroll
  for (int t = 0; t < COLS; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[t][i] = run[t][i] = 0.f;
  // The A fragments of a batch of kBatch 16-row steps, double-buffered by
  // batch: one wgmma.fence covers a batch's wgmmas, which then run back to
  // back while the next batch's fragments are built.
  uint32_t a[2][kBatch][COLS][4];

  int slot = 0;
  uint32_t phase = 0;
  mbar_wait(&full[0], 0);
  load_batch<COLS>(ws, off_ev, off_od, a[0]);
  int it = 0;
  for (int grp = 0; grp < g1 - g0; ++grp) {
    // This group's scales: in registers long before the fold needs them.
    const float* srow = scale + size_t(g0 + grp) * OUT;
    float s_lo[COLS], s_hi[COLS];
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      s_lo[t] = __ldg(srow + col_lo[t]);
      s_hi[t] = __ldg(srow + col_hi[t]);
    }
    for (int st = 0; st < spg; ++st, ++it) {
      const int nslot = slot + 1 == STAGES ? 0 : slot + 1;
      const uint32_t nphase = slot + 1 == STAGES ? phase ^ 1 : phase;
      const unsigned char* wt = ws + slot * C::kWBytes;
#pragma unroll
      for (int b = 0; b < C::kBatches; ++b) {
        const int P = b & 1;
        const int row = 16 * kBatch * b;  // first contraction row of the batch
        const uint64_t dx = desc_sw128(
            smem_u32(xs + slot * C::kXBytes + (row / kBlk) * C::kXBlock));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBatch; ++ks)
#pragma unroll
          for (int t = 0; t < COLS; ++t) {
            // 16 rows of x are 32 bytes further along each 128-byte row; the
            // group's first step overwrites the partial sums.
            mma_step<BN>(part[t], a[P][ks][t], dx + 2 * ((row % kBlk) / 16 + ks),
                         st + b + ks == 0 ? 0u : 1u);
          }
        wgmma_commit();
        // The batch before is done: at a stage's first batch the stage
        // before goes back to the producer, and the batch's A registers
        // take the next batch's fragments.
        wgmma_wait<1>();
        if (b == 0 && it > 0 && lane == 0)
          mbar_arrive(&empty[slot == 0 ? STAGES - 1 : slot - 1]);
        if (b + 1 < C::kBatches) {
          load_batch<COLS>(wt + (row + 16 * kBatch) * W, off_ev, off_od, a[P ^ 1]);
        } else if (it + 1 < n_stages) {
          mbar_wait(&full[nslot], nphase);
          load_batch<COLS>(ws + nslot * C::kWBytes, off_ev, off_od, a[P ^ 1]);
        }
      }
      slot = nslot;
      phase = nphase;
    }
    // Group end: scale the group's f32 partials into the running sum.
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      fence_regs(part[t]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        run[t][4 * j + 0] = fmaf(part[t][4 * j + 0], s_lo[t], run[t][4 * j + 0]);
        run[t][4 * j + 1] = fmaf(part[t][4 * j + 1], s_lo[t], run[t][4 * j + 1]);
        run[t][4 * j + 2] = fmaf(part[t][4 * j + 2], s_hi[t], run[t][4 * j + 2]);
        run[t][4 * j + 3] = fmaf(part[t][4 * j + 3], s_hi[t], run[t][4 * j + 3]);
      }
    }
  }

  if (splits == 1) {
    // Fragment (row g, token 8j+2c+e) of tile t is column col_lo[t], row
    // g+8 col_hi[t].
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int token = t0 + 8 * j + 2 * c + e;
        if (token >= T) continue;
        __nv_bfloat16* orow = out + size_t(token) * OUT;
#pragma unroll
        for (int t = 0; t < COLS; ++t) {
          orow[col_lo[t]] = __float2bfloat16(run[t][4 * j + e]);
          orow[col_hi[t]] = __float2bfloat16(run[t][4 * j + 2 + e]);
        }
      }
    return;
  }

  // The partial sums of a tile's chunks (a thread's four values of one
  // 8-token column of one byte column) go to the rank that owns the chunk
  // (f mod splits), into that rank's ring, slot [rank][f / splits]; each
  // rank then sums its chunks over the ranks in rank order, rounds once and
  // stores them. Pushes through distributed shared memory do not wait on
  // the remote block's latency.
  constexpr int NF = COLS * (BN / 8) * C::kConsumers;
  const int K = (NF + splits - 1) / splits;
  float4* recv = reinterpret_cast<float4*>(smem);
  cluster_sync();  // every rank is past its last wgmma: the rings are free
#pragma unroll
  for (int t = 0; t < COLS; ++t)
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int f = (t * (BN / 8) + q) * C::kConsumers + ct;
      st_cluster4(smem_u32(recv + rank * K + f / splits), f % splits,
                  make_float4(run[t][4 * q], run[t][4 * q + 1], run[t][4 * q + 2],
                              run[t][4 * q + 3]));
    }
  cluster_sync();  // every push has landed
  for (int k = ct; k < K && rank + splits * k < NF; k += C::kConsumers) {
    float4 sum = recv[k];
    for (int r = 1; r < splits; ++r) add4(sum, recv[r * K + k]);
    // Chunk f holds values 4q..4q+3 of tile t of consumer thread `src`:
    // tokens 8q + 2c' and the next, each at the low and the high nibble's
    // column.
    const int f = rank + splits * k;
    const int src = f % C::kConsumers, tq = f / C::kConsumers;
    const int t = tq / (BN / 8), q = tq % (BN / 8), sl = src & 31;
    const int bcol = cb0 + COLS * (32 * (src >> 7) + 8 * ((src >> 5) & 3) + (sl >> 2)) + t;
    const int lo = (bcol / half_bo) * bo + bcol % half_bo;
    const int token = t0 + 8 * q + 2 * (sl & 3);
    if (token < T) {
      out[size_t(token) * OUT + lo] = __float2bfloat16(sum.x);
      out[size_t(token) * OUT + lo + half_bo] = __float2bfloat16(sum.z);
    }
    if (token + 1 < T) {
      out[size_t(token + 1) * OUT + lo] = __float2bfloat16(sum.y);
      out[size_t(token + 1) * OUT + lo + half_bo] = __float2bfloat16(sum.w);
    }
  }
}

// How many clusters of `cs` blocks of this configuration the card holds at
// once (cudaOccupancyMaxActiveClusters: the blocks of a cluster share one
// GPC, so the count falls below the SMs' share as clusters grow), asked
// once per device.
template <class C>
int cluster_capacity(int cs) {
  static int asked[16][kMaxCluster + 1];  // the count + 1; 0: not asked yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  int& slot = asked[dev][cs];
  if (slot == 0) {
    auto kern = int4_wgmma_kernel<C>;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, 1, 1);
    cfg.blockDim = dim3(C::kThreads, 1, 1);
    cfg.dynamicSmemBytes = C::kSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem) !=
            cudaSuccess ||
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
      n = 0;
      cudaGetLastError();
    }
    slot = n + 1;
  }
  return slot - 1;
}

int cluster_capacity(int bn, int cs) {
  switch (bn) {
    case 8: return cluster_capacity<Cfg<8>>(cs);
    case 16: return cluster_capacity<Cfg<16>>(cs);
    case 24: return cluster_capacity<Cfg<24>>(cs);
    case 32: return cluster_capacity<Cfg<32>>(cs);
    case 40: return cluster_capacity<Cfg<40>>(cs);
    case 48: return cluster_capacity<Cfg<48>>(cs);
    case 56: return cluster_capacity<Cfg<56>>(cs);
    case 64: return cluster_capacity<Cfg<64>>(cs);
    default: return cluster_capacity<Cfg<128>>(cs);
  }
}

// The contraction split: 1, or the size of the clusters whose slices of
// whole groups sum one output tile. Only a grid under half a wave of
// resident blocks splits, into at most one wave, and only into clusters the
// card holds all at once (every block streams from the start).
int plan_splits(int T, int IN, int OUT, int gi) {
  const int bn = tile_bn(T);
  const int tiles = (OUT / kBlockCols) * ((T + bn - 1) / bn);
  const int slots = blocks_per_sm(bn) * kSMs;
  if (2 * tiles > slots) return 1;
  const int G = IN / gi;
  int want = slots / tiles;
  if (want > max_cluster(bn)) want = max_cluster(bn);
  if (want > G) want = G;
  if (want <= 1) return 1;
  for (int per = (G + want - 1) / want; per < G; ++per) {
    const int splits = (G + per - 1) / per;
    if (cluster_capacity(bn, splits) >= tiles) return splits;
  }
  return 1;
}

template <class C>
cudaError_t launch(const void* x, const void* q, const float* sc, __nv_bfloat16* out, int T,
                   int IN, int OUT, int gi, int bo, int splits, cudaStream_t s) {
  // x [T, IN] bf16 as [IN/64][T][64]: one box is a stage's two sub-tiles
  // of [BN tokens, 64 rows] (tokens past T read as zeros). q [IN, OUT/2]
  // bytes in [kBK, 64] boxes.
  const cuuint64_t xdims[3] = {uint64_t(kBlk), uint64_t(T), uint64_t(IN / kBlk)};
  const cuuint64_t xstrides[2] = {uint64_t(IN) * 2, uint64_t(kBlk) * 2};
  const cuuint32_t xbox[3] = {kBlk, C::BN, kBK / kBlk};
  const cuuint64_t qdims[2] = {uint64_t(OUT / 2), uint64_t(IN)};
  const cuuint64_t qstrides[1] = {uint64_t(OUT / 2)};
  const cuuint32_t qbox[2] = {kRowBytes, kBK};
  CUtensorMap xmap, qmap;
  if (!encode(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, xdims, xstrides, xbox,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qdims, qstrides, qbox,
              CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_64B))
    return cudaErrorInvalidValue;
  auto kern = int4_wgmma_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err == cudaSuccess && splits > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int G = IN / gi;
  const int gps = (G + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((T + C::BN - 1) / C::BN) * splits, OUT / kBlockCols, 1);
  cfg.blockDim = dim3(C::kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (splits > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kern, xmap, qmap, sc, out, T, OUT, gi, bo, splits, gps, G);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// The contraction split for these shapes: the cluster size (1 = none), or 0
// for shapes the kernel does not take. Only a grid under half a wave of
// resident blocks splits (three blocks an SM for the GEMV, two below BN =
// 128, one at 128), into at most one wave, slices of whole groups and none
// empty, at most 16 (8 at BN = 128).
extern "C" int int4_matmul_plan(int T, int IN, int OUT, int group_in) {
  if (T <= 0 || IN <= 0 || OUT <= 0) return 0;
  if (group_in != 128 && group_in != 256 && group_in != 512) return 0;
  if (IN % group_in || OUT % 256) return 0;
  return plan_splits(T, IN, OUT, group_in);
}

// The launch for these shapes: its cluster size (0 for shapes the kernel
// does not take), and in *bn, *grid_x and *grid_y the token tile and the grid
// (token tiles x cluster ranks, output tiles).
extern "C" int int4_matmul_geometry(int T, int IN, int OUT, int group_in, int* bn, int* grid_x,
                                    int* grid_y) {
  const int splits = int4_matmul_plan(T, IN, OUT, group_in);
  if (splits == 0) return 0;
  const int b = tile_bn(T);
  *bn = b;
  *grid_x = ((T + b - 1) / b) * splits;
  *grid_y = OUT / kBlockCols;
  return splits;
}

// Launches on `stream` and returns the launch's error (0 = launched). The
// caller allocates `out`; x and q must be 16-byte aligned (TMA). `splits`
// must be int4_matmul_plan's: anything else is refused with
// cudaErrorInvalidValue before anything launches.
extern "C" int int4_matmul_bf16(const void* x, const void* q, const void* scale, void* out,
                                int T, int IN, int OUT, int group_in, int block_out,
                                int splits, void* stream) {
  if (T <= 0 || IN <= 0 || OUT <= 0 || splits <= 0) return int(cudaErrorInvalidValue);
  if (group_in != 128 && group_in != 256 && group_in != 512) return int(cudaErrorInvalidValue);
  if (block_out != 256 && block_out != 512) return int(cudaErrorInvalidValue);
  if (IN % group_in || OUT % block_out) return int(cudaErrorInvalidValue);
  if (splits != plan_splits(T, IN, OUT, group_in)) return int(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
#define INT4_LAUNCH(N) \
  case N:              \
    return int(launch<Cfg<N>>(x, q, sc, ob, T, IN, OUT, group_in, block_out, splits, s))
  switch (tile_bn(T)) {
    INT4_LAUNCH(8);
    INT4_LAUNCH(16);
    INT4_LAUNCH(24);
    INT4_LAUNCH(32);
    INT4_LAUNCH(40);
    INT4_LAUNCH(48);
    INT4_LAUNCH(56);
    INT4_LAUNCH(64);
    INT4_LAUNCH(128);
  }
#undef INT4_LAUNCH
  return int(cudaErrorInvalidValue);
}

extern "C" const char* int4_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
