// 4x4 stride-2 pad-1 convolution, no bias, forward, as one implicit GEMM.
//
// Replaces: scripts/bench_conv_down.py, conv_pallas: the k4-s2-p1 down-conv
//   of the unet_256 generator and the PatchGAN, (B, H, W, C_in) NHWC bf16
//   and an HWIO (4, 4, C_in, C_out) bf16 kernel -> (B, H/2, W/2, C_out)
//   bf16, products accumulated in f32. As a GEMM: M = B*Ho*Wo output pixels,
//   N = C_out, K = 16*C_in, with row m = (b, oy, ox), column k = (dy, dx, c)
//   in the order of w.reshape(16*C_in, C_out), and
//   A[m, k] = x[b, 2*oy + dy - 1, 2*ox + dx - 1, c] (0 in the halo).
//   The TPU kernel's four-phase pre-split, slab DMAs and lane padding are
//   Mosaic workarounds and are not carried over: the pixel tile is read
//   straight from the NHWC input, and no patch matrix exists in device
//   memory.
//
// Bound on an H100 at the flagship's layers (batch 2):
//   - the tensor cores for G_d2, G_d3, G_d4, D_c1 and D_c2 (2*M*N*K =
//     2.15 GFLOP each, 2.17 us at 989 TFLOP/s). In practice a 64x64 tile
//     re-reads 16 KB from L2 per 0.5 MFLOP, so these layers run at the rate
//     L2 feeds the SMs; the design gives every SM work (>= 132 CTAs) and
//     keeps the tile loads asynchronous (TMA) and several stages deep;
//   - the bytes of the 16*C_in*C_out bf16 weight for G_d5..G_d8 (8.4 MB,
//     2.5 us at 3.35 TB/s; M = 128, 32, 8, 2). Here the design splits K so
//     that 144 to 152 CTAs stream disjoint slices of the weight at once, and
//     for M < 64 swaps the operands (below) so that no 64-row tile carries
//     2 real rows.
//
// Design (the wgmma path: C_in % 8 == 0 and C_out % 8 == 0, every flagship
//   layer). One warpgroup (128 threads) per CTA computes a tile of R output
//   pixels by 64 output channels over a range of K-tiles (64 k each):
//   - the weight tile (64 k x 64 C_out) arrives by TMA through a 2D tensor
//     map over the (16*C_in, C_out) matrix, 128-byte swizzled, completing on
//     the stage's mbarrier. It is C_out-major; wgmma reads it with the
//     transpose flag (MN-major descriptor), so no transposed copy exists;
//   - the pixel tile (R x 64 k) arrives one of two ways. Where C_in % 64 ==
//     0 (a K-tile is 64 channels of one tap) and the tile covers whole
//     output rows or images (x_tma), by one TMA box of a 4D map over NHWC
//     whose traversal stride 2 in H and W picks every second input pixel,
//     started at the tap's offset; out-of-range coordinates are the zero
//     halo. Otherwise by 16-byte cp.async straight from NHWC (with C_in % 8
//     == 0 each 8-channel chunk lies in one tap), zero-fill form (src-size
//     0) for the halo and rows past M, each chunk to its 128-byte-swizzled
//     address, and completion signalled on the same mbarrier
//     (cp.async.mbarrier.arrive);
//   - a ring of 6 (R = 64) to 8 stages in at most 96 KB of dynamic shared
//     memory, so two CTAs share an SM: loads for K-tiles i+1..i+S-1 are in
//     flight while wgmma m64nNk16 runs on tile i;
//   - swap-AB where M < 64 (G_d6..G_d8): Y^T = W^T A^T, so C_out fills
//     wgmma's 64 rows and the R = 8, 16, 32 or 64 pixels sit in its N;
//   - split-K: the plan (ops/conv.py, conv_down4_plan) splits the K-tiles
//     into ranges of k_per_split (the last may be shorter) so that every
//     layer launches >= 132 CTAs. Each CTA writes its f32 partial tile to a
//     workspace; the last CTA of a tile to arrive (a ticket counter that the
//     wrapper zeroes once and the kernel resets) sums the partials in split
//     order 0, 1, ..., loading several splits' partials at once, so the
//     output is the same bit for bit on every call.
// Shapes with C_in or C_out off multiples of 8 (a row of the weight is then
//   no multiple of 16 bytes, which TMA needs) take conv_down4_generic_kernel:
//   element gathers into shared memory and wmma 16x16x16, one 64x64 tile per
//   CTA, no split. The kernels allocate nothing; every kernel of the file
//   carries conv_down4 in its name.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

struct Shape {
  int H, W, C, Ho, Wo, Cout, M, K;
};

// ---------------------------------------------------------------------------
// generic path: any C_in >= 1, any C_out
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kThreads = 128;
constexpr int LDA = BK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // floats

__global__ void __launch_bounds__(kThreads)
conv_down4_generic_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, Shape s) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw_out = s.Ho * s.Wo;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    // A tile: BM x BK gathered element by element from the NHWC input
    {
      const int col = tid & (BK - 1);
      const int k = k0 + col;
      const int tap = k / s.C, c = k - tap * s.C;
      const int dy = tap >> 2, dx = tap & 3;
      for (int row = tid >> 5; row < BM; row += kThreads / BK) {
        const int m = m0 + row;
        __nv_bfloat16 v = zero;
        if (m < s.M && k < s.K) {
          const int b = m / hw_out, rem = m % hw_out;
          const int iy = 2 * (rem / s.Wo) - 1 + dy;
          const int ix = 2 * (rem % s.Wo) - 1 + dx;
          if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
            v = x[(((long long)b * s.H + iy) * s.W + ix) * s.C + c];
        }
        As[row * LDA + col] = v;
      }
    }
    // B tile: BK x BN rows of the (K, C_out) weight
    {
      const int col = tid & (BN - 1);
      for (int row = tid >> 6; row < BK; row += kThreads / BN) {
        const int k = k0 + row, n = n0 + col;
        Bs[row * LDB + col] =
            (k < s.K && n < s.Cout) ? w[(long long)k * s.Cout + n] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: f32 tile through shared memory, bf16 rows out
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * LDC + wn + 16 * j],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  const int col = tid & (BN - 1);
  const int n = n0 + col;
  if (n < s.Cout) {
    for (int row = tid >> 6; row < BM; row += kThreads / BN) {
      const int m = m0 + row;
      if (m < s.M)
        y[(long long)m * s.Cout + n] = __float2bfloat16(Cs[row * LDC + col]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma path: C_in % 8 == 0, C_out % 8 == 0
// ---------------------------------------------------------------------------

constexpr int kBK = 64;                      // k per stage: one 128-byte row

struct Split {
  int tiles_n;       // C_out tiles; blockIdx.x = pixel tile * tiles_n + that
  int k_tiles;       // K / kBK
  int split;         // gridDim.y: K ranges
  int k_per_split;   // K-tiles per range; the last range may be shorter
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
// (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase differs from `parity`. A wait that never
// ends (a lost TMA transaction) traps after about 4e9 cycles (2 s) instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000ll) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1). Offsets
// in bytes: lbo is the stride between 64-element blocks along M/N of an
// MN-major operand (unused for K-major), sbo between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int NR>
__device__ __forceinline__ void fence_operands(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 * bf16, both operands in shared
// memory; TA / TB: 0 = K-major, 1 = MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 8) wgmma_n8<TA, TB>(d, da, db);
  else if constexpr (N == 16) wgmma_n16<TA, TB>(d, da, db);
  else if constexpr (N == 32) wgmma_n32<TA, TB>(d, da, db);
  else wgmma_n64<TA, TB>(d, da, db);
}

constexpr int kTileN = 64;                  // C_out per tile: one TMA box
constexpr int kWBytes = kBK * kTileN * 2;   // the weight tile of a stage
constexpr int kSmemBudget = 96 * 1024;      // two CTAs share an SM

// Stages of a CTA with R-pixel tiles: as many as fit in kSmemBudget, at most
// 8; the shared memory adds the alignment pad and the barriers.
template <int R>
__host__ __device__ constexpr int stages() {
  return kSmemBudget / (kWBytes + R * 128) > 8
             ? 8
             : kSmemBudget / (kWBytes + R * 128);
}
template <int R>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<R>() * (kWBytes + R * 128 + 8);
}

// One warpgroup computes a tile of R output pixels by 64 output channels
// over a range of K-tiles. Without swap (R = 64): wgmma m64n64k16 on the
// pixel tile (A, K-major) and the weight tile (B, MN-major). With swap
// (R = 8, 16, 32 or 64): wgmma m64nRk16 on the weight tile (A, MN-major:
// C_out in wgmma's rows) and the pixel tile (B, K-major). kXTma: the pixel
// tile by one TMA box (xmap), else by cp.async.
template <int R, bool kSwap, bool kXTma>
__global__ void __launch_bounds__(128)
conv_down4_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap,
                        const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ ws, int* __restrict__ tickets,
                        Shape s, Split sp) {
  constexpr int kN = kSwap ? R : kTileN;      // wgmma N
  constexpr int NR = kN / 2;                  // f32 accumulators a thread
  constexpr int kStages = stages<R>();
  constexpr int kXBytes = R * 128;
  constexpr int kChunks = R * 8;              // 16-byte chunks per X stage
  constexpr int kPer = (kChunks + 127) / 128;
  // splits whose partials the reduction loads at once
  constexpr int kBatch = 64 / NR;
  static_assert(kSwap ? (R == 8 || R == 16 || R == 32 || R == 64) : R == 64,
                "tile rows");

  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;    // the swizzle's alignment
  const uint32_t w_base = sbase;
  const uint32_t x_base = sbase + kStages * kWBytes;
  const uint32_t bar_base = x_base + kStages * kXBytes;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int p0 = (tile / sp.tiles_n) * R, n0 = (tile % sp.tiles_n) * kTileN;
  const int kt0 = blockIdx.y * sp.k_per_split;
  const int nk = min(sp.k_tiles, kt0 + sp.k_per_split) - kt0;

  // a stage's barrier completes when its TMA bytes (and, without kXTma,
  // every thread's cp.async copies) have landed
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i)
      mbar_init(bar_base + 8 * i, kXTma ? 1 : 129);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // cp.async: this thread fills chunk j = tid % 8 of rows (tid + 128 u) / 8;
  // the rows are fixed, so decode their pixels once
  const int j = tid & 7;
  const int hw_out = s.Ho * s.Wo;
  long long img[kPer];
  int iy0[kPer], ix0[kPer];
  uint32_t dst[kPer];
  bool ok[kPer], act[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = tid + 128 * u;
    const int row = q >> 3;
    act[u] = q < kChunks;
    const int p = p0 + row;
    ok[u] = act[u] && p < s.M;
    const int pp = ok[u] ? p : 0;
    const int b = pp / hw_out, rem = pp - b * hw_out;
    const int oy = rem / s.Wo;
    iy0[u] = 2 * oy - 1;
    ix0[u] = 2 * (rem - oy * s.Wo) - 1;
    img[u] = (long long)b * s.H * s.W * s.C;
    dst[u] = row * 128 + ((j ^ (row & 7)) << 4);      // 128-byte swizzle
  }
  // TMA: the tile's first pixel, whose box starts at the tap's offset
  const int xb0 = p0 / hw_out, xrem = p0 - xb0 * hw_out;
  const int xoy0 = xrem / s.Wo, xox0 = xrem - xoy0 * s.Wo;

  auto load = [&](int kt, int st) {
    const uint32_t bar = bar_base + 8 * st;
    if constexpr (kXTma) {
      if (tid == 0) {
        const int k = kt * kBK;
        const int tap = k / s.C, c = k - tap * s.C;
        mbar_expect_tx(bar, kWBytes + kXBytes);
        tma_load_2d(w_base + st * kWBytes, &wmap, n0, k, bar);
        tma_load_4d(x_base + st * kXBytes, &xmap, c, 2 * xox0 + (tap & 3) - 1,
                    2 * xoy0 + (tap >> 2) - 1, xb0, bar);
      }
    } else {
      if (tid == 0) {
        mbar_expect_tx(bar, kWBytes);
        tma_load_2d(w_base + st * kWBytes, &wmap, n0, kt * kBK, bar);
      }
      const int k = kt * kBK + j * 8;
      const int tap = k / s.C, c = k - tap * s.C;
      const int dy = tap >> 2, dx = tap & 3;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (!act[u]) continue;
        const int iy = iy0[u] + dy, ix = ix0[u] + dx;
        const bool v = ok[u] && (unsigned)iy < (unsigned)s.H &&
                       (unsigned)ix < (unsigned)s.W;
        const __nv_bfloat16* src =
            v ? x + img[u] + ((long long)iy * s.W + ix) * s.C + c : x;
        cp_async16(x_base + st * kXBytes + dst[u], src, v ? 16 : 0);
      }
      cp_async_arrive(bar);
    }
  };

  float d[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) d[i] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    if (i < nk) load(kt0 + i, i);
  fence_operands(d);
  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    mbar_wait(bar_base + 8 * st, (i / kStages) & 1);   // tile i has landed
    wgmma_fence();
    const uint32_t xs = x_base + st * kXBytes;
    const uint32_t wsm = w_base + st * kWBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // K-major pixel tile: 16 k = 32 bytes along its swizzled rows;
      // MN-major weight tile: 16 k = 16 rows of 128 bytes
      const uint64_t dx_ = smem_desc(xs + kk * 32, 16, 1024);
      const uint64_t dw_ = smem_desc(wsm + kk * 2048, 8192, 1024);
      if constexpr (kSwap) wgmma<kN, 1, 0>(d, dw_, dx_);
      else wgmma<kN, 0, 1>(d, dx_, dw_);
    }
    wgmma_commit();
    wgmma_wait<1>();      // tile i-1's products are done: its stage is free
    const int nx = i + kStages - 1;
    if (nx < nk) load(kt0 + nx, nx % kStages);
  }
  wgmma_wait<0>();
  fence_operands(d);

  if (sp.split > 1) {
    // partial tile to the workspace in accumulator order (coalesced), then
    // the last CTA of the tile sums all partials in split order 0, 1, ...,
    // loading kBatch splits' partials at once
    const size_t per_tile = (size_t)NR * 128;
    float* mine =
        ws + ((size_t)blockIdx.y * gridDim.x + tile) * per_tile + tid;
#pragma unroll
    for (int i = 0; i < NR; ++i) mine[i * 128] = d[i];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(&tickets[tile], 1) == sp.split - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    float tot[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) tot[i] = 0.f;
    for (int s0 = 0; s0 < sp.split; s0 += kBatch) {
      float v[kBatch][NR];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int s2 = s0 + b;
        const float* part =
            ws + ((size_t)s2 * gridDim.x + tile) * per_tile + tid;
        const bool other = s2 < sp.split && s2 != (int)blockIdx.y;
#pragma unroll
        for (int i = 0; i < NR; ++i)
          v[b][i] = other ? __ldcg(part + i * 128) : d[i];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (s0 + b < sp.split) {
#pragma unroll
          for (int i = 0; i < NR; ++i) tot[i] += v[b][i];
        }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) d[i] = tot[i];
    if (tid == 0) tickets[tile] = 0;        // ready for the next call
  }

  // accumulator layout of m64nNk16: thread (warp, lane) holds rows
  // warp*16 + lane/4 (+8) and columns 8*(i/4) + 2*(lane%4) (+1)
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const int r = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane & 3);
    if constexpr (!kSwap) {
      const int p = p0 + r, n = n0 + c;     // C_out % 8 == 0: n+1 < C_out too
      if (p < s.M && n < s.Cout)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)p * s.Cout + n) =
            __floats2bfloat162_rn(d[i], d[i + 1]);
    } else {
      const int n = n0 + r, p = p0 + c;
      if (n < s.Cout) {
        if (p < s.M) y[(long long)p * s.Cout + n] = __float2bfloat16(d[i]);
        if (p + 1 < s.M)
          y[(long long)(p + 1) * s.Cout + n] = __float2bfloat16(d[i + 1]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime's
// entry-point lookup (no -lcuda at link time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int R, bool kSwap>
int launch_wgmma(const CUtensorMap& wmap, const CUtensorMap* xmap,
                 const void* x, void* y, float* ws, int* tickets,
                 const Shape& s, const Split& sp, int tiles,
                 cudaStream_t stream) {
  auto kernel = xmap ? conv_down4_wgmma_kernel<R, kSwap, true>
                     : conv_down4_wgmma_kernel<R, kSwap, false>;
  constexpr int bytes = smem_bytes<R>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(tiles, sp.split), 128, bytes, stream>>>(
      wmap, xmap ? *xmap : wmap, (const __nv_bfloat16*)x, (__nv_bfloat16*)y,
      ws, tickets, s, sp);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, h, w, c) bf16 NHWC, contiguous; wt: (4, 4, c, cout) bf16 HWIO,
// contiguous; y: (b, h/2, w/2, cout) bf16, written in full. h and w even.
// The plan comes from ops/conv.py conv_down4_plan: rows = 0 takes the
// generic kernel; otherwise tiles of rows pixels by 64 channels (rows 64
// without swap; 8, 16, 32 or 64 with swap = 1), the pixel tile by TMA where
// x_tma = 1, and split K ranges of k_per_split K-tiles of 64. With split >
// 1, ws holds split * tiles * rows * 64 floats and tickets (tiles int32,
// zero) the arrival counters, which the kernel leaves at zero. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch; -1 for a plan this file does not
// take, -2 if libcuda's tensor-map encoder is missing, -(100 + CUresult)
// if it refuses a tensor map.
extern "C" int conv_down4_bf16(const void* x, const void* wt, void* y,
                               void* ws, void* tickets, int b, int h, int w,
                               int c, int cout, int rows, int swap, int x_tma,
                               int split, int k_per_split, void* stream) {
  Shape s;
  s.H = h;
  s.W = w;
  s.C = c;
  s.Ho = h / 2;
  s.Wo = w / 2;
  s.Cout = cout;
  s.M = b * s.Ho * s.Wo;
  s.K = 16 * c;
  if (s.M == 0 || cout == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) {
    const dim3 grid((s.M + BM - 1) / BM, (cout + BN - 1) / BN);
    conv_down4_generic_kernel<<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (__nv_bfloat16*)y,
        s);
    return (int)cudaGetLastError();
  }

  Split sp;
  sp.tiles_n = (cout + kTileN - 1) / kTileN;
  sp.k_tiles = s.K / kBK;
  sp.split = split;
  sp.k_per_split = k_per_split;
  const int tiles = (s.M + rows - 1) / rows * sp.tiles_n;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(wt)) & 15) == 0;
  const bool rows_ok = swap ? (rows == 8 || rows == 16 || rows == 32 ||
                               rows == 64)
                            : rows == 64;
  if (c % 8 || cout % 8 || !aligned || !rows_ok || split < 1 ||
      k_per_split < 1 || (long long)(split - 1) * k_per_split >= sp.k_tiles ||
      (long long)split * k_per_split < sp.k_tiles || split > 65535 ||
      (split > 1 && (ws == nullptr || tickets == nullptr)))
    return -1;

  EncodeTiled encode = encode_tiled();
  if (!encode) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)s.K};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t box[2] = {kTileN, kBK};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wt), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(100 + (int)r);

  // the pixel tile as one TMA box of tb images x th output rows x tw output
  // columns, each read from every second input column and row (the rule of
  // ops/conv.py x_tma_box)
  CUtensorMap xm;
  if (x_tma) {
    const int tw = s.Wo < rows ? s.Wo : rows;
    const int th = s.Ho < rows / tw ? s.Ho : rows / tw;
    const int tb = rows / (tw * th);
    if (c % kBK || s.Wo % tw || rows % tw || s.Ho % th || (rows / tw) % th ||
        tb * th * tw != rows || tb > 256)
      return -1;
    const cuuint64_t xd[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)b};
    const cuuint64_t xs[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                              (cuuint64_t)h * w * c * 2};
    const cuuint32_t xbox[4] = {kBK, (cuuint32_t)(2 * tw),
                                (cuuint32_t)(2 * th), (cuuint32_t)tb};
    const cuuint32_t xstr[4] = {1, 2, 2, 1};
    const CUresult rx = encode(
        &xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xd,
        xs, xbox, xstr, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rx != CUDA_SUCCESS) return -(100 + (int)rx);
  }
  const CUtensorMap* xmp = x_tma ? &xm : nullptr;

  float* wsf = (float*)ws;
  int* tk = (int*)tickets;
#define LAUNCH(R, SWAP) \
  launch_wgmma<R, SWAP>(map, xmp, x, y, wsf, tk, s, sp, tiles, st)
  if (!swap) return LAUNCH(64, false);
  switch (rows) {
    case 8: return LAUNCH(8, true);
    case 16: return LAUNCH(16, true);
    case 32: return LAUNCH(32, true);
    default: return LAUNCH(64, true);
  }
#undef LAUNCH
}
