// 4x4 stride-2 pad-1 convolution, no bias, forward, as one implicit GEMM.
//
// Replaces: scripts/bench_conv_down.py, conv_pallas: the k4-s2-p1 down-conv
//   of the unet_256 generator and the PatchGAN, (B, H, W, C_in) NHWC bf16
//   and an HWIO (4, 4, C_in, C_out) bf16 kernel -> (B, H/2, W/2, C_out)
//   bf16, products accumulated in f32. As a GEMM: M = B*Ho*Wo output pixels,
//   N = C_out, K = 16*C_in, with row m = (b, oy, ox), column k = (dy, dx, c)
//   in the order of w.reshape(16*C_in, C_out), and
//   A[m, k] = x[b, 2*oy + dy - 1, 2*ox + dx - 1, c] (0 in the halo).
//   The TPU kernel's four-phase pre-split, eight slab DMAs, lane padding of
//   C to 128 and column padding are Mosaic workarounds and are not carried
//   over: here the A tile is gathered straight from the NHWC input, and no
//   patch matrix exists in device memory.
//
// Bound on an H100: at the flagship's layers (batch 2) either the tensor
//   cores (2*M*N*K flops over 989 TFLOP/s: 2.15 GFLOP, 2.17 us, for the
//   128^2..32^2 layers) or the bytes of the 16*C_in*C_out bf16 weight
//   (8.4 MB, 2.5 us, for the 512-channel layers at 16^2..2^2).
//
// Design (a first, simple kernel): one block of 128 threads (4 warps) per
//   64x64 output tile, looping over K in steps of 32. Each step the threads
//   gather the 64x32 A tile and copy the 32x64 B tile (the HWIO weight is
//   already K x N row-major) into shared memory, with 16-byte loads where
//   C_in and C_out are multiples of 8 (eight consecutive k then lie in one
//   tap, contiguous in memory) and element loads otherwise; each warp then
//   multiplies its 32x32 part with bf16 wmma 16x16x16 fragments into f32
//   accumulators. The epilogue goes through shared memory and writes bf16
//   NHWC rows, coalesced along C_out. Any C_in >= 1 and any M compute right
//   (rows past M and columns past K or C_out are zero-filled and masked),
//   but small-M layers (2x2 input: M = 2) use one 64-row tile for 2 rows
//   and walk all of K serially: split-K, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kThreads = 128;
constexpr int LDA = BK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // floats

struct Shape {
  int H, W, C, Ho, Wo, Cout, M, K;
};

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads)
conv_down4_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, Shape s) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int hw_out = s.Ho * s.Wo;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // vector A path: this thread fills rows tid/4 and tid/4 + 32, 8-wide
  // chunk tid%4 of each; the rows are fixed, so decode them once
  int a_row[2], a_iy0[2], a_ix0[2];
  long long a_img[2];
  bool a_ok[2];
  if (kVecA) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a_row[r] = (tid >> 2) + 32 * r;
      const int m = m0 + a_row[r];
      a_ok[r] = m < s.M;
      const int mm = a_ok[r] ? m : 0;
      const int b = mm / hw_out, rem = mm % hw_out;
      a_iy0[r] = 2 * (rem / s.Wo) - 1;
      a_ix0[r] = 2 * (rem % s.Wo) - 1;
      a_img[r] = (long long)b * s.H * s.W * s.C;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < s.K; k0 += BK) {
    // ---- A tile: BM x BK gathered from the NHWC input ----
    if (kVecA) {
      const int chunk = tid & 3;
      const int k = k0 + chunk * 8;          // K % 32 == 0 on this path
      const int tap = k / s.C, c = k - tap * s.C;
      const int dy = tap >> 2, dx = tap & 3;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int iy = a_iy0[r] + dy, ix = a_ix0[r] + dx;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (a_ok[r] && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
          v = *reinterpret_cast<const uint4*>(
              x + a_img[r] + ((long long)iy * s.W + ix) * s.C + c);
        *reinterpret_cast<uint4*>(&As[a_row[r] * LDA + chunk * 8]) = v;
      }
    } else {
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
    // ---- B tile: BK x BN rows of the (K, C_out) weight ----
    if (kVecB) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int slot = tid + r * kThreads;
        const int row = slot >> 3, chunk = slot & 7;
        const int k = k0 + row, n = n0 + chunk * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < s.K && n < s.Cout)           // C_out % 8 == 0 here
          v = *reinterpret_cast<const uint4*>(w + (long long)k * s.Cout + n);
        *reinterpret_cast<uint4*>(&Bs[row * LDB + chunk * 8]) = v;
      }
    } else {
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

  // ---- epilogue: f32 tile through shared memory, bf16 rows out ----
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

template <bool kVecA, bool kVecB>
void launch(const void* x, const void* w, void* y, const Shape& s,
            cudaStream_t stream) {
  const dim3 grid((s.Cout + BN - 1) / BN, (s.M + BM - 1) / BM);
  conv_down4_kernel<kVecA, kVecB><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, s);
}

}  // namespace

// x: (b, h, w, c) bf16 NHWC, contiguous; wt: (4, 4, c, cout) bf16 HWIO,
// contiguous; y: (b, h/2, w/2, cout) bf16, written in full. h and w even,
// b*(h/2)*(w/2) <= 65535*64 (the wrapper checks). Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError() after
// the launch.
extern "C" int conv_down4_bf16(const void* x, const void* wt, void* y, int b,
                               int h, int w, int c, int cout, void* stream) {
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
  const bool vec_a = c % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b =
      cout % 8 == 0 && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec_a && vec_b)
    launch<true, true>(x, wt, y, s, st);
  else if (vec_a)
    launch<true, false>(x, wt, y, s, st);
  else if (vec_b)
    launch<false, true>(x, wt, y, s, st);
  else
    launch<false, false>(x, wt, y, s, st);
  return (int)cudaGetLastError();
}
