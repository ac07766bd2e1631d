// Bilinear affine warp of an NHWC float32 batch, zero (cval) outside.
//
// Replaces: semantic_segmentation_tpu/ops/pallas_kernels.py,
//   warp_affine_pallas / _warp_kernel. It computes the f32 gather path of
//   semantic_segmentation_tpu/ops/augment.py warp_affine_batch
//   (use_pallas=False), not the TPU kernel: that one rounds the image to bf16
//   and splits its weights hi/lo only because it rides the MXU.
//
// Bound on an H100: bytes. Each output reads at most four input values and
//   writes one; the inverse-affine coefficients are 24 bytes per image. The
//   arithmetic (~20 flops per output) is far below the card's f32 rate, so
//   the floor is (input + output bytes) / 3.35 TB/s. At the trainer's shape
//   (2, 256, 256, 1) that is 1 MiB, about 0.3 us: the launch dominates.
//
// Design: a grid of (x-tiles, row groups, images), so the image and the row
//   come from blockIdx with no division, and 32-bit index arithmetic (the
//   wrapper checks that n*h*w*c < 2^31). Thread block 64 x 4: each thread
//   computes kPix = 4 consecutive x positions of one row, a block 256
//   positions of 4 rows; the six coefficients are read once per block into
//   shared memory, and the row's term b*y + c once per thread. At c == 1 the
//   four outputs leave as one float4 store (when the row is 16-byte aligned,
//   w % 4 == 0); otherwise, as for c == 3, the thread loops over channels
//   with scalar stores. Positions past w are masked. The source coordinate
//   is a*x + (b*y + c) in the order of augment.py, and every product and sum
//   is written with the _rn intrinsics so that nvcc contracts nothing into
//   an FMA: the kernel rounds exactly as the plain PyTorch version does, and
//   the > 0.1 mask that follows it in the trainer agrees bit for bit. The
//   inverse matrices are computed by the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int kPix = 4;          // x positions per thread
constexpr int kTx = 64, kTy = 4;  // threads per block along x and y

__device__ __forceinline__ float tap(const float* __restrict__ plane,
                                     float yi, float xi, int h, int w, int c,
                                     float cval) {
  const bool valid = yi >= 0.f && yi < (float)h && xi >= 0.f && xi < (float)w;
  if (!valid) return cval;
  return plane[((int)yi * w + (int)xi) * c];
}

// one output value at column x of a row whose source terms are (by, dy)
__device__ __forceinline__ float sample(const float* __restrict__ plane,
                                        const float* cf, float by, float byy,
                                        int x, int h, int w, int c,
                                        float cval) {
  const float fxo = (float)x;
  const float sx = __fadd_rn(__fmul_rn(cf[0], fxo), by);
  const float sy = __fadd_rn(__fmul_rn(cf[3], fxo), byy);
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  float v = __fmul_rn(tap(plane, y0, x0, h, w, c, cval), __fmul_rn(gx, gy));
  v = __fadd_rn(v, __fmul_rn(tap(plane, y0, x0 + 1.f, h, w, c, cval),
                             __fmul_rn(fx, gy)));
  v = __fadd_rn(v, __fmul_rn(tap(plane, y0 + 1.f, x0, h, w, c, cval),
                             __fmul_rn(gx, fy)));
  v = __fadd_rn(v, __fmul_rn(tap(plane, y0 + 1.f, x0 + 1.f, h, w, c, cval),
                             __fmul_rn(fx, fy)));
  return v;
}

__global__ void __launch_bounds__(kTx * kTy)
warp_affine_kernel(const float* __restrict__ img,
                   const float* __restrict__ coef, float* __restrict__ out,
                   int h, int w, int c, float cval) {
  __shared__ float cf[6];
  const int b = blockIdx.z;
  if (threadIdx.y == 0 && threadIdx.x < 6)
    cf[threadIdx.x] = coef[6 * b + threadIdx.x];
  __syncthreads();
  const int y = blockIdx.y * kTy + threadIdx.y;
  const int x0 = (blockIdx.x * kTx + threadIdx.x) * kPix;
  if (y >= h || x0 >= w) return;

  const float fyo = (float)y;
  const float by = __fadd_rn(__fmul_rn(cf[1], fyo), cf[2]);
  const float byy = __fadd_rn(__fmul_rn(cf[4], fyo), cf[5]);
  const int plane_off = b * h * w * c;
  float* orow = out + plane_off + (y * w + x0) * c;
  if (c == 1 && x0 + kPix <= w && (w & 3) == 0) {
    const float* plane = img + plane_off;
    float4 v;
    v.x = sample(plane, cf, by, byy, x0, h, w, 1, cval);
    v.y = sample(plane, cf, by, byy, x0 + 1, h, w, 1, cval);
    v.z = sample(plane, cf, by, byy, x0 + 2, h, w, 1, cval);
    v.w = sample(plane, cf, by, byy, x0 + 3, h, w, 1, cval);
    *reinterpret_cast<float4*>(orow) = v;
    return;
  }
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    if (x0 + q >= w) break;
    for (int ch = 0; ch < c; ++ch)
      orow[q * c + ch] = sample(img + plane_off + ch, cf, by, byy, x0 + q, h,
                                w, c, cval);
  }
}

}  // namespace

// img, out: (n, h, w, c) float32, contiguous, n*h*w*c < 2^31 and
// n <= 65535 (the wrapper checks). coef: (n, 6) float32, the first two rows
// of each inverse affine. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() after the launch.
extern "C" int warp_affine_f32(const void* img, const void* coef, void* out,
                               int n, int h, int w, int c, float cval,
                               void* stream) {
  if ((long long)n * h * w * c == 0) return 0;
  const dim3 block(kTx, kTy);
  const dim3 grid((w + kTx * kPix - 1) / (kTx * kPix), (h + kTy - 1) / kTy, n);
  warp_affine_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)coef, (float*)out, h, w, c, cval);
  return (int)cudaGetLastError();
}
