// Per-image 256-bin histograms of uint8 images.
//
// Replaces: semantic_segmentation_tpu/ops/pallas_kernels.py,
//   histogram256_pallas / _hist_kernel: (N, H, W) uint8 -> (N, 256) int32
//   counts. The TPU kernel counts by a (rows, W, 256) broadcast-compare and
//   a reduction because Mosaic has no scatter; the card has shared-memory
//   atomics, so this kernel scatters each pixel into its bin instead.
//
// Bound on an H100: bytes. Each pixel is read once (N*H*W bytes) and the
//   (N, 256) int32 counts written once; at (2, 256, 256) that is 131 KB read
//   and 2 KB written, about 0.04 us at 3.35 TB/s. The launch (a few us)
//   dominates: the kernel is launch-bound at every shape the repository
//   uses.
//
// Design: a grid of (chunk, image) blocks, each chunk kChunk pixels of one
//   image, so a small batch still spreads over many SMs. A block of 256
//   threads zeroes a shared 256-bin histogram, adds its chunk into it with
//   shared-memory atomicAdd (four pixels per 32-bit load where the image
//   size and the pointer allow it), and then adds each nonzero bin into the
//   (N, 256) output with one global atomicAdd. The wrapper zeroes the output
//   first. Integer atomics commute, so the counts are exact and do not
//   depend on the order the blocks run in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;   // one bin per thread for the flush
constexpr int kChunk = 4096;    // pixels per block; a multiple of 4

__global__ void __launch_bounds__(kThreads)
histogram256_kernel(const unsigned char* __restrict__ in,
                    int* __restrict__ out, int hw) {
  __shared__ int bins[kBins];
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  bins[tid] = 0;
  __syncthreads();

  const unsigned char* plane = in + (long long)img * hw;
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, hw);
  // 32-bit loads when every image starts on a 4-byte boundary
  if ((hw & 3) == 0 && (reinterpret_cast<uintptr_t>(in) & 3) == 0) {
    const unsigned int* words = reinterpret_cast<const unsigned int*>(plane);
    for (int i = start / 4 + tid; i < end / 4; i += kThreads) {
      const unsigned int v = words[i];
      atomicAdd(&bins[v & 0xffu], 1);
      atomicAdd(&bins[(v >> 8) & 0xffu], 1);
      atomicAdd(&bins[(v >> 16) & 0xffu], 1);
      atomicAdd(&bins[v >> 24], 1);
    }
  } else {
    for (int i = start + tid; i < end; i += kThreads)
      atomicAdd(&bins[plane[i]], 1);
  }
  __syncthreads();

  const int count = bins[tid];
  if (count) atomicAdd(&out[img * kBins + tid], count);
}

}  // namespace

// in: (n, hw) uint8, contiguous; out: (n, 256) int32, zeroed by the caller.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int histogram256(const void* in, void* out, int n, int hw,
                            void* stream) {
  if (n == 0 || hw == 0) return 0;
  const dim3 grid((hw + kChunk - 1) / kChunk, n);
  histogram256_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)in, (int*)out, hw);
  return (int)cudaGetLastError();
}
