// Per-image 256-bin histograms of uint8 images, one thread-block cluster
// per image.
//
// Replaces: semantic_segmentation_tpu/ops/pallas_kernels.py:66,
//   histogram256_pallas / _hist_kernel: (N, H, W) uint8 -> (N, 256) int32
//   counts. The TPU kernel counts by a (rows, W, 256) broadcast-compare and
//   a reduction, one grid step per image, because Mosaic has no scatter;
//   the card has shared-memory atomics, so this kernel scatters each pixel
//   into its bin instead.
//
// Bound on an H100: bytes. Each pixel is read once (N*H*W bytes) and the
//   (N, 256) int32 counts written once: at (4, 256, 256) 262 KB and 4 KB,
//   0.08 us at 3.35 TB/s, far under one launch; at (64, 512, 512) 16.8 MB,
//   5.0 us, where the bound means something.
//
// Design (hist256_cluster.cuh): a cluster of K CTAs per image, grid.x =
//   K x N, so a small batch still spreads over many SMs and the batch has
//   no 65,535 limit. Each CTA counts its contiguous slice with 16-byte
//   loads into shared memory and stores each bin's count into its slot at
//   the CTA that owns the bin (rank r owns bins [r * 256 / K,
//   (r + 1) * 256 / K)), by asynchronous stores to distributed shared
//   memory that the owner's mbarrier counts; once its slots are full each
//   rank adds them and writes its own bins. So one call is one launch: no
//   zeroed output, no global atomics, and the counts are exact and the
//   same bit for bit from call to call.
//
// Skew: a constant or two-valued image sends a warp's adds to one bin; on
//   this card those shared atomics cost no more than spread ones, and
//   adding runs of equal bytes once was no faster (PERF.md), so every byte
//   is one shared add.

#include "hist256_cluster.cuh"

namespace {

using hist256::kBins;
using hist256::Plan;

__global__ void __launch_bounds__(hist256::kThreads, hist256::kMinCtas)
histogram256_kernel(const uint8_t* __restrict__ in, int* __restrict__ out,
                    int hw, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long img = blockIdx.x / p.cluster;
  __shared__ uint64_t bar;
  int* hist = reinterpret_cast<int*>(smem);
  int* slots = hist + kBins;

  hist256::exchange_init(&bar);
  const long long start = (long long)rank * p.slice;
  const long long rest = hw - start;
  const int len = rest <= 0 ? 0 : (rest < p.slice ? (int)rest : p.slice);
  hist256::count_slice(in + img * hw + start, len, start, 1, hist, nullptr);
  hist256::exchange(cl, hist, slots, &bar, kBins, false);
  const int per = kBins / p.cluster;
  int* row = out + img * kBins + rank * per;
  for (int j = threadIdx.x; j < per; j += hist256::kThreads)
    row[j] = hist256::slot_sum(slots, j, per, p.cluster);
}

}  // namespace

// in: (n, hw) uint8, contiguous; out: (n, 256) int32, every entry written.
// The plan's fields are those of ops/image.hist256_plan; smem is its dynamic
// shared bytes. Launches on `stream`, allocates nothing, does not
// synchronise. Returns the launch's CUDA error (cudaErrorInvalidValue for a
// plan the kernel does not take).
extern "C" int histogram256(const void* in, void* out, int n, int hw,
                            int cluster, int slice, int smem,
                            void* stream) {
  if (n == 0) return 0;
  const Plan p{cluster, slice};
  if (!hist256::plan_ok(p, 1) || n < 0 || hw < 0 ||
      (long long)slice * cluster < hw ||
      (long long)n * cluster > 0x7fffffffLL ||
      smem < hist256::smem_bytes(p, 1, false, false))
    return (int)cudaErrorInvalidValue;
  return hist256::launch_clusters(
      histogram256_kernel, n * cluster, cluster, smem, (cudaStream_t)stream,
      (const uint8_t*)in, (int*)out, hw, p);
}
