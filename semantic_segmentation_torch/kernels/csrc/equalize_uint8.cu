// Histogram equalization of uint8 NHWC images, PIL ImageOps.equalize
// numerics, one thread-block cluster per image and one launch per call.
//
// Replaces: semantic_segmentation_tpu/ops/pallas_kernels.py:147,
//   equalize_uint8_pallas / _equalize_kernel: per plane, a 256-bin
//   histogram -> the PIL LUT (step = (N - count of the last nonzero bin)
//   // 255; lut[i] = (step // 2 + exclusive cumsum[i]) // step, clipped to
//   [0, 255]; identity when at most one bin is nonzero or step == 0) -> the
//   LUT applied to every pixel. The LUT is built in int32 exactly as
//   semantic_segmentation_tpu/ops/image.py _equalize_lut does; the TPU
//   kernel's DIV_EPS only works around its float division and has no place
//   here.
//
// Bound on an H100: bytes. The image is read once and written once,
//   N*H*W*C bytes each: at the trainer's (2, 256, 256, 1) 262 KB, 0.08 us
//   at 3.35 TB/s, far under one launch; at (64, 512, 512, 1) 33.6 MB,
//   10.0 us.
//
// Design (hist256_cluster.cuh): a cluster of K <= 8 CTAs per image, grid.x
//   = K x N, so the trainer's two images spread over 16 SMs and not 2. Each
//   CTA counts its contiguous slice with 16-byte loads and, while the slice
//   fits (always at 256^2), keeps it in shared memory. It stores its c x 256
//   counts into its slot row at every CTA of the cluster (asynchronous
//   stores to distributed shared memory, counted by the receiver's
//   mbarrier); once its slots are full each CTA adds the K rows itself and
//   builds the LUT, so no second exchange is needed, and applies it to its
//   own slice from shared memory with 16-byte stores. So
//   the image crosses HBM once each way; a slice too large for shared
//   memory is read again, from L2. An NHWC image with c > 1 is read as one
//   interleaved range (byte i in channel i % c), not channel by channel.
//
// Skew: a constant or two-valued plane, or the generator's background,
//   sends a warp's adds to one bin; on this card those shared atomics cost
//   no more than spread ones, and adding runs of equal bytes once was no
//   faster (PERF.md), so every byte is one shared add.

#include "hist256_cluster.cuh"

namespace {

using hist256::kBins;
using hist256::kThreads;
using hist256::Plan;

// lut[ch * 256 + b]: PIL's equalize LUT of each channel, from the image's
// counts, which thread b adds from the cluster's slots. One bin per thread
// (kThreads == 256): the exclusive scan by warp shuffles and the eight warp
// totals; the last nonzero bin and the count of nonzero bins from each
// warp's ballot.
__device__ void build_luts(const int* slots, int* lut, int c, int cluster) {
  static_assert(kThreads == kBins, "one bin per thread");
  constexpr int kW = kBins / 32;
  __shared__ int warp_tot[kW], warp_last[kW], warp_nonzero[kW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = c * kBins;
  for (int ch = 0; ch < c; ++ch) {
    const int count = hist256::slot_sum(slots, ch * kBins + tid, nb, cluster);
    const unsigned nonzero = __ballot_sync(0xffffffffu, count > 0);
    int incl = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) {
      warp_tot[warp] = incl;
      warp_last[warp] = nonzero ? warp * 32 + 31 - __clz(nonzero) : 0;
      warp_nonzero[warp] = __popc(nonzero);
    }
    __syncthreads();
    int before = 0, total = 0, last = 0, n_nonzero = 0;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      if (k < warp) before += warp_tot[k];
      total += warp_tot[k];
      last = max(last, warp_last[k]);  // any bin when the plane is empty
      n_nonzero += warp_nonzero[k];
    }
    const int excl = before + incl - count;
    const int step =
        (total - hist256::slot_sum(slots, ch * kBins + last, nb, cluster)) /
        255;
    int v = tid;
    if (n_nonzero > 1 && step != 0) {
      v = (step / 2 + excl) / step;
      v = v < 0 ? 0 : (v > 255 ? 255 : v);
    }
    lut[ch * kBins + tid] = v;
    __syncthreads();  // the LUT is whole; warp_* may be reused
  }
}

// dst[i] = lut of src[i] for the slice's len bytes; byte i of the slice is
// byte g0 + i of its image (channel (g0 + i) % c). 16-byte loads and stores
// where src and dst share their offset from a 16-byte boundary, bytes
// elsewhere.
__device__ __forceinline__ void apply_slice(const uint8_t* src, uint8_t* dst,
                                            int len, long long g0, int c,
                                            const int* lut) {
  const int tid = threadIdx.x;
  const auto map = [&](long long g, int b) {
    return lut[(c == 1 ? 0 : (int)(g % c)) * kBins + b];
  };
  if (((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst))
       & 15) != 0) {
    for (int i = tid; i < len; i += kThreads)
      dst[i] = (uint8_t)map(g0 + i, src[i]);
    return;
  }
  const int head = hist256::head_len(src, len);
  const int n16 = (len - head) >> 4;
  const int tail = head + (n16 << 4);
  for (int i = tid; i < head + len - tail; i += kThreads) {
    const int at = i < head ? i : tail + (i - head);
    dst[at] = (uint8_t)map(g0 + at, src[at]);
  }
  const uint4* s16 = reinterpret_cast<const uint4*>(src + head);
  uint4* d16 = reinterpret_cast<uint4*>(dst + head);
  for (int i = tid; i < n16; i += kThreads) {
    const uint4 v = s16[i];
    uint32_t o[4] = {0, 0, 0, 0};
    int ch = c == 1 ? 0 : (int)((g0 + head + 16LL * i) % c);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j >> 2] |= (uint32_t)lut[ch * kBins + hist256::byte_of(v, j)]
                   << (8 * (j & 3));
      if (++ch == c) ch = 0;
    }
    d16[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// kKeep: the slice stays in shared memory between the count and the apply.
template <bool kKeep>
__global__ void __launch_bounds__(kThreads, hist256::kMinCtas)
equalize_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int nbytes, int c, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long img = blockIdx.x / p.cluster;
  const int nb = c * kBins;
  __shared__ uint64_t bar;
  int* hist = reinterpret_cast<int*>(smem);
  int* slots = hist + nb;
  uint8_t* buf = reinterpret_cast<uint8_t*>(slots + p.cluster * nb);

  hist256::exchange_init(&bar);
  const long long start = (long long)rank * p.slice;
  const long long rest = nbytes - start;
  const int len = rest <= 0 ? 0 : (rest < p.slice ? (int)rest : p.slice);
  const uint8_t* src = in + img * nbytes + start;
  uint8_t* dst = out + img * nbytes + start;
  hist256::count_slice(src, len, start, c, hist, kKeep ? buf : nullptr);
  hist256::exchange(cl, hist, slots, &bar, nb, true);
  // the LUT takes the counts' place, written after build_luts' first
  // __syncthreads(), when every thread has sent the counts it reads
  build_luts(slots, hist, c, p.cluster);
  const uint8_t* from =
      kKeep ? buf + (reinterpret_cast<uintptr_t>(src) & 15) : src;
  apply_slice(from, dst, len, start, c, hist);
}

}  // namespace

// in, out: (n, hw, c) uint8, contiguous (an NHWC batch with hw = H*W). The
// plan's fields are those of ops/image.hist256_plan(n, hw, c, equalize=True);
// smem is its dynamic shared bytes. Launches on `stream`, allocates nothing,
// does not synchronise. Returns the launch's CUDA error
// (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int equalize_uint8(const void* in, void* out, int n, int hw, int c,
                              int cluster, int slice, int keep, int smem,
                              void* stream) {
  if (n == 0) return 0;
  const Plan p{cluster, slice};
  const long long nbytes = (long long)hw * c;
  if (!hist256::plan_ok(p, c) || n < 0 || hw < 0 || nbytes > 0x7fffffffLL ||
      (long long)slice * cluster < nbytes ||
      (long long)n * cluster > 0x7fffffffLL ||
      smem < hist256::smem_bytes(p, c, true, keep != 0))
    return (int)cudaErrorInvalidValue;
  const auto kernel = keep ? equalize_kernel<true> : equalize_kernel<false>;
  return hist256::launch_clusters(kernel, n * cluster, cluster, smem,
                                  (cudaStream_t)stream, (const uint8_t*)in,
                                  (uint8_t*)out, (int)nbytes, c, p);
}
