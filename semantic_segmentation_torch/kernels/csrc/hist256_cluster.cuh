// Per-image 256-bin histograms of uint8 images, counted by a thread-block
// cluster and reduced in distributed shared memory: the building block of
// histogram256.cu and equalize_uint8.cu.
//
// A cluster of K CTAs (K = 2 to 16) owns one image; the grid is K x images
// on grid.x. CTA rank r takes the contiguous byte slice
// [r * slice, (r + 1) * slice) of the image (the last ones may be short or
// empty), reads it with 16-byte loads (a scalar head up to the first 16-byte
// boundary and a scalar tail), and counts it into one shared 256-bin
// histogram with shared-memory atomics. Then it stores each bin's count into
// its own slot at the CTAs that need the bin, with asynchronous stores to
// distributed shared memory (st.async) that count their bytes on the
// receiving CTA's mbarrier; a CTA waits on its own mbarrier until its slots
// are full and adds them locally. No CTA reads another's shared memory and
// no cluster-wide barrier stands between the count and the result (the
// only one, which orders the mbarriers' set-up before the stores, is
// arrived at when the kernel starts). No global atomics, no second launch,
// and exact integer sums in a fixed order, so a call's result is the same
// bit for bit every time.
//
// Skew. On this card the same-address shared atomics of a skewed image (a
// constant plane, the generator's background) cost no more than the spread
// adds of random bytes: replicated bins, per-warp sub-histograms and adding
// runs of equal bytes once were measured no faster (PERF.md), so every byte
// is one add into the CTA's one histogram.
//
// Channels. An NHWC image with c > 1 is one interleaved byte range: byte i
// of the image counts in channel i % c, so bins are c x 256.
//
// Dynamic shared memory, in this order (ops/image.hist256_plan sizes it):
//   hist   c * 256 int              the CTA's counts, later the LUT
//   slots  K * 256 int (histogram)  slot [s][j]: CTA s's count of this
//          K * c * 256 int          rank's own bin j (histogram) or of bin
//          (equalize)               j (equalize)
//   buf    slice + 16 bytes         (equalize, kept slices) the slice
// and, in static shared memory, the CTA's mbarrier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hist256 {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;   // per CTA; the LUT stage takes one bin each
constexpr int kMinCtas = 6;     // CTAs an SM must hold: <= 40 registers
constexpr int kBins = 256;
constexpr int kUnroll = 2;      // 16-byte loads in flight per thread
constexpr int kMaxCluster = 16;

// One launch's layout, as ops/image.hist256_plan computes it.
struct Plan {
  int cluster;  // K: CTAs per image, a power of two in [2, 16]
  int slice;    // bytes of the image per CTA, a multiple of 16
};

// Ints of the slot array: each CTA holds a slot per CTA of the cluster for
// the bins it needs: its own 256 / K bins (histogram) or all (equalize).
__host__ __device__ inline int slot_words(const Plan& p, int c,
                                          bool equalize) {
  return equalize ? p.cluster * c * kBins : kBins;
}

// Dynamic shared bytes of a launch; `keep`: the slice stays in shared memory.
__host__ __device__ inline long long smem_bytes(const Plan& p, int c,
                                                bool equalize, bool keep) {
  return 4LL * (c * kBins + slot_words(p, c, equalize)) +
         (keep ? p.slice + 16 : 0);
}

__host__ inline bool plan_ok(const Plan& p, int c) {
  return p.cluster >= 2 && p.cluster <= kMaxCluster &&
         (p.cluster & (p.cluster - 1)) == 0 && p.slice > 0 &&
         p.slice % 16 == 0 && c >= 1;
}

__device__ __forceinline__ int byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xff;
}

// One add per byte; byte j of the chunk is in channel (ch + j) % c.
__device__ __forceinline__ void count16(int* hist, const uint4& v, int ch,
                                        int c) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    atomicAdd(hist + ch * kBins + byte_of(v, j), 1);
    if (++ch == c) ch = 0;
  }
}

__device__ __forceinline__ int head_len(const void* p, int len) {
  const int head = (16 - (int)(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  return head < len ? head : len;
}

// Zeroes the CTA's `hist` (c x 256 ints) and counts the slice src[0, len),
// whose byte 0 is byte g0 of its image, into it. The first round of loads
// is issued before the zeroing, so that the two overlap. With `buf`, also
// copies byte i of the slice to buf[(src & 15) + i], so that src's 16-byte
// chunks stay 16-byte chunks in buf (buf is 16-byte aligned). Ends with
// __syncthreads().
__device__ __forceinline__ void count_slice(const uint8_t* __restrict__ src,
                                            int len, long long g0, int c,
                                            int* hist, uint8_t* buf) {
  const int tid = threadIdx.x;
  const int m = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = head_len(src, len);
  const int n16 = (len - head) >> 4;
  const int tail = head + (n16 << 4);
  const uint4* s16 = reinterpret_cast<const uint4*>(src + head);
  uint4 v[kUnroll];
  const auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n16) v[u] = __ldg(s16 + i);
    }
  };
  load(tid);
  for (int q = tid; q < c * kBins; q += kThreads) hist[q] = 0;
  __syncthreads();
  for (int i = tid; i < head + len - tail; i += kThreads) {
    const int at = i < head ? i : tail + (i - head);
    const int b = src[at];
    if (buf) buf[m + at] = (uint8_t)b;
    atomicAdd(hist + (c == 1 ? b : (int)((g0 + at) % c) * kBins + b), 1);
  }
  uint4* b16 = buf ? reinterpret_cast<uint4*>(buf + m + head) : nullptr;
  for (int i0 = tid; i0 < n16; i0 += kThreads * kUnroll) {
    if (i0 != tid) load(i0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n16) break;
      if (b16) b16[i] = v[u];
      count16(hist, v[u], c == 1 ? 0 : (int)((g0 + head + 16LL * i) % c),
              c);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of shared::cta address `a` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t at_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Spin until the mbarrier's phase differs from `parity`. A wait that never
// ends (bytes that never come) traps after about 4e9 cycles (2 s) instead
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

// First half of the exchange, at the kernel's start: thread 0 sets up the
// CTA's mbarrier `bar`, which will count the bytes the cluster's CTAs
// store into its slots, and every thread arrives (relaxed) on the cluster
// barrier; `exchange` waits on it, by when it has long completed.
__device__ __forceinline__ void exchange_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// Stores this CTA's counts `hist` into its slot row at the CTAs that need
// them, four ints per asynchronous remote store (st.async), each of which
// adds its bytes to the receiving CTA's mbarrier; then waits until its own
// mbarrier has every byte its slots expect. `everyone`: every CTA needs
// all nb bins (row `rank` of width nb at all K CTAs, starting with the
// next rank so that the CTAs write to different SMs at a time); else rank
// r needs only its own bins [r * per, (r + 1) * per), per = nb / K (row
// `rank` of width per at the owner). No CTA reads another's shared memory,
// so none has to wait for the others before it exits.
__device__ __forceinline__ void exchange(cg::cluster_group& cl,
                                         const int* hist, int* slots,
                                         uint64_t* bar, int nb,
                                         bool everyone) {
  const int cluster = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int per = nb / cluster, width = everyone ? nb : per;
  const uint32_t slots_a = smem_u32(slots), bar_a = smem_u32(bar);
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar_a), "r"(cluster * width * 4) : "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  const int chunks = nb / 4, sends = everyone ? cluster * chunks : chunks;
  for (int t = threadIdx.x; t < sends; t += kThreads) {
    const int q = 4 * (t % chunks);
    const int dst = everyone ? (rank + 1 + t / chunks) & (cluster - 1)
                             : q / per;
    const int col = everyone ? q : q % per;
    const int4 v = *reinterpret_cast<const int4*>(hist + q);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n"
        :: "r"(at_rank(slots_a + 4 * (rank * width + col), dst)),
           "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(at_rank(bar_a, dst))
        : "memory");
  }
  mbar_wait(bar_a, 0);
}

// The sum of slot column j over the cluster's CTAs (`width` ints a row),
// all loads issued before the first add.
__device__ __forceinline__ int slot_sum(const int* slots, int j, int width,
                                        int cluster) {
  int part[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    part[r] = r < cluster ? slots[r * width + j] : 0;
  int s = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) s += part[r];
  return s;
}

// Launches kernel<<<grid, kThreads, smem, stream>>>(args...) in clusters of
// `cluster` CTAs. Per kernel and device, sets the shared-memory attribute
// when a launch needs more than any before and allows clusters of 16,
// checks once per cluster size and larger shared size that the card can
// hold one such cluster, and returns the launch's error.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int grid, int cluster,
                    int smem, cudaStream_t stream, Args... args) {
  // per (kernel, device): the largest shared size set, and per cluster
  // size the largest shared size checked, each plus one
  static struct {
    const void* fn;
    int device, smem_set, smem_checked[kMaxCluster + 1];
  } seen[8] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  int slot = 0;
  while (slot < 7 && seen[slot].fn &&
         (seen[slot].fn != (const void*)kernel || seen[slot].device != device))
    ++slot;
  if (seen[slot].fn != (const void*)kernel || seen[slot].device != device)
    seen[slot] = {(const void*)kernel, device, 0, {}};
  auto& s = seen[slot];
  if (smem >= s.smem_set) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    s.smem_set = smem + 1;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem >= s.smem_checked[cluster]) {
    int fits = 0;
    e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (fits < 1) return (int)cudaErrorInvalidConfiguration;
    s.smem_checked[cluster] = smem + 1;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace hist256
