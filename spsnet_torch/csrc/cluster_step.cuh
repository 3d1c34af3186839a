// What the farthest point sampling kernels that share one batch row
// across a thread-block cluster have in common: csrc/fps.cu (K1, K4) and
// csrc/fps_dist.cu (K7). Each step, every CTA of the cluster sends its
// record to every peer with `st.async` into distributed shared memory,
// counted in bytes by the receiver's mbarrier; the cluster size is one
// rule for both.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace spsnet_cluster {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;
// the share of a row a thread holds that cluster_size() aims at
constexpr int kFastPPT = 4;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on `bar` and expect `bytes` more in its current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The shared::cluster address of local shared `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The fixed rule for a row of N entries (points, or columns of a distance
// matrix) over CTAs of `threads`: B * C <= 132 SMs where possible (16 for
// B <= 8, 8 for B <= 16, 4 for B <= 33, else 2), but at least enough CTAs
// that a thread holds <= kFastPPT entries (up to 16 CTAs; a thread then
// holds <= 16, so any N <= 16 * 16 * threads fits), and no more than leave
// each thread one entry. Measured on the H100 (PERF.md): K1 at C = 16 ahead
// of 8 and 4 at (8, 16384); at B > 8, C = 16 ahead of 8 at (16, 16384) and
// 4 ahead of 2 at (64, 4096), 4 points a thread each time, and more CTAs
// than that no faster; K7 fastest at the rule's C = 16 for (8, 4096) and
// C = 4 for (8, 1024), and CTAs of 128 or 512 threads no faster by more
// than 1%.
inline int cluster_size(int B, int N, int threads) {
  const int by_rows = B <= 8 ? 16 : B <= 16 ? 8 : B <= 33 ? 4 : 2;
  const int per_cta = threads * kFastPPT;
  const int need = pow2_ceil((N + per_cta - 1) / per_cta);
  const int useful = pow2_ceil((N + threads - 1) / threads);
  const int c = need > by_rows ? need : (useful < by_rows ? useful : by_rows);
  return c < 2 ? 2 : (c > kMaxCluster ? kMaxCluster : c);
}

}  // namespace spsnet_cluster
