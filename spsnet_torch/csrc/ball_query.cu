// Fused multi-radius ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel `_d2_kernel` (spsnet_tpu/ops/pallas/d2.py:33,
// entry `ball_d2_bf16`) together with the first-k selection that consumes
// its output (`_first_k_hits`, spsnet_tpu/ops/grouping.py:118-146). The TPU
// wrote the (B, M, N) squared-distance tensor to HBM (as bf16) and ran a
// top-k over it; on this card that tensor is pure memory traffic, so the
// distance never leaves registers here and stays fp32.
//
// Function, per center m of batch row b and per radius r (one or two radii
// share one pass): the indices of the first `nsample` points, in index
// order, with d2 < r*r (strict); slots past the last hit repeat the first
// hit; a ball with no hit is all zeros. The annulus form (kAnnulus, the
// dilated grouping's `ball_query_dilated`, spsnet_tpu/ops/grouping.py:
// 167-213, and the reference's `ball_query_dilated_kernel_fast`) takes a
// lower squared radius a radius too: a hit is r_min^2 <= d2 < r^2, or
// d2 <= 0 (the center itself always hits). Every annulus hit lies below
// r^2, so the early stop and the guard below hold for it unchanged; only
// a radius of 0, whose d2 <= 0 hits lie on it, needs the guard widened.
//
// What bounds it on the H100: arithmetic and issue. Each (center, point)
// pair costs ~10 fp32 operations; the bytes (points, centers, indices) are
// a few MB per layer. The scan stops early once every radius of a center
// has its nsample hits, so the work depends on the data; at small radii
// nearly every center scans its whole row.
//
// Design: a CTA of 8 warps, each warp holding W centers (warp_centers():
// 2 for large launches, 1 for small ones), so 8 W centers a CTA. The CTA
// walks its batch row in tiles of 1024 points kept in shared memory as the
// row's own AoS bytes (lanes read x, y, z at stride 3: 3 is odd, so the 32
// lanes hit 32 banks). In each 32-point chunk, lane l loads point t0 + l
// once into registers and tests it against all W centers, so a pair costs
// 1/W of a point's shared loads. For W > 1 one `__any_sync` guards the hit
// bookkeeping, on each center's largest squared radius that still lacks
// hits (a full radius no longer counts): only a chunk with a hit runs the
// ballots. `__popc` of the lower lanes' hits gives each hit its slot, so
// the slots follow index order exactly. A warp stops testing once all its
// centers have every radius full, tested every kChunks = 4 chunks so that
// a chunk's loads and distances overlap the previous chunk's ballots
// (faster on the H100 than a test every chunk at each of the paths'
// shapes); the CTA stops loading tiles once all eight warps
// are done (`__syncthreads_and`, which is also the barrier after which a
// tile's buffer may be refilled; none follows the last tile, so each warp
// pads its balls as soon as it ends).
//
// Tiles arrive through a double-buffered ring (kBulk): one thread issues a
// 1-D bulk copy (`cp.async.bulk`, TMA) of the tile's bytes with an mbarrier
// that counts them (`complete_tx`), so tile k + 1 lands while tile k is
// scanned. A bulk copy needs a 16-byte aligned source and a size that is a
// multiple of 16: a row of N points starts aligned only when N % 4 == 0
// (and the tensor itself is aligned); then every tile, the last included,
// qualifies. For any other row, and for a row of one tile, the kernel's
// second load path (!kBulk) copies each tile with plain loads by all
// threads into one buffer sized to the row, followed by a barrier; it holds
// no mbarrier code, which a one-tile launch of a few microseconds would pay
// for.
//
// Rounding: d2 = (dx*dx + dy*dy) + dz*dz with dx = center - point and every
// product and sum rounded separately (__fmul_rn/__fadd_rn), in the order of
// the plain PyTorch version, so the radius compare decides every boundary
// case the same way.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kTile = 1024;
constexpr unsigned kFull = 0xffffffffu;
// floats of a tile that one thread copies on the plain-load path
constexpr int kCopyPerThread = 3 * kTile / kThreads;
// 32-point chunks a warp scans between two tests of its exit
constexpr int kChunks = 4;
// centers of a launch from which a warp takes two (warp_centers())
constexpr long long kTwoCentersFrom = 8192;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One thread: expect `bytes` on `bar` and copy them from global to shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
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

// Appends this 32-point chunk's hits (`mask`, the warp's ballot of `hit`)
// to one radius's slot list.
__device__ __forceinline__ void take_hits(unsigned mask, bool hit, int idx,
                                          int lane, int64_t* slots,
                                          int nsample, int& count,
                                          int& first) {
  if (mask == 0u) return;
  if (count == 0) first = idx - lane + __ffs(mask) - 1;
  const int pos = count + __popc(mask & ((1u << lane) - 1u));
  if (hit && pos < nsample) slots[pos] = idx;
  count += __popc(mask);
}

// The guard radius of a center: the larger squared radius among those
// still short of their nsample hits, -1 (below any d2) once all are full.
__device__ __forceinline__ float open_r2(int cnt_a, int nsa, float r2a,
                                         int cnt_b, int nsb, float r2b) {
  return fmaxf(cnt_a < nsa ? r2a : -1.f, cnt_b < nsb ? r2b : -1.f);
}

// Whether a squared distance hits a radius: below r2, and in the annulus
// form also at least r2min, or at most 0.
template <bool kAnnulus>
__device__ __forceinline__ bool hits(float d2, float r2, float r2min) {
  if (kAnnulus) return (d2 >= r2min && d2 < r2) || d2 <= 0.f;
  return d2 < r2;
}

template <int W, bool kBulk, bool kAnnulus>
__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ ctr, int64_t* __restrict__ out_a,
                      int64_t* __restrict__ out_b, int N, int M, float r2a,
                      int nsa, float r2b, int nsb, float r2a_min,
                      float r2b_min) {
  // kBulk: the ring of two tiles; else one tile, or the row if shorter (a
  // larger reservation costs the small layers occupancy)
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t full[2];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  // the warp's first center; center w of the warp is m0 + w
  const int m0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * W;
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;
  const size_t row0 = static_cast<size_t>(b) * M;
  const int ntiles = (N + kTile - 1) / kTile;

  // per center (warp-uniform): coordinates, hits so far, first hit, and the
  // guard radius (open_r2; -1 for a center past M, unused when W == 1). A
  // center past M counts as full.
  float cx[W], cy[W], cz[W], r2g[W];
  int cnt_a[W], cnt_b[W], first_a[W], first_b[W];
  bool done = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int m = m0 + w;
    cx[w] = cy[w] = cz[w] = 0.f;
    cnt_a[w] = cnt_b[w] = first_a[w] = first_b[w] = 0;
    r2g[w] = -1.f;
    if (m >= M) {
      cnt_a[w] = nsa;
      cnt_b[w] = nsb;
    } else {
      const float* c = ctr + (row0 + m) * 3;
      cx[w] = c[0];
      cy[w] = c[1];
      cz[w] = c[2];
      r2g[w] = open_r2(0, nsa, r2a, 0, nsb, r2b);
      done = false;
    }
  }

  // One 32-point chunk at tile offset t0 (`ragged`: lanes past n test no
  // point). Lane l's point against all W centers; for W > 1 the hit
  // bookkeeping only where some center has a hit within its guard radius.
  auto chunk = [&](const float* tp, int base, int t0, int n, bool ragged) {
    const int t = t0 + lane;
    const bool in = !ragged || t < n;
    const float px = in ? tp[3 * t] : 0.f;
    const float py = in ? tp[3 * t + 1] : 0.f;
    const float pz = in ? tp[3 * t + 2] : 0.f;
    float d2[W];
    bool any = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      d2[w] = sq_dist(cx[w], cy[w], cz[w], px, py, pz);
      if (ragged && !in) d2[w] = __int_as_float(0x7f800000);  // +inf
      any |= d2[w] < r2g[w] || (kAnnulus && r2g[w] >= 0.f && d2[w] <= 0.f);
    }
    // one center: its ballots are the guard (a vote first would add one)
    if (W > 1 && !__any_sync(kFull, any)) return;
    done = true;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (W == 1 || r2g[w] >= 0.f) {
        // both ballots at once; a full radius only counts (pos >= nsample
        // stores nothing), so radius b stores nothing when nsb == 0
        const size_t m = row0 + m0 + w;
        const bool ha = hits<kAnnulus>(d2[w], r2a, r2a_min);
        const bool hb = hits<kAnnulus>(d2[w], r2b, r2b_min);
        const unsigned ma = __ballot_sync(kFull, ha);
        const unsigned mb = __ballot_sync(kFull, hb);
        take_hits(ma, ha, base + t, lane, out_a + m * nsa, nsa, cnt_a[w],
                  first_a[w]);
        take_hits(mb, hb, base + t, lane, out_b + m * nsb, nsb, cnt_b[w],
                  first_b[w]);
        if (W > 1) r2g[w] = open_r2(cnt_a[w], nsa, r2a, cnt_b[w], nsb, r2b);
      }
      done = done && cnt_a[w] >= nsa && cnt_b[w] >= nsb;
    }
  };

  if (kBulk) {
    if (threadIdx.x == 0) {
      mbar_init(&full[0]);
      mbar_init(&full[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2 && k < ntiles; ++k) {
        const int n = min(kTile, N - k * kTile);
        bulk_load(ring + 3 * k * kTile, pts + 3 * k * kTile, 12u * n,
                  &full[k]);
      }
    }
  }

  for (int k = 0; k < ntiles; ++k) {
    const int s = k & 1;
    const int base = k * kTile;
    const int n = min(kTile, N - base);
    float* tile = kBulk ? ring + 3 * kTile * s : ring;
    if (kBulk) {
      mbar_wait(&full[s], (k >> 1) & 1);
    } else {
      // all of a thread's loads in flight before its first store
      float v[kCopyPerThread];
#pragma unroll
      for (int r = 0; r < kCopyPerThread; ++r) {
        const int t = threadIdx.x + r * kThreads;
        v[r] = t < 3 * n ? pts[3 * base + t] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kCopyPerThread; ++r) {
        const int t = threadIdx.x + r * kThreads;
        if (t < 3 * n) tile[t] = v[r];
      }
      __syncthreads();
    }
    int t0 = 0;
    // kChunks chunks between two exit tests: their loads and distances
    // overlap each other's ballots; a warp that filled its balls early scans
    // at most kChunks - 1 chunks more, which store nothing
    for (; t0 + 32 * kChunks <= n && !done; t0 += 32 * kChunks) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        chunk(tile, base, t0 + 32 * c, n, false);
      }
    }
    for (; t0 + 32 <= n && !done; t0 += 32) chunk(tile, base, t0, n, false);
    if (t0 < n && !done) chunk(tile, base, t0, n, true);
    // after the last tile no barrier: each warp pads its balls at once
    if (k + 1 == ntiles) break;
    // every warp has left buffer s: stop, or let the next copy refill it
    if (__syncthreads_and(done)) {
      // the copy of tile k + 1 is in flight: it must land before the CTA
      // exits
      if (kBulk && threadIdx.x == 0) {
        mbar_wait(&full[s ^ 1], ((k + 1) >> 1) & 1);
      }
      break;
    }
    if (kBulk && threadIdx.x == 0 && k + 2 < ntiles) {
      const int n2 = min(kTile, N - (k + 2) * kTile);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(tile, pts + 3 * (k + 2) * kTile, 12u * n2, &full[s]);
    }
  }

  // pad past the last hit with the first hit; an empty ball stays 0
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (m0 + w < M) {
      const size_t m = row0 + m0 + w;
      for (int q = min(cnt_a[w], nsa) + lane; q < nsa; q += 32) {
        out_a[m * nsa + q] = first_a[w];
      }
      for (int q = min(cnt_b[w], nsb) + lane; q < nsb; q += 32) {
        out_b[m * nsb + q] = first_b[w];
      }
    }
  }
}

// The fixed rule, from a sweep of W = 1, 2, 4 on the H100 (PERF.md): two
// centers a warp from 8192 centers on (IA-SSD's layers 0 and 1, the
// stability SA, the surface graph), else one, so that the small layers keep
// every SM busy.
int warp_centers(int B, int M) {
  return static_cast<long long>(B) * M >= kTwoCentersFrom ? 2 : 1;
}

}  // namespace

extern "C" {

// The centers a warp holds in a launch over B x M centers.
int spsnet_ball_query_warp_centers(int B, int M) { return warp_centers(B, M); }

// xyz (B, N, 3) and ctr (B, M, 3) fp32 contiguous; out_a (B, M, nsa) and
// out_b (B, M, nsb) int64 (out_b unused when nsb == 0). r2a/r2b are the
// squared radii; with `annulus` non-zero, r2a_min/r2b_min their lower
// squared radii (the annulus form). Returns a cudaError_t code (0 on
// success).
int spsnet_ball_query(const void* xyz, const void* ctr, void* out_a,
                      void* out_b, int B, int N, int M, float r2a, int nsa,
                      float r2b, int nsb, int annulus, float r2a_min,
                      float r2b_min, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || nsa < 1 || nsb < 0 ||
      (nsb > 0 && out_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = warp_centers(B, M);
  // a row of one tile gains nothing from the ring (its copy cannot overlap
  // a scan): plain loads
  const bool bulk = N > kTile && N % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(xyz) % 16 == 0;
  const int per_cta = kWarpsPerBlock * w;
  const dim3 grid((M + per_cta - 1) / per_cta, B);
  const int tiled = bulk ? 2 * kTile : (N < kTile ? N : kTile);
  const size_t smem = sizeof(float) * 3 * tiled;
  auto kernel =
      annulus ? (w == 1 ? (bulk ? ball_query_kernel<1, true, true>
                                : ball_query_kernel<1, false, true>)
                        : (bulk ? ball_query_kernel<2, true, true>
                                : ball_query_kernel<2, false, true>))
              : (w == 1 ? (bulk ? ball_query_kernel<1, true, false>
                                : ball_query_kernel<1, false, false>)
                        : (bulk ? ball_query_kernel<2, true, false>
                                : ball_query_kernel<2, false, false>));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ctr),
      static_cast<int64_t*>(out_a), static_cast<int64_t*>(out_b), N, M, r2a,
      nsa, r2b, nsb, r2a_min, r2b_min);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
