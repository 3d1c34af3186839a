// Exact and seeded farthest point sampling for Hopper (sm_90a), one batch
// row across a thread-block cluster.
//
// `fps` replaces the TPU kernels `_fps_kernel_unrolled_b` (spsnet_tpu/ops/
// pallas/fps.py:167, dispatched through `_fps_pallas_allbatch`) and
// `_fps_kernel` (fps.py:26, through `_fps_pallas_grid`). Both compute the
// same function; they differ only in how the TPU batches rows, so one kernel
// serves both. `fps_seeded` replaces `_fps_kernel_seeded` (fps.py:387,
// through `farthest_point_sample_seeded`): the same step loop, with the
// running min loaded from d0 (the min squared distance to k0 seeds, from
// csrc/seed_min.cu) instead of 1e10, the seeds copied verbatim to the head
// of the output and the chain started from the last seed, so it runs only
// npoint - k0 steps.
//
// Function: (B, N, 3) fp32 -> (B, npoint) int64. The first pick is index 0
// (or the first valid point under a mask, 0 when none is valid); each step
// lowers every point's running min squared distance by its distance to the
// last pick and picks the argmax, the lowest index winning ties. Masked-out
// points hold distance -1, so they lose to any valid point.
//
// What bounds it on the H100: the npoint - 1 steps form a serial chain. The
// bytes (12 B per point, read once) and the FLOPs (~10 per point and step)
// are far below the card's rates; the latency of one step is the cost. One
// CTA per row (the first design) left 124 of 132 SMs idle at B = 8 and spent
// each step on 16 points a thread and ten shuffle rounds.
//
// Design: a cluster of C CTAs (C a power of two, 2..16, from
// cluster_size()) shares one row. CTA r of the cluster holds the contiguous
// shard [r*S, (r+1)*S), S = ceil(N / C); thread t of it holds the points
// r*S + t + k*T (k < PPT, T = 256 threads) with their coordinates and
// running minima in registers, so no step reads memory for its own points.
// One step:
//   1. each thread updates its minima and keeps its best (value, index),
//      value descending then index ascending (the strict compare keeps the
//      lower k, hence the lower index);
//   2. each warp reduces in hardware: `__reduce_max_sync` on the value's int
//      bits (for fp32 >= 0 the bits order as the floats; the mask's -1.0f is
//      a negative int and an empty slot INT_MIN, below both), then
//      `__reduce_min_sync` on the indices holding that maximum; the lane
//      that holds the winner writes (value, index, x, y, z) to the warp's
//      slot and the warp arrives at a named barrier;
//   3. warp 0 waits there, reduces the W slots the same way, and its lanes
//      0..C-1 send the CTA's record to every CTA of the cluster with
//      `st.async` into distributed shared memory, each store counted in
//      bytes by the receiver's mbarrier (`mbarrier::complete_tx`);
//   4. every thread waits on its own CTA's mbarrier of the step, which
//      completes when all C records have arrived: no cluster-wide barrier;
//   5. every warp reduces the C records the same way and reads the winner's
//      coordinates from its record: no CTA reads another's shard.
// Records and mbarriers are double-buffered by step parity; each mbarrier
// is armed for C records (`expect_tx`) before the first step and re-armed
// right after each wait. Reuse is safe: a peer sends the records of step
// j + 2 only after its wait of step j + 1 completed, which needs this
// CTA's record of step j + 1, which warp 0 sends only after every local
// warp arrived at step j + 1's named barrier, i.e. after every local
// thread read the records of step j (thread 0 re-arms before warp 0 sends
// again, so no record meets an unarmed mbarrier). The warp slots need one
// buffer: a warp writes them for step j + 1 only after its wait of step j,
// which needs this CTA's own record of step j, sent after warp 0 read the
// slots. Before the first record a cluster barrier makes sure that every
// CTA runs with its mbarriers armed; after the last step a final one keeps
// every CTA alive while a peer may still access its shared memory.
//
// Measured on the H100 (PERF.md): 0.75 us a step at (8, 16384) with C = 16
// and T = 256, which ran ahead of T = 512 and of C = 8 or 4. Exchanging
// every warp's record through a cluster barrier instead (C * W records a
// CTA and step) was more than twice as slow.
//
// Under a mask the first valid index is the minimum over the cluster:
// each warp's minimum goes into CTA 0's shared memory with a DSMEM atomicMin
// between two cluster barriers. Seeded: the shard's minima start from d0,
// the cluster's threads copy the seeds, the chain starts from the last seed.
//
// Launch: `cudaLaunchKernelEx` with `cudaLaunchAttributeClusterDimension`
// (C = 16 needs `cudaFuncAttributeNonPortableClusterSizeAllowed`).
// `cudaOccupancyMaxActiveClusters` is checked before a configuration's first
// launch; when it is 0 the launch returns cudaErrorLaunchOutOfResources and
// nothing runs.
//
// Rounding: d2 = (dx*dx + dy*dy) + dz*dz with every product and sum
// rounded separately (__fmul_rn/__fadd_rn, which nvcc never contracts into
// FMAs, and -fmad=false), in the order of the plain PyTorch version, so both
// pick the same indices.
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace spsnet_cluster;

constexpr int kMaxN = 65536;
constexpr int kThreads = 256;  // T, the threads of a CTA
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The warp's best of (m, i) pairs (m desc, i asc; every lane gets it) and
// the lane that holds it.
__device__ __forceinline__ void warp_best(int& m, int& i, int& src) {
  const int wm = __reduce_max_sync(kFull, m);
  const int cand = m == wm ? i : INT_MAX;
  const int wi = static_cast<int>(__reduce_min_sync(kFull, cand));
  src = __ffs(__ballot_sync(kFull, cand == wi)) - 1;
  m = wm;
  i = wi;
}

// A record (value bits, index, x bits, y bits | z) into CTA `rank`'s slot,
// counted by that CTA's mbarrier (kRecordBytes in all).
constexpr uint32_t kRecordBytes = 20;

__device__ __forceinline__ void send_record(int4* rec, float* rec_z,
                                            uint64_t* bar, int rank, int4 v,
                                            float z) {
  const uint32_t b = peer_addr(smem_addr(bar), rank);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(peer_addr(smem_addr(rec), rank)),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(b)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n" ::"r"(peer_addr(smem_addr(rec_z), rank)),
      "r"(__float_as_int(z)), "r"(b)
      : "memory");
}

// kSeeded: d0 (B, N) and seeds (B, k0) are given and valid is NULL.
template <int PPT, bool kSeeded>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
               const float* __restrict__ d0, const int64_t* __restrict__ seeds,
               int64_t* __restrict__ out, int N, int npoint, int k0,
               int shard) {
  // the warps' bests of the current step: (value bits, index, x, y) | z
  __shared__ int4 s_warp[kWarps];
  __shared__ float s_warp_z[kWarps];
  // the CTAs' records of a step, by step parity, and their mbarriers
  __shared__ __align__(16) int4 s_rec[2][kMaxCluster];
  __shared__ float s_rec_z[2][kMaxCluster];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_first;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + static_cast<size_t>(row) * N * 3;
  int64_t* o = out + static_cast<size_t>(row) * npoint;
  const int lo = rank * shard;
  const int hi = min(N, lo + shard);

  if (tid == 0) {
    s_first = INT_MAX;
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first step of each parity expects C records
    mbar_expect(&s_bar[0], kRecordBytes * C);
    mbar_expect(&s_bar[1], kRecordBytes * C);
  }

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
  int my_first = INT_MAX;
#pragma unroll
  for (int k = PPT - 1; k >= 0; --k) {  // descending: my_first ends lowest
    const int i = lo + tid + k * kThreads;
    px[k] = py[k] = pz[k] = 0.f;
    dist[k] = -1.f;
    if (i < hi) {
      px[k] = pts[3 * i];
      py[k] = pts[3 * i + 1];
      pz[k] = pts[3 * i + 2];
      if (kSeeded) {
        dist[k] = d0[static_cast<size_t>(row) * N + i];
      } else {
        const bool ok = valid == nullptr ||
                        valid[static_cast<size_t>(row) * N + i] != 0;
        dist[k] = ok ? 1e10f : -1.f;
        if (ok) my_first = i;
      }
    }
  }
  // every CTA of the cluster runs, with its mbarriers set and armed, before
  // any DSMEM access
  cluster_barrier();

  int last, j0;
  if (kSeeded) {
    const int64_t* sd = seeds + static_cast<size_t>(row) * k0;
    for (int s = rank * kThreads + tid; s < k0; s += C * kThreads) {
      o[s] = sd[s];
    }
    last = static_cast<int>(sd[k0 - 1]);
    j0 = k0;
  } else {
    last = 0;
    if (valid != nullptr) {
      int* first0 = cluster.map_shared_rank(&s_first, 0);
      const int wmin = static_cast<int>(__reduce_min_sync(kFull, my_first));
      if (lane == 0 && wmin != INT_MAX) atomicMin(first0, wmin);
      cluster_barrier();
      const int f = *first0;
      last = f == INT_MAX ? 0 : f;
    }
    if (rank == 0 && tid == 0) o[0] = last;
    j0 = 1;
  }
  float lx = pts[3 * last], ly = pts[3 * last + 1], lz = pts[3 * last + 2];

  uint32_t phases = 0;  // bit b: parity of s_bar[b]'s current phase
  for (int j = j0; j < npoint; ++j) {
    const int buf = j & 1;
    int bm = INT_MIN, bk = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (lo + tid + k * kThreads < hi) {
        const float d =
            fminf(dist[k], sq_dist(px[k], py[k], pz[k], lx, ly, lz));
        dist[k] = d;
        const int b = __float_as_int(d);
        if (b > bm) {  // strict: the lower k (lower index) keeps ties
          bm = b;
          bk = k;
        }
      }
    }
    float bx = px[0], by = py[0], bz = pz[0];
#pragma unroll
    for (int k = 1; k < PPT; ++k) {
      if (k == bk) {
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    }
    int bi = bm == INT_MIN ? INT_MAX : lo + tid + bk * kThreads;
    int src;
    warp_best(bm, bi, src);
    if (lane == src) {
      s_warp[warp] = make_int4(bm, bi, __float_as_int(bx), __float_as_int(by));
      s_warp_z[warp] = bz;
    }
    if (warp != 0) {
      // hand the slot to warp 0 and go on to wait for the records
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
      int m = INT_MIN, i = INT_MAX;
      if (lane < kWarps) {
        m = s_warp[lane].x;
        i = s_warp[lane].y;
      }
      warp_best(m, i, src);
      const int4 w = s_warp[src];
      const float wz = s_warp_z[src];
      __syncwarp();  // every lane has read the slots before any record leaves
      if (lane < C) {
        send_record(&s_rec[buf][rank], &s_rec_z[buf][rank], &s_bar[buf],
                    lane, w, wz);
      }
    }
    mbar_wait(&s_bar[buf], (phases >> buf) & 1u);
    phases ^= 1u << buf;
    // re-arm for step j + 2: no peer sends it before this CTA's record of
    // step j + 1, which comes after every local thread has waited here
    if (tid == 0) mbar_expect(&s_bar[buf], kRecordBytes * C);

    int rm = INT_MIN, ri = INT_MAX;
    if (lane < C) {
      rm = s_rec[buf][lane].x;
      ri = s_rec[buf][lane].y;
    }
    warp_best(rm, ri, src);
    const int4 win = s_rec[buf][src];
    lx = __int_as_float(win.z);
    ly = __int_as_float(win.w);
    lz = s_rec_z[buf][src];
    last = ri;
    if (rank == 0 && tid == 0) o[j] = last;
  }
  // no CTA leaves while a peer may still access its shared memory
  cluster_barrier();
}

template <int PPT, bool kSeeded>
cudaError_t launch(const float* xyz, const uint8_t* valid, const float* d0,
                   const int64_t* seeds, int64_t* out, int B, int N,
                   int npoint, int k0, int C, cudaStream_t stream,
                   int* active) {
  auto kernel = fps_kernel<PPT, kSeeded>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // max active clusters per cluster size (index log2 C), 0 = not yet asked
  static int checked[5] = {0, 0, 0, 0, 0};
  const int slot = __builtin_ctz(static_cast<unsigned>(C));
  if (checked[slot] == 0 || active != nullptr) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return err;
    if (active != nullptr) {
      *active = n;
      return cudaSuccess;
    }
    if (n < 1) return cudaErrorLaunchOutOfResources;
    checked[slot] = n;
  }
  const int shard = (N + C - 1) / C;
  return cudaLaunchKernelEx(&cfg, kernel, xyz, valid, d0, seeds, out, N,
                            npoint, k0, shard);
}

// One instantiation per power-of-two share of points per thread. With
// `active` set, only reports the launch's cudaOccupancyMaxActiveClusters.
template <bool kSeeded>
cudaError_t dispatch(const float* xyz, const uint8_t* valid, const float* d0,
                     const int64_t* seeds, int64_t* out, int B, int N,
                     int npoint, int k0, cudaStream_t s,
                     int* active = nullptr) {
  const int C = cluster_size(B, N, kThreads);
  const int shard = (N + C - 1) / C;
  switch (pow2_ceil((shard + kThreads - 1) / kThreads)) {
#define SPSNET_FPS_LAUNCH(P)                                             \
  return launch<P, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, \
                            C, s, active)
    case 1: SPSNET_FPS_LAUNCH(1);
    case 2: SPSNET_FPS_LAUNCH(2);
    case 4: SPSNET_FPS_LAUNCH(4);
    case 8: SPSNET_FPS_LAUNCH(8);
    default: SPSNET_FPS_LAUNCH(16);  // N <= kMaxN keeps it at 16
#undef SPSNET_FPS_LAUNCH
  }
}

}  // namespace

extern "C" {

int spsnet_fps_max_n() { return kMaxN; }

// The cluster size of a launch over (B, N), and the threads of its CTAs.
int spsnet_fps_cluster_size(int B, int N) {
  return cluster_size(B, N, kThreads);
}

int spsnet_fps_threads() { return kThreads; }

// cudaOccupancyMaxActiveClusters of the launch over (B, N) (seeded or
// not), or minus a cudaError_t code.
int spsnet_fps_max_active_clusters(int B, int N, int seeded) {
  int n = 0;
  const cudaError_t err =
      seeded ? dispatch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, B,
                              N, 2, 1, nullptr, &n)
             : dispatch<false>(nullptr, nullptr, nullptr, nullptr, nullptr, B,
                               N, 2, 1, nullptr, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// xyz (B, N, 3) fp32 contiguous; valid (B, N) uint8 or NULL;
// out (B, npoint) int64. Returns a cudaError_t code.
int spsnet_fps(const void* xyz, const void* valid, void* out, int B, int N,
               int npoint, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || npoint < 1 || npoint > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch<false>(
      static_cast<const float*>(xyz), static_cast<const uint8_t*>(valid),
      nullptr, nullptr, static_cast<int64_t*>(out), B, N, npoint, 0,
      static_cast<cudaStream_t>(stream)));
}

// xyz (B, N, 3) fp32; d0 (B, N) fp32; seeds (B, k0) int64 in [0, N);
// out (B, npoint) int64, 1 <= k0 < npoint. Returns a cudaError_t code.
int spsnet_fps_seeded(const void* xyz, const void* d0, const void* seeds,
                      void* out, int B, int N, int npoint, int k0,
                      void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || npoint > N || k0 < 1 || k0 >= npoint) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch<true>(
      static_cast<const float*>(xyz), nullptr, static_cast<const float*>(d0),
      static_cast<const int64_t*>(seeds), static_cast<int64_t*>(out), B, N,
      npoint, k0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
