// Farthest point sampling over a precomputed squared-distance matrix
// (F-FPS) for Hopper (sm_90a), one batch row across a thread-block
// cluster.
//
// Not a port of a Pallas kernel: the JAX package computes this function in
// XLA (`farthest_point_sample_with_dist`, spsnet_tpu/ops/sampling.py:200-225,
// a `fori_loop` over the dense (B, N, N) matrix), and the reference in
// `furthest_point_sampling_with_dist_kernel` (sampling_gpu.cu:256-374). Its
// plain PyTorch version costs about three launches a pick.
//
// Function: (B, N, N) fp32 -> (B, npoint) int64. The first pick is index 0
// and every running minimum starts at 1e10; each step lowers the running
// minima by the row of the last pick (torch.minimum: a NaN on either side
// gives NaN) and picks their argmax, NaN above every number, -0.0 equal to
// +0.0 and the lowest index winning ties (torch.argmax, jnp.argmax). No
// clamp and no early exit.
//
// What bounds it on the H100: the npoint - 1 steps form a serial chain, and
// each reads one row of N floats (coalesced) whose address is the previous
// step's pick. The matrix does not fit in L2 at the paths' larger shape
// (537 MB at (8, 4096)), so a step costs at least one load latency from
// device memory, then the exchange of the pick. The first design (one CTA
// a row, the minima in shared memory) left 124 of 132 SMs idle at B = 8,
// and its threads walked their columns one dependent load at a time.
//
// Design: the exchange of csrc/fps.cu (K1), with a row of the matrix in
// place of the distance to the last pick, and its cluster rule
// (cluster_step.cuh). A cluster of C CTAs (C a power of two, 2..16, from
// cluster_size()) shares one row; CTA r holds the columns [r*S, (r+1)*S),
// S = ceil(N / C), and thread t of it the columns r*S + t + k*T (k < PPT,
// T = 256) with their running minima in registers. One step:
//   1. each thread issues the loads of all its columns of the picked row,
//      then lowers its minima and keeps its best (key, index); its strict
//      compare over increasing k keeps the lowest index;
//   2. each warp reduces in hardware: `__reduce_max_sync` on the keys, then
//      `__reduce_min_sync` on the indices holding that maximum; lane 0
//      writes the warp's record to its slot and the warp arrives at a
//      named barrier;
//   3. warp 0 waits there, reduces the W slots the same way, and its lanes
//      0..C-1 send the CTA's record to every CTA of the cluster with
//      `st.async` into distributed shared memory, each store counted in
//      bytes by the receiver's mbarrier (`mbarrier::complete_tx`);
//   4. every thread waits on its own CTA's mbarrier of the step, which
//      completes when all C records have arrived: no cluster-wide barrier;
//   5. every warp reduces the C records the same way: the pick.
// Records and mbarriers are double-buffered by step parity, and reused
// safely for the reasons csrc/fps.cu gives: a peer sends the records of
// step j + 2 only after its wait of step j + 1 completed, which needs this
// CTA's record of step j + 1, which warp 0 sends only after every local
// warp arrived at step j + 1's named barrier, i.e. after every local
// thread read the records of step j; thread 0 re-arms right after its
// wait, before warp 0 sends again. The warp slots need one buffer: a warp
// writes them for step j + 1 only after its wait of step j, which needs
// this CTA's own record of step j, sent after warp 0's reduction of the
// slots (a `redux.sync` over the values every lane read). A cluster
// barrier before the first record makes sure every CTA runs with its
// mbarriers armed; one after the last step keeps every CTA alive while a
// peer may still access its shared memory.
//
// The key: K1's values are >= 0 or -1, so their int bits order as the
// floats. F-FPS minima are not: `calc_square_dist` gives small negative
// entries, a row may hold -0.0 and +0.0, and NaN ranks first. order_key()
// maps a float to an unsigned key that orders as argmax ranks: a negative
// float's bits flipped, a non-negative one's sign bit set, -0.0 taken as
// +0.0 (the two tie, the lower index wins), every NaN to 0xffffffff (above
// +inf's 0xff800000, all NaNs equal). An empty slot holds key 0, below
// -inf's 0x007fffff.
//
// Launch: `cudaLaunchKernelEx` with `cudaLaunchAttributeClusterDimension`
// (C = 16 needs `cudaFuncAttributeNonPortableClusterSizeAllowed`).
// `cudaOccupancyMaxActiveClusters` is checked before a cluster size's first
// launch; when it is 0 the launch returns cudaErrorLaunchOutOfResources and
// nothing runs.
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
constexpr uint32_t kNaNKey = 0xffffffffu;
constexpr uint32_t kEmptyKey = 0u;
// a record (key, index), counted by the receiver's mbarrier
constexpr uint32_t kRecordBytes = 8;

__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return kNaNKey;
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's best of (key, index) pairs (key desc, index asc); every lane
// gets it.
__device__ __forceinline__ void warp_best(uint32_t& key, int& idx) {
  const uint32_t wk = __reduce_max_sync(kFull, key);
  const unsigned cand = key == wk ? static_cast<unsigned>(idx) : UINT_MAX;
  idx = static_cast<int>(__reduce_min_sync(kFull, cand));
  key = wk;
}

// The record (key, index) into CTA `rank`'s slot `rec`, counted by that
// CTA's mbarrier `bar`.
__device__ __forceinline__ void send_record(uint2* rec, uint64_t* bar,
                                            int rank, uint32_t key, int idx) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(peer_addr(smem_addr(rec), rank)),
      "r"(key), "r"(idx), "r"(peer_addr(smem_addr(bar), rank))
      : "memory");
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
    fps_dist_kernel(const float* __restrict__ dist, int64_t* __restrict__ out,
                    int N, int npoint, int shard) {
  // the warps' bests of the current step
  __shared__ uint2 s_warp[kWarps];
  // the CTAs' records of a step, by step parity, and their mbarriers
  __shared__ __align__(8) uint2 s_rec[2][kMaxCluster];
  __shared__ __align__(8) uint64_t s_bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* mat = dist + static_cast<size_t>(row) * N * N;
  int64_t* o = out + static_cast<size_t>(row) * npoint;
  const int first = rank * shard + tid;  // this thread's column at k = 0
  const int hi = min(N, (rank + 1) * shard);

  if (tid == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first step of each parity expects C records
    mbar_expect(&s_bar[0], kRecordBytes * C);
    mbar_expect(&s_bar[1], kRecordBytes * C);
  }
  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) mind[k] = 1e10f;
  // every CTA of the cluster runs, with its mbarriers set and armed, before
  // any DSMEM access
  cluster_barrier();
  if (rank == 0 && tid == 0) o[0] = 0;

  int last = 0;
  uint32_t phases = 0;  // bit b: parity of s_bar[b]'s current phase
  for (int j = 1; j < npoint; ++j) {
    const int buf = j & 1;
    const float* rw = mat + static_cast<size_t>(last) * N;
    // every load of the step in flight before the first compare
    float d[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int c = first + k * kThreads;
      d[k] = c < hi ? __ldg(rw + c) : 0.f;
    }
    uint32_t bkey = kEmptyKey;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (first + k * kThreads < hi) {
        const float a = mind[k];
        const float v = (a < d[k] || isnan(a)) ? a : d[k];
        mind[k] = v;
        const uint32_t key = order_key(v);
        if (key > bkey) {  // strict: the lower k (lower index) keeps ties
          bkey = key;
          bk = k;
        }
      }
    }
    int bi = bkey == kEmptyKey ? INT_MAX : first + bk * kThreads;
    warp_best(bkey, bi);
    if (lane == 0) s_warp[warp] = make_uint2(bkey, static_cast<unsigned>(bi));
    if (warp != 0) {
      // hand the slot to warp 0 and go on to wait for the records
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
      uint32_t m = kEmptyKey;
      int i = INT_MAX;
      if (lane < kWarps) {
        m = s_warp[lane].x;
        i = static_cast<int>(s_warp[lane].y);
      }
      warp_best(m, i);
      if (lane < C) send_record(&s_rec[buf][rank], &s_bar[buf], lane, m, i);
    }
    mbar_wait(&s_bar[buf], (phases >> buf) & 1u);
    phases ^= 1u << buf;
    // re-arm for step j + 2: no peer sends it before this CTA's record of
    // step j + 1, which comes after every local thread has waited here
    if (tid == 0) mbar_expect(&s_bar[buf], kRecordBytes * C);

    uint32_t rm = kEmptyKey;
    int ri = INT_MAX;
    if (lane < C) {
      rm = s_rec[buf][lane].x;
      ri = static_cast<int>(s_rec[buf][lane].y);
    }
    warp_best(rm, ri);
    last = ri;
    if (rank == 0 && tid == 0) o[j] = last;
  }
  // no CTA leaves while a peer may still access its shared memory
  cluster_barrier();
}

template <int PPT>
cudaError_t launch(const float* dist, int64_t* out, int B, int N, int npoint,
                   int C, cudaStream_t stream) {
  auto kernel = fps_dist_kernel<PPT>;
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
  // whether a cluster size (index log2 C) was checked for this PPT
  static bool checked[5] = {false, false, false, false, false};
  const int slot = __builtin_ctz(static_cast<unsigned>(C));
  if (!checked[slot]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    checked[slot] = true;
  }
  const int shard = (N + C - 1) / C;
  return cudaLaunchKernelEx(&cfg, kernel, dist, out, N, npoint, shard);
}

// One instantiation per power-of-two share of columns per thread.
cudaError_t dispatch(const float* dist, int64_t* out, int B, int N,
                     int npoint, cudaStream_t s) {
  const int C = cluster_size(B, N, kThreads);
  const int shard = (N + C - 1) / C;
  switch (pow2_ceil((shard + kThreads - 1) / kThreads)) {
    case 1: return launch<1>(dist, out, B, N, npoint, C, s);
    case 2: return launch<2>(dist, out, B, N, npoint, C, s);
    case 4: return launch<4>(dist, out, B, N, npoint, C, s);
    case 8: return launch<8>(dist, out, B, N, npoint, C, s);
    default: return launch<16>(dist, out, B, N, npoint, C, s);  // N <= kMaxN
  }
}

}  // namespace

extern "C" {

int spsnet_fps_dist_max_n() { return kMaxN; }

// The cluster size of a launch over (B, N).
int spsnet_fps_dist_cluster_size(int B, int N) {
  return cluster_size(B, N, kThreads);
}

// dist (B, N, N) fp32 contiguous; out (B, npoint) int64, 1 <= npoint <= N.
// Returns a cudaError_t code.
int spsnet_fps_dist(const void* dist, void* out, int B, int N, int npoint,
                    void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || npoint < 1 || npoint > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(static_cast<const float*>(dist),
                                   static_cast<int64_t*>(out), B, N, npoint,
                                   static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
