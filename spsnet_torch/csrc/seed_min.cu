// Min squared distance of each point to a set of seeds, for Hopper (sm_90a),
// the seeds split across a thread-block cluster.
//
// Replaces the TPU kernel `_seed_min_kernel` (spsnet_tpu/ops/pallas/fps.py:
// 461, through `_seed_min_d2` :488), the parallel prepass of seeded FPS: its
// output starts the running min of `fps_seeded` (csrc/fps.cu).
//
// Function: (B, N, 3) points, (B, k0, 3) seeds -> (B, N) fp32, the min over
// the seeds of d2 = (dx*dx + dy*dy) + dz*dz with d = point - seed, every
// product and sum rounded separately (__fsub_rn/__fmul_rn/__fadd_rn, built
// with -fmad=false), in the order of the plain PyTorch version. A min is
// exact in any order, so any split of the seeds equals the plain version bit
// for bit. d2 is never negative (nor -0, nor NaN on finite inputs), so the
// min of the values is the integer min of their bits.
//
// What bounds it on the H100: operations. A (point, seed) pair costs 3 sub,
// 3 mul, 2 add and a min against 12 bytes read per point and per seed and 4
// written per point (201 M pairs at B=4, N=16384, k0=3072). Without FMAs
// each of the 8 arithmetic operations is one FP32 instruction, and the SM
// issues one warp instruction a cycle on each of its four schedulers, so
// the issue floor is about twice the fp32 bound (which counts an FMA as two
// operations). Every instruction a pair beyond those 8 (a shared load, a
// min) and every idle scheduler counts against it.
//
// Design:
//  - A thread holds kPoints points (and their minima) in registers, so one
//    seed read from shared memory serves kPoints pairs. The seeds are staged
//    as three planes (x, y, z), so one 16-byte load brings one axis of four
//    seeds, padded with +inf (which gives d2 = +inf): 0.75 / kPoints shared
//    loads a pair.
//  - Two pairs take one three-way min (`__vimin3_s32`, a Hopper DPX
//    instruction) on the bits: half a min instruction a pair.
//  - The S CTAs of a cluster share one tile of kThreads * kPoints points of
//    a batch row; CTA r takes the r-th share of the seeds (a multiple of 4,
//    staged through shared memory kChunk at a time). S comes from split():
//    the smallest power of two (<= kMaxSplit) that brings the launch to
//    kMinCtas CTAs, as long as a share keeps kMinShare seeds. This is the
//    Hopper form of the TPU kernel's min-accumulation across its innermost
//    grid axis.
//  - Each CTA writes its minima to its shared memory; after a cluster
//    barrier, CTA r reduces the r-th 1/S of the tile over all S CTAs through
//    distributed shared memory and writes it: no atomics, no memset, no
//    second launch. A second cluster barrier keeps every CTA alive while a
//    peer may still read its minima.
//
// Measured on the H100 (PERF.md; `launch_sweep.py`), device time at the
// train path's two layers: tiles of 512 points (128 threads x 4 points)
// ran level with 256 x 4 and ahead of 256 x 2, 128 x 2 and 256 x 8 at the
// first layer, which holds 94% of the pairs (at the second, 128 x 2 ran
// 7.7 us against 9.3); about four such CTAs an SM ran ahead of one or two
// and level with eight; the DPX min ran 5% ahead of two `fminf`. With the
// default cluster scheduling, clusters of 4 and 8 ran 22% and 10% behind
// clusters of 2 at the same work an SM; the load-balancing policy closed
// that gap, so the launch asks for it. What is left is issue: ~9.3
// instructions a pair by the source's count (8 FP32, half a DPX min, the
// shared loads and the loop), whose floor is ~58 us at (4, 16384)
// k0 = 3072, and ~3 us of launch, staging and reduction.
//
// Launch: `cudaLaunchKernelEx` with `cudaLaunchAttributeClusterDimension`
// (S may be 1; 16 needs `cudaFuncAttributeNonPortableClusterSizeAllowed`)
// and `cudaClusterSchedulingPolicyLoadBalancing`.
// `cudaOccupancyMaxActiveClusters` is checked before the first launch of a
// cluster size; when it is 0 the launch returns
// cudaErrorLaunchOutOfResources and nothing runs.
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kPoints = 4;  // points a thread
constexpr int kTilePoints = kThreads * kPoints;
constexpr int kChunk = 2048;  // seeds staged at once (24 KB)
constexpr int kMaxSplit = 16;
constexpr long long kMinCtas = 512;  // 16 warps on nearly every SM
constexpr int kMinShare = 32;
constexpr int kInfBits = 0x7f800000;  // +inf

__device__ __forceinline__ int sq_dist_bits(float px, float py, float pz,
                                            float qx, float qy, float qz) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __float_as_int(__fadd_rn(
      __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

__global__ void __launch_bounds__(kThreads)
    seed_min_kernel(const float* __restrict__ xyz,
                    const float* __restrict__ seeds, float* __restrict__ out,
                    int N, int k0, int share) {
  __shared__ __align__(16) float s_seed[3][kChunk];
  __shared__ int s_min[kTilePoints];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tile0 = (blockIdx.x / S) * kTilePoints;
  const int tid = threadIdx.x;
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;

  // thread t holds points tile0 + t + k * kThreads; those past the row's end
  // repeat its last point and are never written
  float px[kPoints], py[kPoints], pz[kPoints];
  int m[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int i = min(tile0 + tid + k * kThreads, N - 1);
    px[k] = pts[3 * i];
    py[k] = pts[3 * i + 1];
    pz[k] = pts[3 * i + 2];
    m[k] = kInfBits;
  }

  const float* sb = seeds + static_cast<size_t>(b) * k0 * 3;
  const int lo = min(k0, rank * share);
  const int hi = min(k0, lo + share);
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    const int n4 = (n + 3) & ~3;
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = tid; e < 3 * n4; e += kThreads) {
      const int s = e / 3;
      s_seed[e - 3 * s][s] =
          s < n ? sb[static_cast<size_t>(c0) * 3 + e] : INFINITY;
    }
    __syncthreads();
    const float4* qx4 = reinterpret_cast<const float4*>(s_seed[0]);
    const float4* qy4 = reinterpret_cast<const float4*>(s_seed[1]);
    const float4* qz4 = reinterpret_cast<const float4*>(s_seed[2]);
#pragma unroll 2
    for (int j = 0; j < n4 / 4; ++j) {
      // every lane reads the same address: a broadcast
      const float4 qx = qx4[j], qy = qy4[j], qz = qz4[j];
#pragma unroll
      for (int k = 0; k < kPoints; ++k) {
        m[k] = __vimin3_s32(
            m[k], sq_dist_bits(px[k], py[k], pz[k], qx.x, qy.x, qz.x),
            sq_dist_bits(px[k], py[k], pz[k], qx.y, qy.y, qz.y));
        m[k] = __vimin3_s32(
            m[k], sq_dist_bits(px[k], py[k], pz[k], qx.z, qy.z, qz.z),
            sq_dist_bits(px[k], py[k], pz[k], qx.w, qy.w, qz.w));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPoints; ++k) s_min[tid + k * kThreads] = m[k];
  cluster.sync();  // every CTA's minima are in its shared memory
  const int part = kTilePoints / S;
  for (int e = rank * part + tid; e < (rank + 1) * part; e += kThreads) {
    int v = s_min[e];
    for (int q = 0; q < S; ++q) {
      if (q != rank) v = min(v, cluster.map_shared_rank(&s_min[0], q)[e]);
    }
    if (tile0 + e < N) {
      out[static_cast<size_t>(b) * N + tile0 + e] = __int_as_float(v);
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its minima
}

int tiles_of(int N) { return (N + kTilePoints - 1) / kTilePoints; }

// The fixed rule for the cluster size S; see the header.
int split(int B, int N, int k0) {
  const long long tiles = static_cast<long long>(B) * tiles_of(N);
  int s = 1;
  while (s < kMaxSplit && tiles * s < kMinCtas &&
         (k0 + 2 * s - 1) / (2 * s) >= kMinShare) {
    s *= 2;
  }
  return s;
}

cudaError_t launch(const float* xyz, const float* seeds, float* out, int B,
                   int N, int k0, cudaStream_t stream) {
  const int S = split(B, N, k0);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_of(N) * S, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  // max active clusters per cluster size (index log2 S), 0 = not yet asked
  static int checked[5] = {0, 0, 0, 0, 0};
  const int slot = __builtin_ctz(static_cast<unsigned>(S));
  if (checked[slot] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        seed_min_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(seed_min_kernel), &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    checked[slot] = n;
  }
  const int share = ((k0 + S - 1) / S + 3) & ~3;
  return cudaLaunchKernelEx(&cfg, seed_min_kernel, xyz, seeds, out, N, k0,
                            share);
}

}  // namespace

extern "C" {

// The launch over (B, N, k0): shape[0] = S (CTAs a cluster), shape[1] =
// points a thread, shape[2] = CTAs of the grid, shape[3] = threads a CTA.
// Returns 0.
int spsnet_seed_min_shape(int B, int N, int k0, int* shape) {
  shape[0] = split(B, N, k0);
  shape[1] = kPoints;
  shape[2] = B * tiles_of(N) * shape[0];
  shape[3] = kThreads;
  return 0;
}

// xyz (B, N, 3) fp32 contiguous; seeds (B, k0, 3) fp32 contiguous;
// out (B, N) fp32. Returns a cudaError_t code (0 on success).
int spsnet_seed_min(const void* xyz, const void* seeds, void* out, int B,
                    int N, int k0, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || k0 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch(
      static_cast<const float*>(xyz), static_cast<const float*>(seeds),
      static_cast<float*>(out), B, N, k0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
