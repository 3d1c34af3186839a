// Exact and seeded farthest point sampling for Hopper (sm_90a).
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
// npoint - k0 steps. Same bound and design as `fps` below.
//
// Function: (B, N, 3) fp32 -> (B, npoint) int64. The first pick is index 0
// (or the first valid point under a mask); each step lowers every point's
// running min squared distance by its distance to the last pick and picks
// the argmax, the lowest index winning ties. Masked-out points hold
// distance -1, so they lose to any valid point.
//
// What bounds it on the H100: the npoint-1 steps form a serial chain, and
// each step is a full pass over N points followed by a block-wide argmax.
// The bytes (12 B per point, read once) and the FLOPs (~10 per point per
// step) are far below the card's rates; the chain's latency is the cost.
//
// Design: one CTA of 1024 threads per batch row. Thread t owns points
// t, t+1024, t+2048, ... and keeps their running min distance in registers
// for the whole chain (PPT = ceil(N/1024) rounded up to a power of two).
// The coordinates are staged once into shared memory as three planes when
// they fit (N <= ~19k on the H100); above that they are read from global
// memory, where the L1/L2 caches serve them. One step: update the registers
// and take the thread's best (value, index); reduce across the warp with
// xor shuffles; one warp-result pair per warp goes to a double-buffered
// shared slot; after one __syncthreads every warp reduces the 32 slots
// itself, so all threads know the winner without a second barrier (the
// double buffer keeps a fast warp from overwriting slots a slow warp is
// still reading). Known limit: B rows fill only B of the 132 SMs.
//
// Rounding: d2 = (dx*dx + dy*dy) + dz*dz with every product and sum
// rounded separately (__fmul_rn/__fadd_rn, which nvcc never contracts into
// FMAs), in the order of the plain PyTorch version, so both pick the same
// indices.
#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 64 * kThreads;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (value desc, index asc) is a total order, so the butterfly leaves every
// lane holding the same maximum.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// kSeeded: d0 (B, N) and seeds (B, k0) are given and valid is NULL.
template <int PPT, bool kSmem, bool kSeeded>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
               const float* __restrict__ d0, const int64_t* __restrict__ seeds,
               int64_t* __restrict__ out, int N, int npoint, int k0) {
  extern __shared__ float planes[];  // x | y | z, N floats each (kSmem only)
  __shared__ float s_val[2][kWarps];
  __shared__ int s_idx[2][kWarps];
  __shared__ int s_first;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  const uint8_t* vm =
      valid ? valid + static_cast<size_t>(blockIdx.x) * N : nullptr;
  int64_t* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const float* dz0 = kSeeded ? d0 + static_cast<size_t>(blockIdx.x) * N
                             : nullptr;
  const int64_t* sd =
      kSeeded ? seeds + static_cast<size_t>(blockIdx.x) * k0 : nullptr;

  if (kSmem) {
    for (int i = tid; i < N; i += kThreads) {
      planes[i] = pts[3 * i];
      planes[N + i] = pts[3 * i + 1];
      planes[2 * N + i] = pts[3 * i + 2];
    }
  }
  if (tid == 0) s_first = N;
  __syncthreads();

  // coordinate planes: shared memory (stride 1) or the AoS input (stride 3)
  const float* xs = kSmem ? planes : pts;
  const float* ys = kSmem ? planes + N : pts + 1;
  const float* zs = kSmem ? planes + 2 * N : pts + 2;
  constexpr int st = kSmem ? 1 : 3;

  float dist[PPT];
  int my_first = INT_MAX;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * kThreads;
    if (kSeeded) {
      dist[k] = i < N ? dz0[i] : -1.0f;
    } else {
      const bool ok = i < N && (vm == nullptr || vm[i] != 0);
      dist[k] = ok ? 1e10f : -1.0f;
      if (ok && my_first == INT_MAX) my_first = i;
    }
  }
  if (vm != nullptr && my_first != INT_MAX) atomicMin(&s_first, my_first);
  __syncthreads();

  int last, j0;
  if (kSeeded) {
    // the seeds verbatim, then the chain from the last seed (its distances
    // are already in d0; the first step recomputes them, min is idempotent)
    for (int s = tid; s < k0; s += kThreads) o[s] = sd[s];
    last = static_cast<int>(sd[k0 - 1]);
    j0 = k0;
  } else {
    // index 0, or the first valid point (0 when none is valid)
    last = (vm != nullptr && s_first < N) ? s_first : 0;
    if (tid == 0) o[0] = last;
    j0 = 1;
  }
  float lx = xs[last * st], ly = ys[last * st], lz = zs[last * st];

  for (int j = j0; j < npoint; ++j) {
    float bv = -FLT_MAX;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * kThreads;
      if (i < N) {
        const float d = fminf(
            dist[k], sq_dist(xs[i * st], ys[i * st], zs[i * st], lx, ly, lz));
        dist[k] = d;
        if (d > bv) {  // strict: the lower index (earlier k) keeps ties
          bv = d;
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);
    const int buf = j & 1;
    if (lane == 0) {
      s_val[buf][warp] = bv;
      s_idx[buf][warp] = bi;
    }
    __syncthreads();
    bv = s_val[buf][lane];
    bi = s_idx[buf][lane];
    warp_argmax(bv, bi);
    last = bi;
    if (tid == 0) o[j] = last;
    lx = xs[last * st];
    ly = ys[last * st];
    lz = zs[last * st];
  }
}

template <int PPT, bool kSeeded>
cudaError_t launch(const float* xyz, const uint8_t* valid, const float* d0,
                   const int64_t* seeds, int64_t* out, int B, int N,
                   int npoint, int k0, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(float);
  // keep 1 KB for the kernel's static shared arrays
  if (smem + 1024 <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(fps_kernel<PPT, true, kSeeded>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fps_kernel<PPT, true, kSeeded><<<B, kThreads, smem, stream>>>(
        xyz, valid, d0, seeds, out, N, npoint, k0);
  } else {
    fps_kernel<PPT, false, kSeeded><<<B, kThreads, 0, stream>>>(
        xyz, valid, d0, seeds, out, N, npoint, k0);
  }
  return cudaGetLastError();
}

// one instantiation per power-of-two share of points per thread
template <bool kSeeded>
cudaError_t dispatch(const float* xyz, const uint8_t* valid, const float* d0,
                     const int64_t* seeds, int64_t* out, int B, int N,
                     int npoint, int k0, cudaStream_t s) {
  const int ppt = (N + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, s);
  if (ppt <= 2) return launch<2, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, s);
  if (ppt <= 4) return launch<4, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, s);
  if (ppt <= 8) return launch<8, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, s);
  if (ppt <= 16) return launch<16, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, s);
  if (ppt <= 32) return launch<32, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, s);
  return launch<64, kSeeded>(xyz, valid, d0, seeds, out, B, N, npoint, k0, s);
}

}  // namespace

extern "C" {

int spsnet_fps_max_n() { return kMaxN; }

// xyz (B, N, 3) fp32 contiguous; valid (B, N) uint8 or NULL;
// out (B, npoint) int64. Returns a cudaError_t code (0 on success).
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
