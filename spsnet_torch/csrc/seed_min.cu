// Min squared distance of each point to a set of seeds, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_seed_min_kernel` (spsnet_tpu/ops/pallas/fps.py:
// 461, through `_seed_min_d2` :488), the parallel prepass of seeded FPS: its
// output starts the running min of `fps_seeded` (csrc/fps.cu).
//
// Function: (B, N, 3) points, (B, k0, 3) seeds -> (B, N) fp32, the min over
// the seeds of d2 = (dx*dx + dy*dy) + dz*dz with d = point - seed, every
// product and sum rounded separately (__fsub_rn/__fmul_rn/__fadd_rn, built
// with -fmad=false), in the order of the plain PyTorch version. Min is exact
// in any order, so the result equals the plain version bit for bit.
//
// What bounds it on the H100: about 9 operations per (point, seed) pair
// (3 sub, 3 mul, 2 add, 1 min) over B*N*k0 pairs, against 12 bytes read per
// point and per seed and 4 written per point: operations, by far (201 M pairs
// at B=4, N=16384, k0=3072). The TPU kernel tiled (seeds x points) blocks and
// min-accumulated across the grid; here nothing of the (B, N, k0) pairs
// touches memory at all.
//
// Design: grid (ceil(N / 256), B), one point per thread, its coordinates and
// running min in registers. The block stages the row's seeds through shared
// memory in tiles of 1024 as float4; every thread of a warp reads the same
// seed, a broadcast without bank conflicts.
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // seeds per shared-memory tile (16 KB)

__global__ void __launch_bounds__(kThreads)
    seed_min_kernel(const float* __restrict__ xyz,
                    const float* __restrict__ seeds, float* __restrict__ out,
                    int N, int k0) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // threads past the row's end load its last point, join the barriers and
  // write nothing
  const float* p = xyz + (static_cast<size_t>(b) * N + min(i, N - 1)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float* sb = seeds + static_cast<size_t>(b) * k0 * 3;

  float m = INFINITY;
  for (int t0 = 0; t0 < k0; t0 += kTile) {
    const int n = min(kTile, k0 - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int s = threadIdx.x; s < n; s += kThreads) {
      const float* q = sb + static_cast<size_t>(t0 + s) * 3;
      tile[s] = make_float4(q[0], q[1], q[2], 0.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float4 q = tile[s];
      const float dx = __fsub_rn(px, q.x);
      const float dy = __fsub_rn(py, q.y);
      const float dz = __fsub_rn(pz, q.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      m = fminf(m, d2);
    }
  }
  if (i < N) out[static_cast<size_t>(b) * N + i] = m;
}

}  // namespace

extern "C" {

// xyz (B, N, 3) fp32 contiguous; seeds (B, k0, 3) fp32 contiguous;
// out (B, N) fp32. Returns a cudaError_t code (0 on success).
int spsnet_seed_min(const void* xyz, const void* seeds, void* out, int B,
                    int N, int k0, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || k0 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  seed_min_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(seeds),
      static_cast<float*>(out), N, k0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
