// The three nearest known points of each unknown point, for Hopper (sm_90a).
//
// Not the port of a TPU kernel: the JAX package computes `three_nn`
// (spsnet_tpu/ops/interpolate.py:15) in XLA, as a dense distance matrix and
// a top-k. The port's plain version (spsnet_torch/ops/interpolate.py)
// writes every product and sum out as its own elementwise op over blocks of
// (B, chunk, M) entries: ~70 bytes of memory traffic a pair and ~250 blocks
// a call at a 150 000-row source. PV-RCNN++'s VectorPool interpolation
// (spsnet_torch/models/model_utils/vector_pool.py) runs it over up to
// 3.3e10 pairs a call, and PointRCNN's FP layers over 1.3e8.
//
// Function: unknown (B, N, 3), known (B, M, 3) fp32, M >= 3 -> dist2 (B, N,
// 3) fp32 and idx (B, N, 3) int64, the 3 smallest of
//   d2 = (|u|^2 + |k|^2) - 2 * cross,  |p|^2 = (x*x + y*y) + z*z,
//   cross = (ux*kx + uy*ky) + uz*kz,
// ascending by (d2, index): the lowest index wins a tie, as the plain
// version's repeated first-argmin does. Every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn, and the build passes
// -fmad=false), in the plain version's order, so both give the same bits.
//
// What bounds it on the H100: operations. A pair costs 8 fp32 operations
// (3 mul and 2 add for the cross product, the sum of the norms, the doubling
// and the subtraction) and a compare against 12 bytes read a known point and
// a query: ~9 operations a pair, 67 TFLOP/s fp32.
//
// Design (right first; the speed work is for later):
//  - One thread a query: its |u|^2 and the best three (d2, index) live in
//    registers, updated with strict `<` while the known points are scanned
//    in index order, so an equal distance keeps the earlier index.
//  - The known points of the batch row are staged through shared memory in
//    tiles of kTile (x, y, z, |k|^2) records; every thread of the CTA reads
//    the same record at a time (a broadcast).
//  - Every known point is scanned, the padded rows of a level included.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ unknown,
                const float* __restrict__ known, float* __restrict__ dist,
                int64_t* __restrict__ idx, int N, int M) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool active = n < N;
  const float* q =
      unknown + (static_cast<int64_t>(b) * N + (active ? n : 0)) * 3;
  const float ux = q[0], uy = q[1], uz = q[2];
  const float usq = sq_norm(ux, uy, uz);
  const float* kb = known + static_cast<int64_t>(b) * M * 3;
  float d0 = __int_as_float(0x7f800000), d1 = d0, d2 = d0;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int base = 0; base < M; base += kTile) {
    const int count = min(kTile, M - base);
    __syncthreads();
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const float* p = kb + static_cast<int64_t>(base + j) * 3;
      const float x = p[0], y = p[1], z = p[2];
      tile[j] = make_float4(x, y, z, sq_norm(x, y, z));
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float4 k = tile[j];
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(ux, k.x), __fmul_rn(uy, k.y)),
          __fmul_rn(uz, k.z));
      const float d = __fsub_rn(__fadd_rn(usq, k.w), __fmul_rn(2.0f, cross));
      if (d < d2) {
        const int i = base + j;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = i;
          } else {
            d1 = d;
            i1 = i;
          }
        } else {
          d2 = d;
          i2 = i;
        }
      }
    }
  }
  if (active) {
    const int64_t o = (static_cast<int64_t>(b) * N + n) * 3;
    dist[o] = d0;
    dist[o + 1] = d1;
    dist[o + 2] = d2;
    idx[o] = i0;
    idx[o + 1] = i1;
    idx[o + 2] = i2;
  }
}

}  // namespace

extern "C" {

// unknown (B, N, 3) and known (B, M, 3) fp32 contiguous; dist (B, N, 3)
// fp32, idx (B, N, 3) int64. Returns a cudaError_t code (0 on success).
int spsnet_three_nn(const void* unknown, const void* known, void* dist,
                    void* idx, int B, int N, int M, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  three_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(unknown), static_cast<const float*>(known),
      static_cast<float*>(dist), static_cast<int64_t*>(idx), N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
