// Farthest point sampling over a precomputed squared-distance matrix
// (F-FPS) for Hopper (sm_90a), one CTA a batch row.
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
// gives NaN) and picks their argmax, NaN above every number and the lowest
// index winning ties (torch.argmax, jnp.argmax). No clamp and no early exit.
//
// What bounds it on the H100: the npoint - 1 steps form a serial chain, and
// each reads one row of N floats (coalesced) from the matrix, which does
// not fit in L2 at the paths' shapes (537 MB at (8, 4096)). A step costs a
// row's load latency, two warp reductions and one CTA barrier.
//
// Design: thread t of the CTA holds the running minima of columns
// t + k T in shared memory (N <= kMaxN floats) and keeps its best (value,
// index) while it walks them in increasing order, so its strict compare
// keeps the lowest index. Each warp reduces its 32 records with shuffles,
// lane 0 writes the warp's record to a slot (double-buffered by step
// parity), and after one barrier every warp reduces the slots the same
// way, so every thread knows the pick without a second barrier. A slot of
// step j + 2 is written only after every warp passed the barrier of step
// j + 1, i.e. after every warp read the slots of step j.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// 4 B of running minimum a column in shared memory, within the 227 KB a CTA
// can have on sm_90 beside the slots
constexpr int kMaxN = 57344;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// (v, i) ranks above (bv, bi): NaN above every number, then the larger
// value, then the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    fps_dist_kernel(const float* __restrict__ dist, int64_t* __restrict__ out,
                    int N, int npoint) {
  extern __shared__ float mind[];
  __shared__ float slot_v[2][32];
  __shared__ int slot_i[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, warps = T >> 5;
  const float* rows = dist + static_cast<size_t>(b) * N * N;
  int64_t* picks = out + static_cast<size_t>(b) * npoint;

  for (int j = tid; j < N; j += T) mind[j] = 1e10f;
  if (tid == 0) picks[0] = 0;
  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    const float* row = rows + static_cast<size_t>(last) * N;
    // the sentinel (-inf, INT_MAX): any column ranks above it
    float bv = neg_inf();
    int bi = INT_MAX;
    for (int j = tid; j < N; j += T) {
      const float a = mind[j], d = __ldg(row + j);
      const float v = (a < d || isnan(a)) ? a : d;
      mind[j] = v;
      if (better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    warp_best(bv, bi);
    const int p = s & 1;
    if (lane == 0) {
      slot_v[p][warp] = bv;
      slot_i[p][warp] = bi;
    }
    __syncthreads();
    bv = lane < warps ? slot_v[p][lane] : neg_inf();
    bi = lane < warps ? slot_i[p][lane] : INT_MAX;
    warp_best(bv, bi);
    last = bi;
    if (tid == 0) picks[s] = last;
  }
}

int threads_for(int N) {
  const int t = (N + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

extern "C" {

int spsnet_fps_dist_max_n() { return kMaxN; }

// dist (B, N, N) fp32 contiguous; out (B, npoint) int64, 1 <= npoint <= N.
// Returns a cudaError_t code.
int spsnet_fps_dist(const void* dist, void* out, int B, int N, int npoint,
                    void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || npoint < 1 || npoint > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fps_dist_kernel<<<B, threads_for(N), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<int64_t*>(out), N, npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
