// Exact farthest point sampling with a hierarchical argmax, for Hopper
// (sm_90a).
//
// `fps_hier` replaces the TPU kernel `_fps_kernel_unrolled_b_v2`
// (spsnet_tpu/ops/pallas/fps.py:239, through `_fps_pallas_allbatch_v2`),
// which the JAX package does not dispatch. It keeps that kernel's idea: find
// the maximum first, then the lowest index among the points that hold it,
// instead of reducing (value, index) pairs in one pass as K1 (csrc/fps.cu)
// does.
//
// Function: (B, N, 3) fp32 -> (B, npoint) int64, K1's function: the first
// pick is index 0; each step lowers every point's running min squared
// distance by its distance to the last pick and picks the argmax, the
// lowest index winning ties. Slots past N (the JAX entry pads N to 128
// lanes) hold distance -1 and are never picked.
//
// What bounds it on the H100: the npoint - 1 steps are a serial chain, as
// in K1; bytes and FLOPs are far below the card's rates.
//
// Design: one CTA of 1024 threads per row, each thread keeping its points'
// running minima in registers (PPT = ceil(N / 1024) rounded up to a power
// of two) and the coordinates staged in shared memory as three planes when
// they fit (N <= ~19k), read from global memory otherwise. A step has two
// stages, each a warp reduction in hardware (`redux.sync`, sm_80 and later)
// and one barrier:
//   1. max: each thread takes the max of its minima; `__reduce_max_sync`
//      over the warp on the float's int bits (for fp32 >= 0 the bits are
//      monotone, and the padding value -1.0f is negative as an int, so the
//      int max is the float max); one slot per warp in shared memory, a
//      barrier, and every warp reduces the 32 slots the same way;
//   2. index: each thread takes its lowest index whose minimum equals the
//      max (INT_MAX if none); `__reduce_min_sync` over the warp, one slot
//      per warp, a barrier, and every warp reduces the 32 slots.
// Single-buffered slots suffice: a warp writes the max slots of step j + 1
// only after the index barrier of step j, which every warp reaches after
// reading the max slots of step j; it writes the index slots of step j + 1
// after the max barrier of step j + 1, which every warp reaches after
// reading the index slots of step j.
//
// Rounding: d2 = (dx*dx + dy*dy) + dz*dz with every product and sum
// rounded separately (__fmul_rn/__fadd_rn, built with -fmad=false), the
// plain PyTorch version's order, so both pick the same indices.
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

template <int PPT, bool kSmem>
__global__ void __launch_bounds__(kThreads)
    fps_hier_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out,
                    int N, int npoint) {
  extern __shared__ float planes[];  // x | y | z, N floats each (kSmem only)
  __shared__ int s_max[kWarps];
  __shared__ int s_idx[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  int64_t* o = out + static_cast<size_t>(blockIdx.x) * npoint;

  if (kSmem) {
    for (int i = tid; i < N; i += kThreads) {
      planes[i] = pts[3 * i];
      planes[N + i] = pts[3 * i + 1];
      planes[2 * N + i] = pts[3 * i + 2];
    }
  }
  __syncthreads();

  const float* xs = kSmem ? planes : pts;
  const float* ys = kSmem ? planes + N : pts + 1;
  const float* zs = kSmem ? planes + 2 * N : pts + 2;
  constexpr int st = kSmem ? 1 : 3;

  // int bits of each point's running min; -1.0f marks a slot past N
  int bits[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    bits[k] = __float_as_int(tid + k * kThreads < N ? 1e10f : -1.0f);
  }
  if (tid == 0) o[0] = 0;
  float lx = xs[0], ly = ys[0], lz = zs[0];

  for (int j = 1; j < npoint; ++j) {
    // stage 1: the max of the running minima
    int m = __float_as_int(-1.0f);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * kThreads;
      if (i < N) {
        const float d =
            fminf(__int_as_float(bits[k]),
                  sq_dist(xs[i * st], ys[i * st], zs[i * st], lx, ly, lz));
        bits[k] = __float_as_int(d);
        m = max(m, bits[k]);
      }
    }
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) s_max[warp] = m;
    __syncthreads();
    m = __reduce_max_sync(kFull, s_max[lane]);

    // stage 2: the lowest index that holds it
    int idx = INT_MAX;
#pragma unroll
    for (int k = PPT - 1; k >= 0; --k) {  // the lowest k wins
      const int i = tid + k * kThreads;
      if (i < N && bits[k] == m) idx = i;
    }
    idx = __reduce_min_sync(kFull, idx);
    if (lane == 0) s_idx[warp] = idx;
    __syncthreads();
    idx = __reduce_min_sync(kFull, s_idx[lane]);

    if (tid == 0) o[j] = idx;
    lx = xs[idx * st];
    ly = ys[idx * st];
    lz = zs[idx * st];
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int64_t* out, int B, int N, int npoint,
                   cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(float);
  // keep 1 KB for the kernel's static shared arrays
  if (smem + 1024 <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(fps_hier_kernel<PPT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fps_hier_kernel<PPT, true><<<B, kThreads, smem, stream>>>(xyz, out, N,
                                                              npoint);
  } else {
    fps_hier_kernel<PPT, false><<<B, kThreads, 0, stream>>>(xyz, out, N,
                                                            npoint);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int spsnet_fps_hier_max_n() { return kMaxN; }

// xyz (B, N, 3) fp32 contiguous; out (B, npoint) int64.
// Returns a cudaError_t code (0 on success).
int spsnet_fps_hier(const void* xyz, void* out, int B, int N, int npoint,
                    void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || npoint < 1 || npoint > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xyz);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (N + kThreads - 1) / kThreads;
  cudaError_t err;
  if (ppt <= 1) err = launch<1>(x, o, B, N, npoint, s);
  else if (ppt <= 2) err = launch<2>(x, o, B, N, npoint, s);
  else if (ppt <= 4) err = launch<4>(x, o, B, N, npoint, s);
  else if (ppt <= 8) err = launch<8>(x, o, B, N, npoint, s);
  else if (ppt <= 16) err = launch<16>(x, o, B, N, npoint, s);
  else if (ppt <= 32) err = launch<32>(x, o, B, N, npoint, s);
  else err = launch<64>(x, o, B, N, npoint, s);
  return static_cast<int>(err);
}

}  // extern "C"
