// Exact farthest point sampling with several batch rows in one CTA, for
// Hopper (sm_90a).
//
// `fps_rows` replaces two TPU kernels that explore one idea, advancing every
// batch row in one step loop: `_fps_kernel_batched` (spsnet_tpu/ops/pallas/
// fps.py:73, through `farthest_point_sample_pallas_batched`, with (B, 1, 1)
// broadcasts) and `_fps_kernel_batched2d` (fps.py:677, through
// `farthest_point_sample_pallas_batched2d`, in a 2-D (B*R, 128) layout with
// selector matmuls). Neither is dispatched by the JAX package.
//
// Function: (B, N, 3) fp32 -> (B, npoint) int64, the function of K1
// (csrc/fps.cu): the first pick is index 0; each step lowers every point's
// running min squared distance by its distance to the last pick and picks
// the argmax, the lowest index winning ties. Slots past N (the JAX entries
// pad N to 128 lanes) hold distance -1 and are never picked.
//
// What bounds it on the H100: as K1, the npoint - 1 steps are a serial
// chain of a pass over N points and an argmax; the bytes and FLOPs are far
// below the card's rates. A CTA per row leaves most SMs idle and a row of
// few points wastes most of a 1024-thread CTA.
//
// Design: the GPU form of the TPU's "all rows in one loop" is a CTA of 1024
// threads that holds G rows and advances them in lock-step, one barrier per
// step for all G rows. Each row gets T = 1024 / G threads (whole warps) and
// each thread keeps the running minima of its points in registers, PPT =
// ceil(N / T) rounded up to a power of two. G is the largest power of two
// <= B with PPT <= 16 (at most 32 rows, one warp each): G = 1 at N = 16384,
// where this is K1's layout, G = 4 at N = 4096. The coordinates of the G
// rows are staged once into shared memory as three planes per row when
// they fit (always when G > 1) and read from global memory otherwise. A
// step: update the registers, take the thread's best (value desc, index
// asc), reduce across the warp with xor shuffles, write one pair per warp
// to a double-buffered shared slot, one __syncthreads, then every warp
// reduces its own row's slots, so all threads of a row know its winner.
//
// Rounding: d2 = (dx*dx + dy*dy) + dz*dz with every product and sum
// rounded separately (__fmul_rn/__fadd_rn, built with -fmad=false), the
// plain PyTorch version's order, so both pick the same indices.
#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPpt = 64;
constexpr int kRowPpt = 16;  // points a thread holds when rows share a CTA
constexpr int kMaxRows = kWarps;

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

// G rows of the batch per CTA, T = kThreads / G threads per row.
template <int PPT, bool kSmem>
__global__ void __launch_bounds__(kThreads)
    fps_rows_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out,
                    int B, int N, int npoint, int G) {
  extern __shared__ float planes[];  // per row: x | y | z, N floats each
  __shared__ float s_val[2][kWarps];
  __shared__ int s_idx[2][kWarps];

  const int T = kThreads / G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = tid / T;               // row within the CTA
  const int t = tid - r * T;           // thread within the row
  const int row_warps = T / 32;
  const int b = blockIdx.x * G + r;    // batch row; >= B: an idle row
  const bool live = b < B;
  const float* pts = xyz + static_cast<size_t>(live ? b : 0) * N * 3;

  if (kSmem) {
    float* p = planes + static_cast<size_t>(r) * N * 3;
    for (int i = t; live && i < N; i += T) {
      p[i] = pts[3 * i];
      p[N + i] = pts[3 * i + 1];
      p[2 * N + i] = pts[3 * i + 2];
    }
  }
  __syncthreads();

  const float* base = kSmem ? planes + static_cast<size_t>(r) * N * 3 : pts;
  const float* xs = base;
  const float* ys = kSmem ? base + N : base + 1;
  const float* zs = kSmem ? base + 2 * N : base + 2;
  constexpr int st = kSmem ? 1 : 3;
  const int n = live ? N : 0;  // an idle row holds no point

  float dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) dist[k] = t + k * T < n ? 1e10f : -1.0f;

  int64_t* o = out + static_cast<size_t>(live ? b : 0) * npoint;
  if (live && t == 0) o[0] = 0;
  float lx = live ? xs[0] : 0.0f, ly = live ? ys[0] : 0.0f,
        lz = live ? zs[0] : 0.0f;

  for (int j = 1; j < npoint; ++j) {
    float bv = -FLT_MAX;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = t + k * T;
      if (i < n) {
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
    // this row's warps are r * row_warps .. (r + 1) * row_warps - 1
    bv = lane < row_warps ? s_val[buf][r * row_warps + lane] : -FLT_MAX;
    bi = lane < row_warps ? s_idx[buf][r * row_warps + lane] : INT_MAX;
    warp_argmax(bv, bi);
    if (live) {
      if (t == 0) o[j] = bi;
      lx = xs[bi * st];
      ly = ys[bi * st];
      lz = zs[bi * st];
    }
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int64_t* out, int B, int N, int npoint,
                   int G, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(G) * N * 3 * sizeof(float);
  const int grid = (B + G - 1) / G;
  // keep 1 KB for the kernel's static shared arrays
  if (smem + 1024 <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(fps_rows_kernel<PPT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fps_rows_kernel<PPT, true><<<grid, kThreads, smem, stream>>>(
        xyz, out, B, N, npoint, G);
  } else if (G == 1) {
    fps_rows_kernel<PPT, false><<<grid, kThreads, 0, stream>>>(
        xyz, out, B, N, npoint, G);
  } else {
    return cudaErrorInvalidConfiguration;  // rows_per_cta never allows this
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int spsnet_fps_rows_max_n() { return kMaxPpt * kThreads; }

// Rows a CTA holds for B rows of N points: the largest power of two <= B
// (at most kMaxRows) whose rows keep at most kRowPpt points a thread.
int spsnet_fps_rows_per_cta(int B, int N) {
  int g = 1;
  while (2 * g <= B && 2 * g <= kMaxRows &&
         N <= kRowPpt * (kThreads / (2 * g))) {
    g *= 2;
  }
  return g;
}

// xyz (B, N, 3) fp32 contiguous; out (B, npoint) int64.
// Returns a cudaError_t code (0 on success).
int spsnet_fps_rows(const void* xyz, void* out, int B, int N, int npoint,
                    void* stream) {
  if (B < 1 || N < 1 || N > kMaxPpt * kThreads || npoint < 1 || npoint > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = spsnet_fps_rows_per_cta(B, N);
  const int T = kThreads / G;
  const int ppt = (N + T - 1) / T;
  const float* x = static_cast<const float*>(xyz);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ppt <= 1) err = launch<1>(x, o, B, N, npoint, G, s);
  else if (ppt <= 2) err = launch<2>(x, o, B, N, npoint, G, s);
  else if (ppt <= 4) err = launch<4>(x, o, B, N, npoint, G, s);
  else if (ppt <= 8) err = launch<8>(x, o, B, N, npoint, G, s);
  else if (ppt <= 16) err = launch<16>(x, o, B, N, npoint, G, s);
  else if (ppt <= 32) err = launch<32>(x, o, B, N, npoint, G, s);
  else err = launch<64>(x, o, B, N, npoint, G, s);
  return static_cast<int>(err);
}

}  // extern "C"
