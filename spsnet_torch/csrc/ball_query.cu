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
// hit; a ball with no hit is all zeros.
//
// What bounds it on the H100: arithmetic and issue. Each (center, point)
// pair costs ~10 fp32 operations and a ballot; the bytes (points, centers,
// indices) are a few MB per layer. The scan stops early once every radius
// of a center has its nsample hits, so the work depends on the data.
//
// Design: one warp per center, eight centers per CTA. The CTA stages tiles
// of 1024 points of its batch row in shared memory as three planes; each
// warp walks the tile 32 points at a time: lane l tests point t0+l,
// __ballot_sync gives the hit mask, __popc of the lower lanes gives each
// hit its slot, so the slots follow index order exactly. A warp whose radii
// are all full stops testing; the CTA stops loading tiles once all eight
// are done (__syncthreads_and).
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

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Appends this 32-point chunk's hits to one radius's slot list.
__device__ __forceinline__ void take_hits(bool hit, int idx, int lane,
                                          int64_t* slots, int nsample,
                                          int& count, int& first) {
  const unsigned mask = __ballot_sync(kFull, hit);
  if (mask == 0u) return;
  if (count == 0) first = idx - lane + __ffs(mask) - 1;
  const int pos = count + __popc(mask & ((1u << lane) - 1u));
  if (hit && pos < nsample) slots[pos] = idx;
  count += __popc(mask);
}

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ ctr, int64_t* __restrict__ out_a,
                      int64_t* __restrict__ out_b, int N, int M, float r2a,
                      int nsa, float r2b, int nsb) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + warp;
  const bool active = m < M;
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  int64_t* sa = nullptr;
  int64_t* sb = nullptr;
  if (active) {
    const float* c = ctr + (static_cast<size_t>(b) * M + m) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
    sa = out_a + (static_cast<size_t>(b) * M + m) * nsa;
    if (nsb > 0) sb = out_b + (static_cast<size_t>(b) * M + m) * nsb;
  }
  int cnt_a = 0, cnt_b = 0, first_a = 0, first_b = 0;
  bool done = !active;

  for (int base = 0; base < N; base += kTile) {
    // all warps done -> stop; also the barrier before the tile is reused
    if (__syncthreads_and(done)) break;
    const int n = min(kTile, N - base);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* p = pts + 3 * (base + t);
      sx[t] = p[0];
      sy[t] = p[1];
      sz[t] = p[2];
    }
    __syncthreads();
    for (int t0 = 0; t0 < n && !done; t0 += 32) {
      const int t = t0 + lane;
      const float d2 = t < n ? sq_dist(cx, cy, cz, sx[t], sy[t], sz[t]) : 0.f;
      take_hits(t < n && d2 < r2a, base + t, lane, sa, nsa, cnt_a, first_a);
      if (nsb > 0) {
        take_hits(t < n && d2 < r2b, base + t, lane, sb, nsb, cnt_b, first_b);
      }
      done = cnt_a >= nsa && cnt_b >= nsb;  // warp-uniform
    }
  }

  if (active) {
    // pad past the last hit with the first hit; an empty ball stays 0
    for (int s = min(cnt_a, nsa) + lane; s < nsa; s += 32) sa[s] = first_a;
    for (int s = min(cnt_b, nsb) + lane; s < nsb; s += 32) sb[s] = first_b;
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3) and ctr (B, M, 3) fp32 contiguous; out_a (B, M, nsa) and
// out_b (B, M, nsb) int64 (out_b unused when nsb == 0). r2a/r2b are the
// squared radii. Returns a cudaError_t code (0 on success).
int spsnet_ball_query(const void* xyz, const void* ctr, void* out_a,
                      void* out_b, int B, int N, int M, float r2a, int nsa,
                      float r2b, int nsb, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || nsa < 1 || nsb < 0 ||
      (nsb > 0 && out_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  ball_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ctr),
      static_cast<int64_t*>(out_a), static_cast<int64_t*>(out_b), N, M, r2a,
      nsa, r2b, nsb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
