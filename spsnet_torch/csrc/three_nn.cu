// The three nearest known points of each unknown point, for Hopper (sm_90a).
//
// Not the port of a TPU kernel: the JAX package computes `three_nn`
// (spsnet_tpu/ops/interpolate.py:15) in XLA, as a dense distance matrix and
// a top-k. The port's plain version (spsnet_torch/ops/interpolate.py)
// writes every product and sum out as its own elementwise op over blocks of
// (B, chunk, M) entries. PV-RCNN++'s VectorPool interpolation
// (spsnet_torch/models/model_utils/vector_pool.py) runs it over up to
// 3.3e10 pairs a call, and PointRCNN's FP layers over 1.3e8.
//
// Function: unknown (B, N, 3), known (B, M, 3) fp32, M >= 3 -> dist2 (B, N,
// 3) fp32 and idx (B, N, 3) int64, the 3 smallest of
//   d2 = (|u|^2 + |k|^2) - 2 * cross,  |p|^2 = (x*x + y*y) + z*z,
//   cross = (ux*kx + uy*ky) + uz*kz,
// in the order of the plain version's repeated argmin: a NaN before every
// number, and the lowest index first among equal distances (and among
// NaNs). Every product and sum is rounded on its own (__fmul_rn / __fadd_rn
// / __fsub_rn, and the build passes -fmad=false), in the plain version's
// order, so both give the same bits. The best three start at (+inf, index
// 0), which is what the plain version returns past the last finite
// distance.
//
// What bounds it on the H100: operations. A pair costs 8 fp32 operations
// and a compare; with each one rounded on its own (no FMA) they issue at
// half the card's 67 TFLOP/s, which counts an FMA as two. Over every pair
// of a PV-RCNN++ level (4096 x 27 cells against 150 000 rows) that is
// ~9 ms a call, so the design scans fewer pairs instead:
//
// 1. Only a prefix of the rows. A sparse level pads its rows past the
//    occupied ones with copies of one point (the VSA puts them at 1e6).
//    Rows that are bitwise equal give bitwise equal distances, and a later
//    row enters the best three only if it comes strictly before the third,
//    so of a run of equal rows only the first three can enter. For each
//    batch row b the pre-pass finds r_b, where the trailing run of rows
//    equal to row M-1 starts (atomicMax of i + 1 over the rows that differ
//    from it), and the scan reads rows [0, min(M, r_b + 3)) only. Exact on
//    any input; read on the card, with no host sync.
// 2. Only the sub-tiles that can change the answer. The pre-pass packs
//    each known point as (x, y, z, |k|^2) and gives each sub-tile of 32
//    consecutive rows its bounding box and its largest |k|^2 (+inf if a
//    row is not finite). A sparse level's rows lie in z-major key order,
//    so such a run of rows is compact. For its query u, a lane bounds from
//    below the rounded d2 of every point of a sub-tile:
//      lb = A - margin,  margin = 2^-20 * (|u|^2 + max|k|^2) + 2^-140,
//    A the squared distance from u to the box, every step of both rounded
//    toward the safe side (__fsub_rd, __fmul_rd, __fadd_rd for A,
//    __fadd_ru, __fmul_ru for the margin, lb by __fsub_rd). A sub-tile is
//    skipped when lb > d2_third for every query of the warp: then every
//    point of it has d2 >= lb > d2_third and cannot enter. Sub-tiles are
//    visited in index order and the third only moves earlier, so the
//    result is that of the full scan. The same bound holds for a box of
//    queries (the box's largest |u|^2 in the margin, A the squared
//    distance between the two boxes).
//    The margin: with eps = 2^-24 and S = |u|^2 + |k|^2 (real values),
//    each norm is off by at most 3 eps |p|^2 + 3 * 2^-150 (three products
//    that may underflow, two sums), the cross product by 3 eps |u||k| +
//    3 * 2^-150 <= 1.5 eps S + 3 * 2^-150, their sum by eps S (1 + 3 eps),
//    the doubling is exact, and the last subtraction by eps |d2| with
//    |u - k|^2 <= 2S. So |d2 - |u - k|^2| <= 9 eps S + 14 * 2^-150 to
//    first order, and S <= (|u|^2_rn + max|k|^2_rn + 6 * 2^-150)(1 + 4 eps)
//    for the rounded norms that the kernel holds. c = 16 (2^-20 = 16 eps)
//    and 2^-140 = 1024 * 2^-150 leave ample slack.
//    Never a skip on what the bound does not cover: a NaN or an infinite
//    norm or coordinate, or |u|^2 + max|k|^2 at 2^125 or more (where a sum
//    may overflow), sets lb to -inf, a NaN third best counts as +inf, and
//    a NaN compares false.
// 3. Warps on their own, and a cheap test first. A warp holds 32
//    consecutive queries, one a lane (the VSA orders them keypoint by
//    keypoint, cell by cell, so a group of 8 lanes lies around one or two
//    keypoints). It takes the sub-tiles 32 at a time: lane j loads the box
//    of sub-tile j into the warp's slice of shared memory and bounds it
//    against the box of each group of 8 queries, with the group's largest
//    third best (four bounds a lane for 32 sub-tiles). Where that culls
//    half of them or fewer (raw points in no spatial order, PointRCNN's
//    FPS-ordered rows), the warp scans the chunks of 4 sub-tiles that
//    hold a marked one with no further test, 128 rows a load. Where it
//    culls more, the warp takes the marked sub-tiles one by one, each lane
//    bounds its own query against the sub-tile with its thresholds now,
//    and the warp scans it if one lane may need it. Lane j loads row j
//    (coalesced; a level's 150 000 packed rows are 2.4 MB and stay in the
//    50 MB L2), and the pair loop reads each row back from shared memory
//    as a broadcast; the next load is issued before the current rows are
//    scanned. No CTA-wide barrier: a warp that skips moves on.
//
// Launch shape, a fixed rule: the pre-pass one thread a known row in CTAs
// of 256 (a warp a sub-tile), the scan 8 warps a CTA, grid (N / 256, B);
// the sweeps of CTA width, group and chunk are in launch_sweep.py.
// `pairs`, when not null, receives the pairs each batch row evaluated
// (int64, added to).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;          // known rows a sub-tile, one a lane
constexpr int kWarps = 8;          // warps a CTA of the scan
constexpr int kThreads = kWarps * 32;
constexpr int kPrepThreads = 256;  // the pre-pass: a warp a sub-tile
constexpr int kLanes = 8;          // queries a group of the warp-wide test
constexpr int kGroups = 32 / kLanes;
constexpr int kChunk = 4;          // sub-tiles a load where few are culled
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// The plain version's argmin order: NaN first, then by value.
__device__ __forceinline__ bool before(float d, float t) {
  return d < t || (d != d && t == t);
}

// At most the distance along one axis from a point of [ql, qh] to one of
// [lo, hi] (for a query, ql = qh).
__device__ __forceinline__ float gap_rd(float ql, float qh, float lo,
                                        float hi) {
  return fmaxf(fmaxf(__fsub_rd(lo, qh), __fsub_rd(ql, hi)), 0.0f);
}

// At most the rounded d2 of any query in the box (ql, qh) with |u|^2 <= qsq
// and any point of the sub-tile box (lo, hi), whose points have |k|^2 <=
// lo.w; -inf where that is not sure.
__device__ __forceinline__ float lower_bound(float3 ql, float3 qh, float qsq,
                                             float4 lo, float4 hi) {
  const float s = __fadd_ru(qsq, lo.w);
  if (!(s < 0x1p125f)) return -__int_as_float(0x7f800000);
  const float gx = gap_rd(ql.x, qh.x, lo.x, hi.x);
  const float gy = gap_rd(ql.y, qh.y, lo.y, hi.y);
  const float gz = gap_rd(ql.z, qh.z, lo.z, hi.z);
  const float a = __fadd_rd(__fadd_rd(__fmul_rd(gx, gx), __fmul_rd(gy, gy)),
                            __fmul_rd(gz, gz));
  const float margin = __fadd_ru(__fmul_ru(s, 0x1p-20f), 0x1p-140f);
  return __fsub_rd(a, margin);
}

// A query's best three (d2, index), in the argmin order.
struct Best {
  float d0, d1, d2;
  int i0, i1, i2;
};

// The pair of query u (|u|^2 = usq) and packed point k (row i), entered
// into the best three if it comes before the third.
__device__ __forceinline__ void offer(float3 u, float usq, float4 k, int i,
                                      Best& b) {
  const float cross = __fadd_rn(
      __fadd_rn(__fmul_rn(u.x, k.x), __fmul_rn(u.y, k.y)),
      __fmul_rn(u.z, k.z));
  const float d = __fsub_rn(__fadd_rn(usq, k.w), __fmul_rn(2.0f, cross));
  if (!(d >= b.d2) && before(d, b.d2)) {  // one compare in the common case
    if (before(d, b.d1)) {
      b.d2 = b.d1;
      b.i2 = b.i1;
      if (before(d, b.d0)) {
        b.d1 = b.d0;
        b.i1 = b.i0;
        b.d0 = d;
        b.i0 = i;
      } else {
        b.d1 = d;
        b.i1 = i;
      }
    } else {
      b.d2 = d;
      b.i2 = i;
    }
  }
}

__device__ __forceinline__ float4 packed_row(const float4* pb, int row,
                                             int M) {
  return row < M ? pb[row] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(kPrepThreads)
three_nn_prepass_kernel(const float* __restrict__ known,
                        float4* __restrict__ packed,
                        float4* __restrict__ boxes, int* __restrict__ run,
                        int M) {
  const float inf = __int_as_float(0x7f800000);
  const int b = blockIdx.y;
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const float* kb = known + static_cast<int64_t>(b) * M * 3;
  float lx = inf, ly = inf, lz = inf, hx = -inf, hy = -inf, hz = -inf;
  float mk = 0.0f;
  bool differs = false;
  if (i < M) {
    const float* p = kb + static_cast<int64_t>(i) * 3;
    const float x = p[0], y = p[1], z = p[2];
    const float w = sq_norm(x, y, z);
    packed[static_cast<int64_t>(b) * M + i] = make_float4(x, y, z, w);
    lx = hx = x;
    ly = hy = y;
    lz = hz = z;
    mk = isfinite(w) ? w : inf;  // a finite norm: every coordinate finite
    const float* e = kb + static_cast<int64_t>(M - 1) * 3;
    differs = __float_as_uint(x) != __float_as_uint(e[0]) ||
              __float_as_uint(y) != __float_as_uint(e[1]) ||
              __float_as_uint(z) != __float_as_uint(e[2]);
  }
  const unsigned diff = __ballot_sync(kFull, differs);
  const int base = i - lane;  // the sub-tile's first row
  if (lane == 0 && diff) atomicMax(run + b, base + 32 - __clz(diff));
  for (int o = 16; o > 0; o >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(kFull, lx, o));
    ly = fminf(ly, __shfl_xor_sync(kFull, ly, o));
    lz = fminf(lz, __shfl_xor_sync(kFull, lz, o));
    hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, o));
    hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, o));
    hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, o));
    mk = fmaxf(mk, __shfl_xor_sync(kFull, mk, o));
  }
  if (lane == 0 && base < M) {
    const int64_t t = static_cast<int64_t>(b) * ((M + kTile - 1) / kTile) +
                      base / kTile;
    boxes[2 * t] = make_float4(lx, ly, lz, mk);
    boxes[2 * t + 1] = make_float4(hx, hy, hz, 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
three_nn_scan_kernel(const float* __restrict__ unknown,
                     const float4* __restrict__ packed,
                     const float4* __restrict__ boxes,
                     const int* __restrict__ run, float* __restrict__ dist,
                     int64_t* __restrict__ idx,
                     unsigned long long* __restrict__ pairs, int N, int M) {
  __shared__ float4 s_box[kWarps][2 * kTile];
  __shared__ float4 s_pts[kWarps][kChunk * kTile];
  __shared__ float4 s_group[kWarps][2 * kGroups];
  const float inf = __int_as_float(0x7f800000);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool active = n < N;
  const float* q =
      unknown + (static_cast<int64_t>(b) * N + (active ? n : 0)) * 3;
  const float3 u = make_float3(q[0], q[1], q[2]);
  const float usq = sq_norm(u.x, u.y, u.z);
  float4* my_box = s_box[warp];
  float4* my_pts = s_pts[warp];
  float4* my_group = s_group[warp];
  // the box of each group of kLanes lanes' queries and their largest
  // |u|^2 (+inf where one is not finite); an empty group's box is empty
  {
    float lx = active ? u.x : inf, ly = active ? u.y : inf;
    float lz = active ? u.z : inf, hx = active ? u.x : -inf;
    float hy = active ? u.y : -inf, hz = active ? u.z : -inf;
    float w = active ? (isfinite(usq) ? usq : inf) : 0.0f;
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      lx = fminf(lx, __shfl_xor_sync(kFull, lx, o));
      ly = fminf(ly, __shfl_xor_sync(kFull, ly, o));
      lz = fminf(lz, __shfl_xor_sync(kFull, lz, o));
      hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, o));
      hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, o));
      hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, o));
      w = fmaxf(w, __shfl_xor_sync(kFull, w, o));
    }
    if (lane % kLanes == 0) {
      my_group[2 * (lane / kLanes)] = make_float4(lx, ly, lz, w);
      my_group[2 * (lane / kLanes) + 1] = make_float4(hx, hy, hz, 0.0f);
    }
  }
  const int limit = min(M, run[b] + 3);
  const int tiles = (limit + kTile - 1) / kTile;
  const float4* pb = packed + static_cast<int64_t>(b) * M;
  const float4* bb =
      boxes + static_cast<int64_t>(b) * ((M + kTile - 1) / kTile) * 2;
  Best best = {inf, inf, inf, 0, 0, 0};
  long long rows = 0;  // rows scanned by this warp
  for (int t0 = 0; t0 < tiles; t0 += kTile) {
    const int nb = min(kTile, tiles - t0);
    // each group's largest third best (+inf where one is NaN: no cull)
    float thr = active ? (best.d2 == best.d2 ? best.d2 : inf) : -inf;
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      thr = fmaxf(thr, __shfl_xor_sync(kFull, thr, o));
    }
    float group_thr[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      group_thr[g] = __shfl_sync(kFull, thr, g * kLanes);
    }
    // lane j: may sub-tile t0 + j change some group's answer?
    __syncwarp();
    bool may = false;
    if (lane < nb) {
      const float4 lo = bb[2 * (t0 + lane)], hi = bb[2 * (t0 + lane) + 1];
      my_box[2 * lane] = lo;
      my_box[2 * lane + 1] = hi;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 gl = my_group[2 * g], gh = my_group[2 * g + 1];
        may |= !(lower_bound(make_float3(gl.x, gl.y, gl.z),
                             make_float3(gh.x, gh.y, gh.z), gl.w, lo, hi) >
                 group_thr[g]);
      }
    }
    unsigned marked = __ballot_sync(kFull, may);
    __syncwarp();
    if (2 * __popc(marked) > nb) {
      // few culled: the chunks of kChunk sub-tiles that hold a marked one,
      // with no per-lane test; the next chunk's load issued before this
      // one's scan
      unsigned chunks = 0;  // bit c: chunk c holds a marked sub-tile
      for (int c = 0; c * kChunk < nb; ++c) {
        if ((marked >> (c * kChunk)) & ((1u << kChunk) - 1)) chunks |= 1u << c;
      }
      int c = __ffs(chunks) - 1;
      float4 next[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        next[k] = packed_row(pb, (t0 + c * kChunk + k) * kTile + lane, M);
      }
      while (chunks) {
        const int cur = c;
        chunks &= chunks - 1;
        __syncwarp();
#pragma unroll
        for (int k = 0; k < kChunk; ++k) my_pts[k * kTile + lane] = next[k];
        __syncwarp();
        if (chunks) {
          c = __ffs(chunks) - 1;
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            next[k] = packed_row(pb, (t0 + c * kChunk + k) * kTile + lane, M);
          }
        }
        const int base = (t0 + cur * kChunk) * kTile;
        const int count = min(kChunk * kTile, limit - base);
        if (count == kChunk * kTile) {
#pragma unroll 16
          for (int j = 0; j < kChunk * kTile; ++j) {
            offer(u, usq, my_pts[j], base + j, best);
          }
        } else {
          for (int j = 0; j < count; ++j) {
            offer(u, usq, my_pts[j], base + j, best);
          }
        }
        rows += count;
      }
      continue;
    }
    // most culled: the marked sub-tiles one by one, each checked again
    // per lane with its thresholds now; the next one's load issued first
    if (!marked) continue;
    int t = __ffs(marked) - 1;
    float4 next = packed_row(pb, (t0 + t) * kTile + lane, M);
    while (marked) {
      const int cur = t;
      marked &= marked - 1;
      __syncwarp();
      my_pts[lane] = next;
      __syncwarp();
      if (marked) {
        t = __ffs(marked) - 1;
        next = packed_row(pb, (t0 + t) * kTile + lane, M);
      }
      const float lb =
          lower_bound(u, u, usq, my_box[2 * cur], my_box[2 * cur + 1]);
      if (!__any_sync(kFull, active && !(lb > best.d2))) continue;
      const int base = (t0 + cur) * kTile;
      const int count = min(kTile, limit - base);
      rows += count;
      if (count == kTile) {
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) {
          offer(u, usq, my_pts[j], base + j, best);
        }
      } else {
        for (int j = 0; j < count; ++j) {
          offer(u, usq, my_pts[j], base + j, best);
        }
      }
    }
  }
  const int lanes = __popc(__ballot_sync(kFull, active));
  if (pairs != nullptr && lane == 0 && rows > 0) {
    atomicAdd(pairs + b, static_cast<unsigned long long>(rows) * lanes);
  }
  if (active) {
    const int64_t o = (static_cast<int64_t>(b) * N + n) * 3;
    dist[o] = best.d0;
    dist[o + 1] = best.d1;
    dist[o + 2] = best.d2;
    idx[o] = best.i0;
    idx[o + 1] = best.i1;
    idx[o + 2] = best.i2;
  }
}

int tiles_of(int M) { return (M + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// The workspace of a call, in 16-byte units: the packed rows (B, M), the
// sub-tiles' boxes (B, tiles, 2) and the runs' starts (B,) int32.
int spsnet_three_nn_workspace(int B, int M) {
  return B * M + 2 * B * tiles_of(M) + (B + 3) / 4;
}

// unknown (B, N, 3) and known (B, M, 3) fp32 contiguous; dist (B, N, 3)
// fp32, idx (B, N, 3) int64; workspace spsnet_three_nn_workspace(B, M)
// 16-byte units, 16-byte aligned; pairs null or (B,) int64, added to.
// Launches the pre-pass and the scan on `stream`. Returns a cudaError_t
// code (0 on success).
int spsnet_three_nn(const void* unknown, const void* known, void* dist,
                    void* idx, void* workspace, void* pairs, int B, int N,
                    int M, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 3 || M > (1 << 30) / B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* packed = static_cast<float4*>(workspace);
  float4* boxes = packed + static_cast<int64_t>(B) * M;
  int* run = reinterpret_cast<int*>(boxes + 2 * static_cast<int64_t>(B) *
                                                tiles_of(M));
  cudaError_t err = cudaMemsetAsync(run, 0, sizeof(int) * B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  three_nn_prepass_kernel<<<dim3((M + kPrepThreads - 1) / kPrepThreads, B),
                            kPrepThreads, 0, s>>>(
      static_cast<const float*>(known), packed, boxes, run, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  three_nn_scan_kernel<<<dim3((N + kThreads - 1) / kThreads, B), kThreads, 0,
                         s>>>(
      static_cast<const float*>(unknown), packed, boxes, run,
      static_cast<float*>(dist), static_cast<int64_t*>(idx),
      static_cast<unsigned long long*>(pairs), N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
