"""3-NN search and inverse-distance-weighted interpolation, channel-last.

Port of ``spsnet_tpu/ops/interpolate.py`` (the rebuild of
``interpolate_gpu.cu:16-177``). ``three_nn`` returns squared distances in
the |a|^2 + |b|^2 - 2ab form of ``calc_square_dist``, ascending, the lowest
index first among equal distances (the ``jax.lax.top_k`` order). Every sum
here is written out term by term, each product and sum its own rounded
elementwise op, so a CUDA tensor and a CPU tensor give the same bits; the
distance matrix is built in blocks of unknown points, which changes no
value. ``three_nn`` runs that plain version for a CPU tensor and the CUDA
kernel ``csrc/three_nn.cu`` (K6), which computes the same bits, for a CUDA
tensor; the JAX package computes it outside any Pallas kernel, in XLA, so
K6 ports no TPU kernel. The interpolation is plain PyTorch on every device.

K6 scans only the pairs that can change its answer: the rows up to a
padded suffix's first three (``three_nn_scan_rows``) and the sub-tiles of
32 rows whose lower bound (``three_nn_boxes``, ``three_nn_group_boxes``,
``three_nn_lower_bound``) does not exceed a warp's thresholds.
``three_nn_tiled_plain`` is that scan in plain PyTorch, for the tests: the
same answer as ``three_nn_plain`` and the same pairs as the kernel's
counter. No model path calls these.
"""
from __future__ import annotations

import math

import torch

from . import _build

# (B, chunk, M) fp32 distance blocks of at most 2**27 entries (512 MB):
# FP layer 0 of PointRCNN, (8, 16384, 4096), takes 4 blocks
_BLOCK_ENTRIES = 1 << 27


# known rows a sub-tile of K6, and queries a warp of its scan; queries a
# group of its warp-wide test; sub-tiles a chunk where it culls few
TILE, LANES, CHUNK = 32, 8, 4
# K6's cull bound: lb = A - (2^-20 * (|u|^2 + max|k|^2) + 2^-140), and no
# bound (-inf) where |u|^2 + max|k|^2 reaches 2^125 (csrc/three_nn.cu)
_MARGIN_REL, _MARGIN_ABS, _NO_BOUND = 2.0 ** -20, 2.0 ** -140, 2.0 ** 125


def _sq_norm(p):
    """(..., 3) -> (...): ``(x*x + y*y) + z*z``."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + \
        p[..., 2] * p[..., 2]


def _three_nn_block(unknown, known, known_sq):
    u = unknown
    cross = (u[..., 0:1] * known[:, None, :, 0]
             + u[..., 1:2] * known[:, None, :, 1]) \
        + u[..., 2:3] * known[:, None, :, 2]
    d2 = (_sq_norm(u)[..., None] + known_sq[:, None, :]) - 2.0 * cross
    dists, idx = [], []
    for k in range(3):
        i = d2.argmin(dim=-1, keepdim=True)  # first minimal index
        dists.append(d2.gather(-1, i))
        idx.append(i)
        if k < 2:
            d2.scatter_(-1, i, torch.inf)
    return torch.cat(dists, dim=-1), torch.cat(idx, dim=-1)


def _check(unknown, known):
    if unknown.dim() != 3 or known.dim() != 3 or unknown.shape[-1] != 3 or \
            known.shape[-1] != 3 or unknown.shape[0] != known.shape[0] or \
            unknown.dtype != torch.float32 or known.dtype != torch.float32 \
            or unknown.device != known.device:
        raise ValueError(f'three_nn takes (B, N, 3) and (B, M, 3) float32 on '
                         f'one device, got {tuple(unknown.shape)} '
                         f'{unknown.dtype} {unknown.device} and '
                         f'{tuple(known.shape)} {known.dtype} {known.device}')
    if known.shape[1] < 3:
        raise ValueError(f'three_nn needs at least 3 known points, got '
                         f'{known.shape[1]}')


def three_nn_plain(unknown, known):
    """Plain PyTorch ``three_nn``, in blocks of unknown points."""
    _check(unknown, known)
    B, N, _ = unknown.shape
    M = known.shape[1]
    known_sq = _sq_norm(known)
    chunk = max(1, _BLOCK_ENTRIES // max(1, B * M))
    parts = [_three_nn_block(unknown[:, n0:n0 + chunk], known, known_sq)
             for n0 in range(0, N, chunk)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


def three_nn_kernel(unknown, known, pairs=None):
    """``three_nn`` through the CUDA kernel ``csrc/three_nn.cu``: a
    pre-pass over the known rows (packed rows, sub-tile boxes, the padded
    suffix), then the scan, warps of 32 queries over the sub-tiles that
    may change their answer. ``pairs``: None, or a (B,) int64 CUDA tensor
    to which the scan adds the pairs it evaluated."""
    _check(unknown, known)
    for t in (unknown, known):
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError('the three_nn kernel needs contiguous CUDA '
                             f'tensors, got {t.device}')
    B, N, _ = unknown.shape
    M = known.shape[1]
    if pairs is not None and (
            pairs.shape != (B,) or pairs.dtype != torch.int64 or
            pairs.device != unknown.device or not pairs.is_contiguous()):
        raise ValueError(f'three_nn pairs: a contiguous ({B},) int64 tensor '
                         f'on {unknown.device}, got {tuple(pairs.shape)} '
                         f'{pairs.dtype} {pairs.device}')
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((B, N, 3), dtype=torch.int64, device=unknown.device)
    lib = _build.library('three_nn')
    work = torch.empty(lib.spsnet_three_nn_workspace(B, M) * 16,
                       dtype=torch.uint8, device=unknown.device)
    with torch.cuda.device(unknown.device):
        err = lib.spsnet_three_nn(
            unknown.data_ptr(), known.data_ptr(), dist.data_ptr(),
            idx.data_ptr(), work.data_ptr(),
            None if pairs is None else pairs.data_ptr(), B, N, M,
            _build.stream_ptr(unknown.device))
    _build.check(err, 'three_nn')
    _build.LAUNCHES['three_nn'] += 2  # the pre-pass and the scan
    return dist, idx


def three_nn(unknown, known):
    """The 3 nearest ``known`` points of each ``unknown`` point: the plain
    version for a CPU tensor, the kernel for a CUDA tensor.

    Args:
        unknown: (B, N, 3); known: (B, M, 3) with M >= 3, float32.
    Returns:
        dist2: (B, N, 3) squared distances, ascending;
        idx: (B, N, 3) int64 indices into M, the lowest first among equal
        distances.
    """
    if unknown.device.type == 'cpu':
        return three_nn_plain(unknown, known)
    return three_nn_kernel(unknown.contiguous(), known.contiguous())


def three_interpolate(features, idx, weight):
    """(B, M, C) features, (B, N, 3) indices and weights -> (B, N, C):
    ``(f0*w0 + f1*w1) + f2*w2`` of the three neighbours."""
    B, N, _ = idx.shape
    C = features.shape[-1]
    g = features.gather(1, idx.reshape(B, N * 3, 1).expand(-1, -1, C))
    g = g.reshape(B, N, 3, C)
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) + \
        g[:, :, 2] * w[:, :, 2]


def three_interpolate_weights(dist2, eps: float = 1e-8):
    """Normalised inverse-distance weights (``pointnet2_modules.py:
    561-565``): ``r / (r0 + r1 + r2)`` with ``r = 1 / (d2 + eps)``."""
    recip = 1.0 / (dist2 + eps)
    norm = (recip[..., 0] + recip[..., 1]) + recip[..., 2]
    return recip / norm[..., None]


# ------------------------------------------- K6's scan rules, for the tests


def _step(x, toward):
    return torch.nextafter(x, torch.full_like(x, toward))


def _mul_rd(a, b):
    """a * b rounded toward -inf (``__fmul_rd``): the fp32 product, one
    step down where it lies above the exact (float64) product."""
    r = a * b
    return torch.where(r.double() > a.double() * b.double(),
                       _step(r, -math.inf), r)


def _add_rd(a, b):
    """a + b rounded toward -inf (``__fadd_rd``): the fp32 sum, one step
    down where its exact error (TwoSum) is negative or it overflowed to
    +inf from finite terms."""
    r = a + b
    bv = r - a
    e = (a - (r - bv)) + (b - bv)
    over = torch.isfinite(a) & torch.isfinite(b) & (r == math.inf)
    return torch.where((e < 0) | over, _step(r, -math.inf), r)


def _sub_rd(a, b):
    return _add_rd(a, -b)


def _add_ru(a, b):
    return -_add_rd(-a, -b)


def _mul_ru(a, b):
    return -_mul_rd(-a, b)


def _before(d, t):
    """The plain version's argmin order: NaN first, then by value."""
    return (d < t) | (torch.isnan(d) & ~torch.isnan(t))


def three_nn_run_start(known):
    """(B,) int64: where the trailing run of rows bitwise equal to row M-1
    starts (K6's pre-pass: the largest i + 1 over the rows that differ)."""
    bits = known.contiguous().view(torch.int32)
    differs = (bits != bits[:, -1:]).any(-1)
    rank = torch.arange(1, known.shape[1] + 1, device=known.device)
    return torch.where(differs, rank, 0).amax(1)


def three_nn_scan_rows(known):
    """(B,) int64: the rows K6 scans, min(M, run start + 3). Of a run of
    bitwise equal rows only the first three can enter the best three."""
    return (three_nn_run_start(known) + 3).clamp(max=known.shape[1])


def three_nn_boxes(known):
    """K6's sub-tiles of TILE consecutive rows: lo (B, T, 4), the box's
    lower corner with the largest |k|^2 as its last entry (+inf where a
    row's norm is not finite), and hi (B, T, 3), its upper corner. NaN
    coordinates are left out of the box, as ``fminf`` / ``fmaxf`` do."""
    B, M, _ = known.shape
    pad = -M % TILE
    w = _sq_norm(known)
    mk = torch.where(torch.isfinite(w), w, math.inf)
    nan = torch.isnan(known)

    def tiles(x, fill):
        return torch.nn.functional.pad(x, (0, 0, 0, pad), value=fill).view(
            B, -1, TILE, x.shape[-1])
    lo = tiles(torch.where(nan, math.inf, known), math.inf).amin(2)
    hi = tiles(torch.where(nan, -math.inf, known), -math.inf).amax(2)
    mk = tiles(mk[..., None], 0.0).amax(2)
    return torch.cat([lo, mk], -1), hi


def three_nn_lower_bound(qlo, qhi, qsq, lo, hi):
    """(B, Q, T): K6's lower bound on the rounded d2 of any query in the box
    (qlo, qhi) (B, Q, 3) with |u|^2 at most qsq (B, Q) and any point of each
    sub-tile (``three_nn_boxes``), with the kernel's directed roundings
    (the derivation is in ``csrc/three_nn.cu``); -inf where it makes none.
    For one query, qlo = qhi = u and qsq = |u|^2."""
    s = _add_ru(qsq[:, :, None], lo[:, None, :, 3])
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    gap = torch.fmax(torch.fmax(_sub_rd(lo[:, None, :, :3], qhi[:, :, None]),
                                _sub_rd(qlo[:, :, None], hi[:, None])), zero)
    sq = _mul_rd(gap, gap)
    a = _add_rd(_add_rd(sq[..., 0], sq[..., 1]), sq[..., 2])
    margin = _add_ru(_mul_ru(s, torch.tensor(_MARGIN_REL, dtype=s.dtype)),
                     torch.tensor(_MARGIN_ABS, dtype=s.dtype))
    return torch.where(s < _NO_BOUND, _sub_rd(a, margin), -math.inf)


def three_nn_group_boxes(unknown):
    """K6's query groups, LANES consecutive queries of a warp of TILE
    (the last warp padded with absent queries): their boxes qlo, qhi (B,
    G, 3) and largest |u|^2 (B, G), +inf where a query's is not finite.
    NaN coordinates are left out, absent queries too (an empty group's box
    is empty)."""
    B, N, _ = unknown.shape
    W = -(-N // TILE)
    u = torch.nn.functional.pad(unknown, (0, 0, 0, W * TILE - N))
    active = (torch.arange(W * TILE, device=u.device) < N)[None, :, None]
    usq = _sq_norm(u)[..., None]
    nan = torch.isnan(u)
    qlo = torch.where(active & ~nan, u, math.inf)
    qhi = torch.where(active & ~nan, u, -math.inf)
    qsq = torch.where(active, torch.where(torch.isfinite(usq), usq,
                                          math.inf), 0.0)
    return (qlo.view(B, -1, LANES, 3).amin(2),
            qhi.view(B, -1, LANES, 3).amax(2),
            qsq.view(B, -1, LANES).amax(2))


def three_nn_tiled_plain(unknown, known):
    """K6's scan in plain PyTorch: warps of TILE queries (in order, the
    last one ragged), rows up to ``three_nn_scan_rows``, the sub-tiles in
    index order, TILE at a time. Each batch is first tested against each
    group of LANES queries with the group's largest third best; where that
    culls half the batch or less the warp scans each chunk of CHUNK
    sub-tiles that holds a marked one, else only the marked sub-tiles,
    each checked again lane by lane with the thresholds then. A point
    enters by the strict argmin order. Returns (dist2, idx) as
    ``three_nn`` and pairs (B,) int64, the pairs the kernel's counter
    reads."""
    _check(unknown, known)
    B, N, _ = unknown.shape
    W = -(-N // TILE)
    u = torch.nn.functional.pad(unknown, (0, 0, 0, W * TILE - N))
    active = torch.arange(W * TILE, device=u.device) < N
    lanes = active.view(W, TILE).sum(1)
    usq = _sq_norm(u)
    ksq = _sq_norm(known)
    lo, hi = three_nn_boxes(known)
    glo, ghi, gsq = three_nn_group_boxes(unknown)
    rows = three_nn_scan_rows(known).tolist()
    inf = torch.full((B, W * TILE), math.inf, device=u.device)
    d = [inf.clone(), inf.clone(), inf.clone()]
    i = [torch.zeros((B, W * TILE), dtype=torch.int64, device=u.device)
         for _ in range(3)]
    pairs = torch.zeros(B, dtype=torch.int64)
    for b in range(B):
        tiles = -(-rows[b] // TILE)
        for t0 in range(0, tiles, TILE):
            t1 = min(t0 + TILE, tiles)
            thr = torch.where(active, torch.where(torch.isnan(d[2][b]),
                                                  math.inf, d[2][b]),
                              -math.inf).view(-1, LANES).amax(1)
            group = three_nn_lower_bound(glo[b:b + 1], ghi[b:b + 1],
                                         gsq[b:b + 1], lo[b:b + 1, t0:t1],
                                         hi[b:b + 1, t0:t1])[0]
            marked = (~(group > thr[:, None])).view(W, -1, t1 - t0).any(1)
            bulk = 2 * marked.sum(1) > t1 - t0
            in_chunk = torch.nn.functional.pad(
                marked.int(), (0, -(t1 - t0) % CHUNK)).view(W, -1, CHUNK).any(
                    -1).repeat_interleave(CHUNK, 1)[:, :t1 - t0]
            lb = three_nn_lower_bound(u[b:b + 1], u[b:b + 1], usq[b:b + 1],
                                      lo[b:b + 1, t0:t1],
                                      hi[b:b + 1, t0:t1])[0]
            for j in range(t1 - t0):
                keep = ~(lb[:, j] > d[2][b]) & active
                warps = torch.where(bulk, in_chunk[:, j], marked[:, j] &
                                    keep.view(W, TILE).any(1))
                if not bool(warps.any()):
                    continue
                base = (t0 + j) * TILE
                count = min(TILE, rows[b] - base)
                pairs[b] += int((lanes * warps).sum()) * count
                scan = warps.repeat_interleave(TILE)
                for r in range(base, base + count):
                    k = known[b, r]
                    cross = (u[b, :, 0] * k[0] + u[b, :, 1] * k[1]) + \
                        u[b, :, 2] * k[2]
                    dr = (usq[b] + ksq[b, r]) - 2.0 * cross
                    enter = scan & _before(dr, d[2][b])
                    c1 = enter & _before(dr, d[1][b])
                    c0 = c1 & _before(dr, d[0][b])
                    for v, new in ((d, dr), (i, torch.full_like(i[0][b], r))):
                        v[2][b] = torch.where(c1, v[1][b], torch.where(
                            enter, new, v[2][b]))
                        v[1][b] = torch.where(c0, v[0][b], torch.where(
                            c1, new, v[1][b]))
                        v[0][b] = torch.where(c0, new, v[0][b])
    return (torch.stack(d, -1)[:, :N].contiguous(),
            torch.stack(i, -1)[:, :N].contiguous(), pairs)
