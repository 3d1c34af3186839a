"""Ball query and grouping, channel-last.

Ball-query semantics (``ball_query_gpu.cu:29-44``, as in
``spsnet_tpu/ops/grouping.py``): for each center, the first ``nsample``
points in index order with ``d2 < r^2`` (strict); slots past the last hit
repeat the first hit; a ball with no hit is all index 0.

``ball_query`` and ``ball_query_multi`` run the plain version for a CPU
tensor and the fused kernel (``csrc/ball_query.cu``) for a CUDA tensor. The
plain version computes the (B, chunk, N) distances in the kernel's rounding
order, ranks the hits with a cumulative sum and finds the first ``nsample``
by binary search, so it needs no sort.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

# centers per distance block of the plain version: (B, 1024, N) fp32 is
# 0.5 GB at B=8, N=16384
_CHUNK = 1024


def squared_radius(radius: float) -> float:
    """``r * r`` rounded as fp32 arithmetic rounds it (fp32(r) * fp32(r)),
    the threshold the JAX package and the kernel compare against."""
    r = np.float32(radius)
    return float(r * r)


def pairwise_d2(ctr, xyz):
    """(B, M, 3) x (B, N, 3) -> (B, M, N) squared distances
    ``(dx*dx + dy*dy) + dz*dz`` with d = center - point (the diff form of
    ``spsnet_tpu/ops/grouping.py:74-76``)."""
    dx = ctr[..., 0:1] - xyz[..., 0][:, None, :]
    dy = ctr[..., 1:2] - xyz[..., 1][:, None, :]
    dz = ctr[..., 2:3] - xyz[..., 2][:, None, :]
    return dx * dx + dy * dy + dz * dz


def first_k_hits(hit, nsample: int):
    """(..., N) bool -> (..., nsample) int64: the first ``nsample`` hit
    indices in index order, padded with the first hit (0 for no hit)."""
    n = hit.shape[-1]
    rank = torch.cumsum(hit, dim=-1, dtype=torch.int32)  # 1-based hit rank
    want = torch.arange(1, nsample + 1, dtype=torch.int32, device=hit.device)
    want = want.expand(*hit.shape[:-1], nsample).contiguous()
    pos = torch.searchsorted(rank, want)  # first index whose rank >= s
    found = pos < n
    first = torch.where(found[..., :1], pos[..., :1], 0)
    return torch.where(found, pos, first)


def _check(xyz, new_xyz, radii, nsamples):
    for name, t in (('xyz', xyz), ('new_xyz', new_xyz)):
        if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f'{name} must be (B, *, 3) float32, got '
                             f'{tuple(t.shape)} {t.dtype}')
    if xyz.shape[0] != new_xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError('xyz and new_xyz need the same batch and device')
    if len(radii) != len(nsamples) or not radii:
        raise ValueError('one nsample per radius, at least one radius')
    if min(nsamples) < 1 or xyz.shape[1] < 1:
        raise ValueError('nsample and N must be >= 1')


def ball_query_multi_plain(radii, nsamples, xyz, new_xyz):
    """Plain multi-radius ball query sharing one distance computation per
    chunk of centers. Returns a tuple of (B, M, nsamples[i]) int64."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    _check(xyz, new_xyz, radii, nsamples)
    outs = [[] for _ in radii]
    for c0 in range(0, new_xyz.shape[1], _CHUNK):
        d2 = pairwise_d2(new_xyz[:, c0:c0 + _CHUNK], xyz)
        for i, (r, s) in enumerate(zip(radii, nsamples)):
            outs[i].append(first_k_hits(d2 < squared_radius(r), s))
    return tuple(torch.cat(o, dim=1) for o in outs)


def ball_query_multi_kernel(radii, nsamples, xyz, new_xyz):
    """Multi-radius ball query through ``csrc/ball_query.cu``: one launch
    (one pass over the points) per pair of radii."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    _check(xyz, new_xyz, radii, nsamples)
    if xyz.device.type != 'cuda':
        raise ValueError(f'the ball-query kernel needs CUDA tensors, got '
                         f'{xyz.device}')
    if not (xyz.is_contiguous() and new_xyz.is_contiguous()):
        raise ValueError('the ball-query kernel needs contiguous inputs')
    lib = _build.library('ball_query')
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    outs = [torch.empty((B, M, s), dtype=torch.int64, device=xyz.device)
            for s in nsamples]
    with torch.cuda.device(xyz.device):
        stream = _build.stream_ptr(xyz.device)
        for i in range(0, len(radii), 2):
            pair = i + 1 < len(radii)
            err = lib.spsnet_ball_query(
                xyz.data_ptr(), new_xyz.data_ptr(), outs[i].data_ptr(),
                outs[i + 1].data_ptr() if pair else None, B, N, M,
                squared_radius(radii[i]), nsamples[i],
                squared_radius(radii[i + 1]) if pair else 0.0,
                nsamples[i + 1] if pair else 0, stream)
            _build.check(err, 'ball_query')
            _build.LAUNCHES['ball_query'] += 1
    return tuple(outs)


def ball_query_multi(radii, nsamples, xyz, new_xyz):
    """Multi-scale ball query: a tuple of (B, M, nsamples[i]) int64 index
    tensors, one per radius. Plain version on the CPU, kernel on CUDA."""
    if xyz.device.type == 'cpu':
        return ball_query_multi_plain(radii, nsamples, xyz, new_xyz)
    return ball_query_multi_kernel(radii, nsamples, xyz, new_xyz)


def ball_query(radius: float, nsample: int, xyz, new_xyz):
    """(B, N, 3) points, (B, M, 3) centers -> (B, M, nsample) int64."""
    return ball_query_multi((radius,), (nsample,), xyz, new_xyz)[0]


def gather_points(points, idx):
    """(B, N, C) gathered by (B, M) -> (B, M, C)."""
    return points.gather(1, idx[..., None].expand(-1, -1, points.shape[-1]))


def group_points(points, idx):
    """(B, N, C) grouped by (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_points(points, idx.reshape(B, M * S)).reshape(
        B, M, S, points.shape[-1])


def query_and_group(radius, nsample, xyz, new_xyz, features=None,
                    use_xyz=True, idx=None):
    """Ball query + grouping with center-relative coords
    (``QueryAndGroup.forward``, ``pointnet2_utils.py:289-322``).

    Returns ((B, M, S, 3 + C) or (B, M, S, 3) or (B, M, S, C), idx); ``idx``
    skips the query (e.g. precomputed by ``ball_query_multi``).
    """
    if idx is None:
        idx = ball_query(radius, nsample, xyz, new_xyz)
    if features is None:
        if not use_xyz:
            raise ValueError('cannot have no features and not use xyz')
        return group_points(xyz, idx) - new_xyz[:, :, None, :], idx
    grouped = group_points(torch.cat([xyz, features], dim=-1), idx)
    grouped_xyz = grouped[..., :3] - new_xyz[:, :, None, :]
    if use_xyz:
        return torch.cat([grouped_xyz, grouped[..., 3:]], dim=-1), idx
    return grouped[..., 3:], idx


def zero_empty_balls(grouped, radius: float):
    """Zero the grouped rows of each ball with no point in radius, before
    the MLP, as the reference's stack ``QueryAndGroup`` does
    (``pointnet2_stack/pointnet2_utils.py:139-143``; ``spsnet_tpu/ops/
    grouping.py:309-327``): the VSA and the RoI-grid pool. ``grouped``
    (B, M, S, 3 + C) from ``query_and_group(use_xyz=True)``: slot 0 holds
    the first hit when there is one, so a ball is empty iff slot 0's
    center-relative squared distance, summed in the ball query's order,
    is not below r^2."""
    x, y, z = grouped[..., 0, 0], grouped[..., 0, 1], grouped[..., 0, 2]
    empty = x * x + y * y + z * z >= squared_radius(radius)
    return torch.where(empty[..., None, None], 0.0, grouped)


def masked_pool(h, valid=None, method='max_pool'):
    """Pool (B, M, S, C) over S with an optional (B, M, S) validity mask."""
    if valid is None:
        return h.amax(dim=2) if method == 'max_pool' else h.mean(dim=2)
    v = valid[..., None]
    if method == 'max_pool':
        return torch.where(v, h, -torch.inf).amax(dim=2)
    cnt = v.sum(dim=2).clamp(min=1)
    return torch.where(v, h, 0.0).sum(dim=2) / cnt


def group_all(xyz, features=None, use_xyz=True):
    """``GroupAll``: one group holding every point, (B, 1, N, C')."""
    grouped_xyz = xyz[:, None]
    if features is None:
        return grouped_xyz
    if use_xyz:
        return torch.cat([grouped_xyz, features[:, None]], dim=-1)
    return features[:, None]
