"""Point downsampling strategies of the IA-SSD and SPSNet paths.

One function per ``SAMPLE_METHOD_LIST`` entry
(``pointnet2_modules.py:267-419``, as in ``spsnet_tpu/models/samplers.py``):

- ``D-FPS``     — euclidean farthest point sampling, exact or seeded;
- ``F-FPS``     — FPS over the squared distances of xyz and features;
- ``FS``        — F-FPS and exact D-FPS concatenated (2 npoint picks);
- ``Rand``      — one random subset shared across the batch;
- ``ds-FPS``/``ry-FPS`` — exact FPS in four partitions of the points
                   sorted by radius or by azimuth;
- ``ctr``/``cls`` — top-k of sigmoid(max class logit) (IA-SSD ctr_aware);
- ``sss``       — top-k of the class score times the stability score
                   ``1 - sigmoid(stds / 8 - 3)`` (SPSNet's sss_aware);
- ``S-FPS``     — exact D-FPS, then each pick swapped for the neighbour of
                   lowest stds in its ball (SPSNet's stability FPS).

Samplers that take the per-point stability ``stds`` return it gathered
along their picks (None when there is none).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..ops.boxes import topk_desc


def _gather_stds(stds, idx):
    return None if stds is None else stds.gather(1, idx)


def stability_score(stds):
    """SPSNet's stability mapping ``1 - sigmoid(stds / 8 - 3)``
    (``pointnet2_modules.py:301``): high stds (unstable) -> low score."""
    return 1.0 - torch.sigmoid(stds / 8.0 - 3.0)


def sample_ctr_aware(cls_features, npoint: int):
    """(B, N, num_class) logits -> (B, npoint) int64 indices of the highest
    sigmoid(max logit) scores, the lowest index first among ties (sigmoid
    saturates to exactly 1.0 in fp32 for logits above ~17)."""
    scores = torch.sigmoid(cls_features.amax(dim=-1))
    return topk_desc(scores, npoint)[1]


def sss_aware_scores(cls_features, stds):
    """(B, N) scores that ``sample_sss_aware`` ranks."""
    return torch.sigmoid(cls_features.amax(dim=-1)) * stability_score(stds)


def sample_sss_aware(cls_features, stds, npoint: int):
    """(B, N, num_class) logits and (B, N) stds -> ((B, npoint) int64
    indices of the highest ``sss_aware_scores``, lowest index first among
    ties; the stds gathered along them)."""
    idx = topk_desc(sss_aware_scores(cls_features, stds), npoint)[1]
    return idx, _gather_stds(stds, idx)


def sample_dfps(xyz, npoint: int, stds=None, valid_mask=None, seeding=None):
    """D-FPS, (B, N, 3) -> ((B, npoint) int64, stds gathered along it or
    None): the SA-module call site, the one that opts into ``seeding`` (an
    ``ops.FpsSeeding`` or None for exact FPS)."""
    idx = ops.farthest_point_sample(xyz.contiguous(), npoint,
                                    valid_mask=valid_mask, seeding=seeding)
    return idx, _gather_stds(stds, idx)


def sample_sfps(xyz, stds, npoint: int, ss_radius: float, ss_nsample: int,
                min_unique: int = 3500):
    """S-FPS (``pointnet2_modules.py:314-355``, as
    ``spsnet_tpu/models/samplers.py:86-104``): exact D-FPS, then one ball
    query of ``ss_nsample`` at ``ss_radius`` around the picks, and each pick
    becomes the neighbour of lowest stds in its ball (the first among
    ties). When batch row 0 then holds fewer than ``min_unique`` distinct
    picks (the reference's fixed degeneracy guard), the whole batch keeps
    the D-FPS picks. The count and the choice stay on the device.

    Returns ((B, npoint) int64 indices, the stds gathered along them)."""
    xyz = xyz.contiguous()
    base = ops.farthest_point_sample(xyz, npoint)
    nbr = ops.ball_query(ss_radius, ss_nsample, xyz,
                         ops.gather_points(xyz, base).contiguous())
    nbr_stds = ops.group_points(stds[..., None], nbr)[..., 0]
    swapped = nbr.gather(-1, nbr_stds.argmin(dim=-1, keepdim=True))[..., 0]
    row0 = torch.sort(swapped[0]).values
    n_unique = 1 + (row0[1:] != row0[:-1]).sum()
    idx = torch.where(n_unique < min_unique, base, swapped)
    return idx, _gather_stds(stds, idx)


def sample_ffps(xyz, features, npoint: int):
    """F-FPS (``spsnet_tpu/models/samplers.py:66-69``): FPS over the
    (B, N, N) squared distances of ``[xyz, features]``, without gradient.
    (B, N, 3), (B, N, C) -> (B, npoint) int64."""
    with torch.no_grad():
        feat = torch.cat([xyz, features], dim=-1).contiguous()
        return ops.farthest_point_sample_with_dist(
            ops.calc_square_dist(feat, feat), npoint)


def sample_fs(xyz, features, npoint: int):
    """3DSSD's fusion sampling: [F-FPS picks, exact D-FPS picks] ->
    (B, 2 npoint) int64. The D-FPS half is never seeded."""
    idx1 = sample_ffps(xyz, features, npoint)
    idx2 = ops.farthest_point_sample(xyz.contiguous(), npoint)
    return torch.cat([idx1, idx2], dim=-1)


def draw_permutation(generator: torch.Generator, n: int):
    """A permutation of ``n`` drawn on the host from a CPU generator."""
    return torch.randperm(n, generator=generator)


def sample_rand(generator, batch_size: int, n: int, npoint: int, device):
    """Random subset: the first ``npoint`` of one permutation of ``n``
    (``draw_permutation`` from the CPU ``generator``; a test feeds another
    package's permutation through it), shared across the batch
    (``pointnet2_modules.py:370-371``) -> (batch_size, npoint) int64 on
    ``device``."""
    idx = draw_permutation(generator, n)[:npoint]
    return idx.to(device, non_blocking=True)[None].expand(batch_size, npoint)


def partition_order(keys):
    """(B, N) keys -> the stable ascending order of each row, int64."""
    return torch.argsort(keys, dim=-1, stable=True)


def _partitioned_fps(xyz, keys, npoint: int, part_num: int = 4):
    """ds-FPS / ry-FPS (``pointnet2_modules.py:372-419``): the points
    sorted by ``keys`` (``partition_order``), split into ``part_num``
    contiguous partitions of N / part_num, exact FPS of npoint / part_num
    picks in each (one launch over the (B part_num, N / part_num) rows),
    mapped back to the input's indices. -> (B, npoint) int64."""
    B, N, _ = xyz.shape
    if N % part_num or npoint % part_num:
        raise ValueError(f'partitioned FPS needs N={N} and npoint={npoint} '
                         f'to be multiples of part_num={part_num}')
    order = partition_order(keys)
    per = N // part_num
    xyz_div = xyz.gather(1, order[..., None].expand(-1, -1, 3)).reshape(
        B * part_num, per, 3).contiguous()
    sub = ops.farthest_point_sample(xyz_div, npoint // part_num)
    offs = torch.arange(part_num, device=xyz.device)[None, :, None] * per
    flat = (sub.reshape(B, part_num, -1) + offs).reshape(B, npoint)
    return order.gather(1, flat)


def _fma32(a, b, c):
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add rounds it:
    the product is exact in float64, the sum rounded there and then to
    fp32 (the two roundings part from one only where the float64 sum lands
    exactly between two fp32 values)."""
    return (a.double() * b.double() + c.double()).float()


def ds_fps_keys(xyz):
    """ds-FPS's keys ``||xyz|| - 5`` as XLA:CPU computes JAX's
    ``jnp.linalg.norm``: the squares summed as the fused chain
    ``fma(z, z, fma(y, y, x * x))``, the root taken in float64 and rounded
    once (the correctly rounded fp32 root; torch's fp32 CPU ``sqrt`` is an
    ulp off at times), so that the card and the CPU sort alike."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    s = _fma32(z, z, _fma32(y, y, x * x))
    return torch.sqrt(s.double()).float() - 5.0


def ry_fps_keys(xyz):
    """ry-FPS's keys ``arctan(x / (y + 1e-12))`` in fp32."""
    return torch.atan(xyz[..., 0] / (xyz[..., 1] + np.float32(1e-12)))


def sample_ds_fps(xyz, npoint: int, part_num: int = 4):
    """ds-FPS: partitioned FPS over the points sorted by radius."""
    return _partitioned_fps(xyz, ds_fps_keys(xyz), npoint, part_num)


def sample_ry_fps(xyz, npoint: int, part_num: int = 4):
    """ry-FPS: partitioned FPS over the points sorted by azimuth."""
    return _partitioned_fps(xyz, ry_fps_keys(xyz), npoint, part_num)
