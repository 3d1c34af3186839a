"""Point downsampling strategies of the IA-SSD and SPSNet paths.

One function per ``SAMPLE_METHOD_LIST`` entry ported so far
(``pointnet2_modules.py:267-419``, as in ``spsnet_tpu/models/samplers.py``):

- ``D-FPS``     — euclidean farthest point sampling, exact or seeded;
- ``ctr``/``cls`` — top-k of sigmoid(max class logit) (IA-SSD ctr_aware);
- ``sss``       — top-k of the class score times the stability score
                   ``1 - sigmoid(stds / 8 - 3)`` (SPSNet's sss_aware);
- ``S-FPS``     — exact D-FPS, then each pick swapped for the neighbour of
                   lowest stds in its ball (SPSNet's stability FPS).

Samplers that take the per-point stability ``stds`` return it gathered
along their picks (None when there is none).
"""
from __future__ import annotations

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
