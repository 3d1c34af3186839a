"""Point downsampling strategies of the IA-SSD main path.

One function per ``SAMPLE_METHOD_LIST`` entry ported so far
(``pointnet2_modules.py:267-419``, as in ``spsnet_tpu/models/samplers.py``):

- ``D-FPS``     — euclidean farthest point sampling, exact or seeded;
- ``ctr``/``cls`` — top-k of sigmoid(max class logit) (IA-SSD ctr_aware).
"""
from __future__ import annotations

import torch

from .. import ops
from ..ops.boxes import topk_desc


def sample_ctr_aware(cls_features, npoint: int):
    """(B, N, num_class) logits -> (B, npoint) int64 indices of the highest
    sigmoid(max logit) scores, the lowest index first among ties (sigmoid
    saturates to exactly 1.0 in fp32 for logits above ~17)."""
    scores = torch.sigmoid(cls_features.amax(dim=-1))
    return topk_desc(scores, npoint)[1]


def sample_dfps(xyz, npoint: int, valid_mask=None, seeding=None):
    """D-FPS, (B, N, 3) -> (B, npoint) int64: the SA-module call site,
    the one that opts into ``seeding`` (an ``ops.FpsSeeding`` or None for
    exact FPS)."""
    return ops.farthest_point_sample(xyz.contiguous(), npoint,
                                     valid_mask=valid_mask, seeding=seeding)
