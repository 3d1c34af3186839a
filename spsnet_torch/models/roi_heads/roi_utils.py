"""RoI point pooling.

Port of ``roipoint_pool3d`` (``spsnet_tpu/models/roi_heads/roi_utils.py:
170-198``; reference ``roipoint_pool3d_kernel.cu:38-103``): the first
``num_sampled_points`` points inside each (enlarged) RoI, in index order,
with their features. Plain PyTorch on every device, as the JAX package
computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ...ops.grouping import first_k_hits
from ...utils import box_utils


def roipoint_pool3d(points, point_features, rois, num_sampled_points=512,
                    pool_extra_width=(0.0, 0.0, 0.0)):
    """Pool a fixed number of in-box points per RoI.

    Args:
        points: (B, N, 3); point_features: (B, N, C); rois: (B, R, 7).
    Returns:
        pooled: (B, R, S, 3 + C), raw xyz and features of the first S hits,
            slots past the last hit holding the first hit;
        empty: (B, R) bool, RoIs with no point inside (their slots hold
            point 0; the caller zeroes them). A RoI of zero length never
            holds a point.
    """
    ext = box_utils.enlarge_box3d(rois, pool_extra_width)
    local = box_utils.points_to_box_local(points, ext)        # (B, N, R, 3)
    inside = box_utils.in_canonical_box(local, ext[..., None, :, 3:6])
    inside = (inside & (ext[..., None, :, 3] > 0)).transpose(1, 2)
    idx = first_k_hits(inside, num_sampled_points)           # (B, R, S)
    empty = ~inside.any(dim=-1)
    full = torch.cat([points, point_features], dim=-1)
    B, R, S = idx.shape
    pooled = full.gather(1, idx.reshape(B, R * S, 1).expand(
        -1, -1, full.shape[-1]))
    return pooled.reshape(B, R, S, full.shape[-1]), empty
