"""Collapse CaDDN's voxel volume to the BEV map (``map_to_bev/
conv2d_collapse.py``, as ``spsnet_tpu/models/map_to_bev/
conv2d_collapse.py:12-31``), NCHW.

The (B, C, X, Y, Z) voxels stack their Z slices into channels z-major, as
the JAX package lays them out (channel z * C + c; the reference's are
c-major, ROADMAP Queue 3), onto the (Y, X) map; then a bias-free k x k
convolution, BatchNorm at flax's momentum 0.99 and eps 1e-3, ReLU.
Submodules carry the flax names ``collapse`` and ``collapse_bn``.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNormNCHW


def stack_z(voxels):
    """(B, C, X, Y, Z) -> (B, Z * C, Y, X), channel z * C + c."""
    B, C, X, Y, Z = voxels.shape
    return voxels.permute(0, 4, 1, 3, 2).reshape(B, Z * C, Y, X)


class Conv2DCollapse(nn.Module):

    def __init__(self, model_cfg, grid_size, in_channels: int):
        super().__init__()
        args = model_cfg.get('ARGS', {}) or {}
        k = int(args.get('kernel_size', 1))
        out = int(model_cfg.NUM_BEV_FEATURES)
        self.collapse = nn.Conv2d(int(grid_size[2]) * in_channels, out, k,
                                  padding=k // 2,
                                  bias=bool(args.get('bias', False)))
        self.collapse_bn = BatchNormNCHW(out, eps=1e-3, momentum=0.01)

    def forward(self, batch):
        """'voxel_features_3d' (B, C, X, Y, Z) -> adds 'spatial_features'
        (B, NUM_BEV_FEATURES, Y, X)."""
        bev = stack_z(batch['voxel_features_3d'])
        return dict(batch, spatial_features=F.relu(
            self.collapse_bn(self.collapse(bev))))
