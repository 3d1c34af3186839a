"""Scatter the pillar features onto the dense BEV grid
(``pointpillar_scatter.py``, as ``spsnet_tpu/models/map_to_bev/
pointpillar_scatter.py:15-41``), NCHW.

One batched scatter: pillar v of frame b lands at ``y * nx + x`` of the
(B, C, ny * nx) canvas; invalid pillars ('voxel_valid' False) land in one
extra slot, which is dropped. Valid pillars' coordinates are unique, so
each cell is written at most once and the canvas is exact. A batch that
already holds 'spatial_features' (the dynamic pillar VFE's canvas) passes
through.
"""
from __future__ import annotations

from torch import nn


class PointPillarScatter(nn.Module):

    def __init__(self, grid_size):
        super().__init__()
        self.nx, self.ny = int(grid_size[0]), int(grid_size[1])

    def forward(self, batch):
        """'pillar_features' (B, V, C), 'voxel_coords' (B, V, 3) zyx and
        'voxel_valid' (B, V), if any -> adds 'spatial_features' (B, C, ny,
        nx), zero where no pillar."""
        if 'spatial_features' in batch:
            return batch
        feats = batch['pillar_features']
        coords = batch['voxel_coords'].long()
        B, V, C = feats.shape
        cells = self.ny * self.nx
        flat = coords[..., 1] * self.nx + coords[..., 2]
        if 'voxel_valid' in batch:
            flat = flat.where(batch['voxel_valid'], cells)
        canvas = feats.new_zeros(B, C, cells + 1).scatter(
            2, flat[:, None, :].expand(B, C, V), feats.transpose(1, 2))
        return dict(batch, spatial_features=canvas[..., :cells].reshape(
            B, C, self.ny, self.nx))
