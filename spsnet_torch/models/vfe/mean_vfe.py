"""MeanVFE (``mean_vfe.py``, as ``spsnet_tpu/models/vfe/vfe_modules.py:
16-28``): the mean of each voxel's points over the host's zero-padded
(B, V, P, C) layout."""
from __future__ import annotations

from torch import nn


class MeanVFE(nn.Module):

    def forward(self, batch):
        """'voxels' (B, V, P, C), 'voxel_num_points' (B, V) -> adds
        'voxel_features' (B, V, C): the sum over the P slots (padding is
        zero) over the count, at least 1."""
        counts = batch['voxel_num_points'][..., None].to(
            batch['voxels'].dtype).clamp(min=1.0)
        return dict(batch, voxel_features=batch['voxels'].sum(dim=2) / counts)
