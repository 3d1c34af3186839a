"""VoxelBackBone8x as host-planned sparse convolution, and the BEV scatter.

Port of ``spsnet_tpu/models/backbones_3d/spconv_backbone.py`` (:23-99,
:144-166; reference ``spconv_backbone.py:69-180`` and
``map_to_bev/height_compression.py``). The host supplies each frame's
neighbour tables (``data/processor/sparse_plan.py``); a sparse convolution
gathers the (V_out, K, C_in) neighbours, missing ones from a zero row at
the sentinel index V_in, and takes one matmul over K * C_in, then
BatchNorm (eps 1e-3, momentum 0.01: flax's 0.99) and ReLU. Every level
keeps the padded voxel count, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from ..blocks import BatchNormLast

# (name, table, output channels) of VoxelBackBone8x: the channel plan
# [16, 16, 32, 64, 64] and conv_out 128; the levels x_conv1..4 end after
# conv1, conv2_b, conv3_b and conv4_b
BACKBONE8X_LAYERS = (
    ('conv_input', 'subm1', 16), ('conv1', 'subm1', 16),
    ('conv2_down', 'down2', 32), ('conv2_a', 'subm2', 32),
    ('conv2_b', 'subm2', 32),
    ('conv3_down', 'down3', 64), ('conv3_a', 'subm3', 64),
    ('conv3_b', 'subm3', 64),
    ('conv4_down', 'down4', 64), ('conv4_a', 'subm4', 64),
    ('conv4_b', 'subm4', 64),
    ('conv_out', 'out', 128))
LEVEL_ENDS = {'conv1': 'x_conv1', 'conv2_b': 'x_conv2', 'conv3_b': 'x_conv3',
              'conv4_b': 'x_conv4'}


def sparse_gather(features, table):
    """(B, V_in, C) features, (B, V_out, K) table with sentinel V_in ->
    (B, V_out, K, C); the sentinel reads a zero row."""
    B, V_in, C = features.shape
    padded = torch.cat([features, features.new_zeros(B, 1, C)], dim=1)
    _, Vo, K = table.shape
    flat = table.reshape(B, Vo * K, 1).long().expand(-1, -1, C)
    return padded.gather(1, flat).reshape(B, Vo, K, C)


class SparseConv(nn.Sequential):
    """Gather, Linear without bias over K * C_in (index 0), BatchNorm
    (1), ReLU (2)."""

    def __init__(self, in_channels: int, out_channels: int, taps: int = 27):
        super().__init__(nn.Linear(taps * in_channels, out_channels,
                                   bias=False),
                         BatchNormLast(out_channels, eps=1e-3, momentum=0.01),
                         nn.ReLU())

    def forward(self, features, table):
        g = sparse_gather(features, table)
        return super().forward(g.reshape(*g.shape[:2], -1))


class VoxelBackBone8x(nn.Module):
    """Reads 'voxel_features' and the plan's tables ('subm1_table', ...);
    adds 'encoded_voxel_features' (B, V, 128) with the last level's
    coordinates and valid mask, and 'multi_scale_3d_features' {x_conv1..4}
    (B, V, C). Submodules are named after the flax modules."""

    def __init__(self, input_channels: int = 4):
        super().__init__()
        c = input_channels
        for name, table, out in BACKBONE8X_LAYERS:
            # kernel taps: 3 x 3 x 3, and (3, 1, 1) for conv_out
            self.add_module(name, SparseConv(c, out,
                                             3 if table == 'out' else 27))
            c = out
        self.num_features = c

    def forward(self, batch):
        x = batch['voxel_features']
        levels = {}
        for name, table, _ in BACKBONE8X_LAYERS:
            x = getattr(self, name)(x, batch[f'{table}_table'])
            if name in LEVEL_ENDS:
                levels[LEVEL_ENDS[name]] = x
        return dict(batch, encoded_voxel_features=x,
                    encoded_voxel_coords=batch['out_coords'],
                    encoded_voxel_valid=batch['out_valid'],
                    multi_scale_3d_features=levels)


class HeightCompression(nn.Module):
    """Scatter the last level's voxels onto the dense final grid (nz, ny,
    nx) and fold z into channels, z-major as the JAX package does: channel
    z * C + c of 'spatial_features' (B, nz * C, ny, nx)."""

    def __init__(self, grid_zyx):
        super().__init__()
        self.grid_zyx = tuple(int(v) for v in grid_zyx)

    def forward(self, batch):
        f = batch['encoded_voxel_features']
        coords = batch['encoded_voxel_coords'].long()
        nz, ny, nx = self.grid_zyx
        B, V, C = f.shape
        cells = nz * ny * nx
        flat = (coords[..., 0] * ny + coords[..., 1]) * nx + coords[..., 2]
        flat = torch.where(batch['encoded_voxel_valid'], flat, cells)
        canvas = f.new_zeros(B, cells + 1, C)
        canvas[torch.arange(B, device=f.device)[:, None], flat] = f
        canvas = canvas[:, :cells].reshape(B, nz, ny, nx, C)
        return dict(batch, spatial_features=canvas.permute(
            0, 1, 4, 2, 3).reshape(B, nz * C, ny, nx))
