"""UNetV2, PartA2's sparse encoder-decoder, over the host plan.

Port of ``spsnet_tpu/models/backbones_3d/spconv_unet.py:26-97``
(reference ``backbones_3d/spconv_unet.py``): VoxelBackBone8x's encoder
(and its ``conv_out`` where RETURN_ENCODED_TENSOR is true, the default),
then the reference's UR blocks from level 4 up to level 1. A UR block
runs a ``SparseBasicBlock`` (``conv_up_t{n}``) on the lateral encoder
features, a submanifold conv (``conv_up_m{n}``) over ``cat(bottom,
lateral')``, adds that concatenation with each adjacent channel pair
summed (``view(B, V, ch, 2).sum(-1)``), then an inverse sparse conv
(``inv_conv{n}``) to the next finer level through the plan's
'down{n}_up_table', or at level 1 ``conv5``. An up table's slot k holds
the same kernel offset as the down conv's, so every layer is the
gather-and-matmul ``SparseConv``.
"""
from __future__ import annotations

import torch
from torch import nn

from .spconv_backbone import (BACKBONE8X_LAYERS, LEVEL_ENDS, SparseBasicBlock,
                              SparseConv)

# (level, table of the level, channels of the block, channels after its
# inverse conv: None at level 1, where conv5 stays at the level)
UR_BLOCKS = ((4, 'subm4', 64, 64), (3, 'subm3', 64, 32),
             (2, 'subm2', 32, 16), (1, 'subm1', 16, None))


class UNetV2(nn.Module):
    """Reads 'voxel_features', the plan's tables and 'down{2,3,4}_up_table'
    (``voxel_batch(..., up_tables=True)``); adds 'point_features' (B, V,
    16), the decoder's output at the input voxels, and
    'multi_scale_3d_features' {x_conv1..4}; with ``return_encoded``
    'encoded_voxel_features' (B, V, 128) with the last level's coordinates
    and valid mask, as VoxelBackBone8x. Submodules are named after the
    flax modules; without ``return_encoded`` there is no ``conv_out``."""

    def __init__(self, input_channels: int = 4, return_encoded: bool = True):
        super().__init__()
        self.return_encoded = return_encoded
        c = input_channels
        for name, table, out in BACKBONE8X_LAYERS:
            if name == 'conv_out' and not return_encoded:
                continue
            self.add_module(name, SparseConv(c, out,
                                             3 if table == 'out' else 27))
            c = out
        for n, _, ch, ch_out in UR_BLOCKS:
            self.add_module(f'conv_up_t{n}', SparseBasicBlock(ch))
            self.add_module(f'conv_up_m{n}', SparseConv(2 * ch, ch))
            if ch_out is None:
                self.add_module('conv5', SparseConv(ch, ch))
            else:
                self.add_module(f'inv_conv{n}', SparseConv(ch, ch_out))
        self.num_point_features = 16
        self.level_channels = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64,
                               'x_conv4': 64}

    def ur_block(self, n, table, lateral, bottom, up_table=None):
        """``UR_block_forward``: the lateral block, the merge conv, the
        paired channel reduction, then the inverse conv (or conv5)."""
        trans = getattr(self, f'conv_up_t{n}')(lateral, table)
        merged = torch.cat([bottom, trans], dim=-1)
        m = getattr(self, f'conv_up_m{n}')(merged, table)
        B, V, c_in = merged.shape
        x = m + merged.reshape(B, V, c_in // 2, 2).sum(-1)
        if up_table is None:
            return self.conv5(x, table)
        return getattr(self, f'inv_conv{n}')(x, up_table)

    def forward(self, batch):
        x = batch['voxel_features']
        levels = {}
        for name, table, _ in BACKBONE8X_LAYERS[:-1]:
            x = getattr(self, name)(x, batch[f'{table}_table'])
            if name in LEVEL_ENDS:
                levels[LEVEL_ENDS[name]] = x
        out = dict(batch, multi_scale_3d_features=levels)
        if self.return_encoded:
            out.update(encoded_voxel_features=self.conv_out(
                levels['x_conv4'], batch['out_table']),
                encoded_voxel_coords=batch['out_coords'],
                encoded_voxel_valid=batch['out_valid'])
        x = levels['x_conv4']
        for n, table, _, ch_out in UR_BLOCKS:
            up = None if ch_out is None else batch[f'down{n}_up_table']
            x = self.ur_block(n, batch[f'{table}_table'],
                              levels[f'x_conv{n}'], x, up)
        out['point_features'] = x
        return out
