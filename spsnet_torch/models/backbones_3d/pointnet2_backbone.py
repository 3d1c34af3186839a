"""PointNet++ MSG backbone for PointRCNN: SA encoder, FP decoder.

Port of ``spsnet_tpu/models/backbones_3d/pointnet2_backbone.py:17-69``
(reference ``PointNet2MSG``, ``backbones_3d/pointnet2_backbone.py:9-95``):
four SA layers with exact D-FPS, then FP layers that interpolate the
features back onto every input point. Dense (B, N, C) layout; submodules
``SA_modules`` and ``FP_modules`` as in the reference state dict.
"""
from __future__ import annotations

from torch import nn

from ..sa_module import FPModule, SAModule


class PointNet2MSG(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 fps_seeding=None):
        super().__init__()
        if fps_seeding is not None:
            raise NotImplementedError(
                'PointNet2MSG runs exact D-FPS only (its JAX counterpart '
                'opts no layer into seeding)')
        sa_cfg = model_cfg.SA_CONFIG
        channel_in = input_channels - 3
        skip = [channel_in]
        self.SA_modules = nn.ModuleList()
        for k, npoint in enumerate(sa_cfg.NPOINTS):
            module = SAModule(channel_in, npoint, sa_cfg.RADIUS[k],
                              sa_cfg.NSAMPLE[k], sa_cfg.MLPS[k])
            self.SA_modules.append(module)
            channel_in = module.out_channels
            skip.append(channel_in)
        fp_cfg = model_cfg.FP_MLPS
        self.FP_modules = nn.ModuleList()
        for k in range(len(fp_cfg)):
            # FP k interpolates level k+1's features (the deepest SA
            # output, or FP k+1's) onto level k and appends level k's own
            known = fp_cfg[k + 1][-1] if k + 1 < len(fp_cfg) else skip[-1]
            self.FP_modules.append(FPModule(known + skip[k], fp_cfg[k]))
        self.num_point_features = fp_cfg[0][-1]

    def forward(self, batch):
        """batch 'points' (B, N, 3 + C) -> the batch with 'point_features'
        (B, N, C'), 'point_coords' (B, N, 3), and each level's points
        'sa_xyz' and FPS picks 'sa_idx' (lists, level 0 the input)."""
        points = batch['points']
        xyz = points[..., 0:3].contiguous()
        features = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_feats, l_idx = [xyz], [features], [None]
        for module in self.SA_modules:
            li_xyz, li_feats, li_idx = module(l_xyz[-1], l_feats[-1])
            l_xyz.append(li_xyz)
            l_feats.append(li_feats)
            l_idx.append(li_idx)
        for i in range(len(self.FP_modules) - 1, -1, -1):
            l_feats[i] = self.FP_modules[i](l_xyz[i], l_xyz[i + 1],
                                            l_feats[i], l_feats[i + 1])
        batch = dict(batch)
        batch['point_features'] = l_feats[0]
        batch['point_coords'] = xyz
        batch['sa_xyz'] = l_xyz
        batch['sa_idx'] = l_idx
        return batch
