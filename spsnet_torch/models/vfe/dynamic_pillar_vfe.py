"""The dynamic pillar encoder (``dynamic_pillar_vfe.py``, as
``spsnet_tpu/models/vfe/vfe_modules.py:116-212``), straight from the raw
points on the device: no host voxelization.

Points stay dense, (B, N, C). Each point's pillar is ``iy * nx + ix``, its
indices the floor of its offset from the range's start over the pillar
size (a true quotient: ``utils.common.true_div``); points out of range or
not in 'points_valid' go to a dump slot P. Each PFN layer is Linear
(no bias under BatchNorm), BatchNorm, ReLU and the points out of range
zeroed, then a segment max into the (B, P + 1, C) canvas, gathered back
to the points beside their own features for the next layer. The last
canvas, empty pillars 0, is 'spatial_features' (B, C, ny, nx): the
scatter of ``PointPillarScatter`` folds away. The segment max is
``scatter_reduce('amax')``, whose gradient splits evenly among tied
points, as JAX's ``.at[].max`` does. The pillar means are segment sums
(``scatter_add``), whose order of additions a CUDA device does not fix:
the card's means may differ from run to run in the last bits.

BatchNorm runs over all N point slots, the ones out of range included
(zero features), which is the JAX package's documented deviation from
the reference's compacted point list. Submodules as the reference's
``PFNLayerV2``: ``pfn_layers.{i}.linear`` and ``pfn_layers.{i}.norm``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.common import true_div
from ..blocks import BatchNormLast
from .pillar_vfe import f32, pillar_input_channels, use_absolute_xyz


class PFNLayerV2(nn.Module):

    def __init__(self, in_channels: int, units: int, use_norm: bool):
        super().__init__()
        self.linear = nn.Linear(in_channels, units, bias=not use_norm)
        self.norm = BatchNormLast(units, eps=1e-3, momentum=0.01) \
            if use_norm else None

    def forward(self, x):
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x)


class DynamicPillarVFE(nn.Module):

    def __init__(self, model_cfg, num_point_features: int, voxel_size,
                 point_cloud_range):
        super().__init__()
        self.use_abs = use_absolute_xyz(model_cfg)
        self.with_distance = bool(model_cfg.get('WITH_DISTANCE', False))
        vs = np.asarray(voxel_size, dtype=np.float32)
        pcr = np.asarray(point_cloud_range, dtype=np.float32)
        self.nx = int(round((pcr[3] - pcr[0]) / vs[0]))
        self.ny = int(round((pcr[4] - pcr[1]) / vs[1]))
        self.vs = tuple(f32(v) for v in vs)
        self.start = tuple(f32(v) for v in pcr[:3])
        self.cz = f32(vs[2] / 2 + pcr[2])
        filters = list(model_cfg.NUM_FILTERS)
        use_norm = bool(model_cfg.get('USE_NORM', True))
        c = pillar_input_channels(model_cfg, num_point_features)
        layers = []
        for i, ch in enumerate(filters):
            units = ch if i == len(filters) - 1 else ch // 2
            layers.append(PFNLayerV2(c, units, use_norm))
            c = 2 * units
        self.pfn_layers = nn.ModuleList(layers)
        self.num_pillar_features = filters[-1]

    def pillar_index(self, batch):
        """Each point's pillar: (ix, iy, flat, mask), ``flat`` (B, N) int64
        ``iy * nx + ix`` where ``mask`` (in range and in 'points_valid'),
        else the dump slot ny * nx."""
        points = batch['points']
        ix = torch.floor(true_div(points[..., 0] - self.start[0],
                                  self.vs[0])).long()
        iy = torch.floor(true_div(points[..., 1] - self.start[1],
                                  self.vs[1])).long()
        mask = (ix >= 0) & (ix < self.nx) & (iy >= 0) & (iy < self.ny)
        if 'points_valid' in batch:
            mask = mask & batch['points_valid']
        flat = torch.where(mask, iy * self.nx + ix, self.ny * self.nx)
        return ix, iy, flat, mask

    def forward(self, batch):
        """'points' (B, N, C) (and 'points_valid' (B, N) bool, if any) ->
        adds 'spatial_features' (B, C_out, ny, nx)."""
        points = batch['points']
        B, N, _ = points.shape
        P = self.ny * self.nx
        ix, iy, flat, mask = self.pillar_index(batch)

        def index(c):
            return flat[..., None].expand(B, N, c)

        def seg_sum(vals):
            return vals.new_zeros(B, P + 1, vals.shape[-1]).scatter_add_(
                1, index(vals.shape[-1]), vals)

        def gather(canvas):
            return canvas.gather(1, index(canvas.shape[-1]))

        m = mask[..., None]
        cnt = seg_sum(m.to(points.dtype))
        xyz_sum = seg_sum(torch.where(m, points[..., :3], 0.0))
        f_cluster = points[..., :3] - gather(xyz_sum / cnt.clamp(min=1.0))
        cx = (ix.to(points.dtype) + 0.5) * self.vs[0] + self.start[0]
        cy = (iy.to(points.dtype) + 0.5) * self.vs[1] + self.start[1]
        f_center = torch.stack([points[..., 0] - cx, points[..., 1] - cy,
                                points[..., 2] - self.cz], dim=-1)
        feats = [points if self.use_abs else points[..., 3:], f_cluster,
                 f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(points[..., :3], dim=-1,
                                                  keepdim=True))
        x = torch.where(m, torch.cat(feats, dim=-1), 0.0)
        canvas = None
        for i, layer in enumerate(self.pfn_layers):
            x = torch.where(m, layer(x), 0.0)
            canvas = x.new_full((B, P + 1, x.shape[-1]), -1e9).scatter_reduce(
                1, index(x.shape[-1]), x, 'amax', include_self=True)
            if i < len(self.pfn_layers) - 1:
                x = torch.cat([x, gather(canvas)], dim=-1)
        canvas = torch.where(canvas > -1e9, canvas, 0.0)[:, :P]
        return dict(batch, spatial_features=canvas.reshape(
            B, self.ny, self.nx, -1).permute(0, 3, 1, 2).contiguous())
