"""PointPillars' feature net (``pillar_vfe.py``, as
``spsnet_tpu/models/vfe/vfe_modules.py:31-113``) over the host's
zero-padded (B, V, P, C) pillars.

Each point gets its offset from the mean of its pillar's points and from
the pillar's centre; the padded slots are zeroed once, before the PFN
layers, and each layer's max-pool runs over all P slots, so a partly
filled pillar has each channel's f(0) activation as a floor (the JAX
package's semantics, the reference's too). The max is ``amax``, whose
gradient splits evenly among tied slots, as JAX's ``jnp.max`` does
(``torch.max`` along a dim would give it to one slot). BatchNorm at eps
1e-3 and momentum 0.01 (flax's 0.99) with flax's running-variance rule;
its batch statistics run over all B x V x P rows, the padded pillars and
slots included, as the JAX package's do. Submodules as the reference's:
``pfn_layers.{i}.linear`` and ``pfn_layers.{i}.norm``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNormLast


def pillar_input_channels(model_cfg, num_point_features: int) -> int:
    """The PFN stack's input width: the point's channels (without x, y, z
    when USE_ABSLOTE_XYZ / USE_ABSOLUTE_XYZ is False), the 3 offsets from
    the pillar mean and the 3 from its centre, and the distance with
    WITH_DISTANCE."""
    return num_point_features + (6 if use_absolute_xyz(model_cfg) else 3) \
        + int(bool(model_cfg.get('WITH_DISTANCE', False)))


def use_absolute_xyz(model_cfg) -> bool:
    """The reference's misspelt key first, then the right one, as JAX
    reads them; True unless one of them is False."""
    return model_cfg.get('USE_ABSLOTE_XYZ', model_cfg.get(
        'USE_ABSOLUTE_XYZ', True)) is not False


def f32(v) -> float:
    """``v`` rounded to fp32, as a Python float (exact in the double a
    torch op takes, so the op's fp32 operand is JAX's float32 constant)."""
    return float(np.float32(v))


class PFNLayer(nn.Module):
    """Linear (no bias under BatchNorm), BatchNorm, ReLU, then the max over
    the P axis: the layer's output (B, V, U) when last, else each slot's
    features beside the max, (B, V, P, 2U)."""

    def __init__(self, in_channels: int, out_channels: int, use_norm: bool,
                 last_layer: bool):
        super().__init__()
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, units, bias=not use_norm)
        self.norm = BatchNormLast(units, eps=1e-3, momentum=0.01) \
            if use_norm else None

    def forward(self, x):
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x)
        x = F.relu(x)
        x_max = x.amax(dim=-2, keepdim=True)
        if self.last_layer:
            return x_max.squeeze(-2)
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarVFE(nn.Module):

    def __init__(self, model_cfg, num_point_features: int, voxel_size,
                 point_cloud_range):
        super().__init__()
        self.use_abs = use_absolute_xyz(model_cfg)
        self.with_distance = bool(model_cfg.get('WITH_DISTANCE', False))
        vs = np.asarray(voxel_size, dtype=np.float32)
        pcr = np.asarray(point_cloud_range, dtype=np.float32)
        self.scale = tuple(f32(v) for v in vs)
        self.offset = tuple(f32(vs[k] / 2 + pcr[k]) for k in range(3))
        filters = list(model_cfg.NUM_FILTERS)
        use_norm = bool(model_cfg.get('USE_NORM', True))
        c = pillar_input_channels(model_cfg, num_point_features)
        layers = []
        for i, ch in enumerate(filters):
            last = i == len(filters) - 1
            layers.append(PFNLayer(c, ch, use_norm, last))
            c = ch
        self.pfn_layers = nn.ModuleList(layers)
        self.num_pillar_features = filters[-1]

    def forward(self, batch):
        """'voxels' (B, V, P, C), 'voxel_num_points' (B, V), 'voxel_coords'
        (B, V, 3) zyx -> adds 'pillar_features' (B, V, C_out)."""
        voxels = batch['voxels']
        counts = batch['voxel_num_points']
        coords = batch['voxel_coords']
        P = voxels.shape[2]
        mask = torch.arange(P, device=voxels.device) < counts[..., None]
        denom = counts[..., None, None].to(voxels.dtype).clamp(min=1)
        points_mean = voxels[..., :3].sum(dim=2, keepdim=True) / denom
        f_cluster = voxels[..., :3] - points_mean
        # centre of the pillar: coord * size + (size / 2 + range start),
        # the offset an fp32 constant as JAX's; x from coord 2, z from 0
        centre = [coords[..., 2 - k, None].to(voxels.dtype) * self.scale[k]
                  + self.offset[k] for k in range(3)]
        f_center = torch.stack([voxels[..., k] - centre[k]
                                for k in range(3)], dim=-1)
        feats = [voxels if self.use_abs else voxels[..., 3:], f_cluster,
                 f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(voxels[..., :3], dim=-1,
                                                  keepdim=True))
        x = torch.where(mask[..., None], torch.cat(feats, dim=-1), 0.0)
        for layer in self.pfn_layers:
            x = layer(x)
        return dict(batch, pillar_features=x)
