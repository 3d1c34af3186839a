"""Voxel set abstraction, PV-RCNN's keypoint encoder, FPS path.

Port of ``spsnet_tpu/models/pfe/voxel_set_abstraction.py:85-215``
(reference ``backbones_3d/pfe/voxel_set_abstraction.py``): NUM_KEYPOINTS
keypoints by exact FPS of the raw points (K1 on the card; ``fps_seeding``
opts into seeded FPS as elsewhere), then per source the keypoints' features:
the BEV map bilinearly interpolated at their xy, and for the raw points and
each sparse level (its voxel centers, padded voxels at ``_FAR``) an MSG
group: one fused ball query for the source's radii (K2 on the card), the
stack grouping's empty balls zeroed, a SharedMLP and a max over the ball.
The concatenation is fused to NUM_OUTPUT_FEATURES by a SharedMLP.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ... import ops
from ..blocks import SharedMLP

_FAR = 1e6
# source -> (coordinate key, valid key, downsample factor, channels) of the
# VoxelBackBone8x levels
LEVELS = {'x_conv1': ('voxel_coords', 'voxel_valid', 1, 16),
          'x_conv2': ('down2_coords', 'down2_valid', 2, 32),
          'x_conv3': ('down3_coords', 'down3_valid', 4, 64),
          'x_conv4': ('down4_coords', 'down4_valid', 8, 64)}


def _vector_pool(sa_cfg):
    if str(sa_cfg.get('NAME', '')) == 'VectorPoolAggregationModuleMSG':
        raise NotImplementedError(
            'VectorPoolAggregationModuleMSG (PV-RCNN++): ROADMAP Queue 1 '
            'item F')


class StackSAGroup(nn.Module):
    """The MSG group of one source around the keypoints: ``mlps.{i}`` for
    radius i over [center-relative xyz, features]."""

    def __init__(self, sa_cfg, in_channels: int):
        super().__init__()
        _vector_pool(sa_cfg)
        self.radii = tuple(float(r) for r in sa_cfg.POOL_RADIUS)
        self.nsamples = tuple(int(n) for n in sa_cfg.NSAMPLE)
        self.mlps = nn.ModuleList(SharedMLP(3 + in_channels, list(m))
                                  for m in sa_cfg.MLPS)
        self.out_channels = sum(int(m[-1]) for m in sa_cfg.MLPS)

    def forward(self, xyz, features, new_xyz):
        """(B, N, 3) support points with (B, N, C) features (or None),
        (B, M, 3) centers -> (B, M, out_channels)."""
        idx = ops.ball_query_multi(self.radii, self.nsamples, xyz, new_xyz)
        pooled = []
        for r, i, mlp in zip(self.radii, idx, self.mlps):
            grouped, _ = ops.query_and_group(r, i.shape[-1], xyz, new_xyz,
                                             features, idx=i)
            pooled.append(mlp(ops.zero_empty_balls(grouped, r)).amax(dim=2))
        return torch.cat(pooled, dim=-1)


class VoxelSetAbstraction(nn.Module):
    """Submodules ``SA_rawpoints``, ``SA_layers.{x_convN}`` and
    ``vsa_point_feature_fusion``. ``num_bev_features``: channels of
    'spatial_features'; ``num_raw_features``: point channels after xyz."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 num_bev_features: int, num_raw_features: int,
                 bev_stride: int = 8, fps_seeding=None):
        super().__init__()
        if str(model_cfg.get('SAMPLE_METHOD', 'FPS')) != 'FPS':
            raise NotImplementedError(
                f'VSA SAMPLE_METHOD {model_cfg.SAMPLE_METHOD} (PV-RCNN++ '
                'sector FPS): ROADMAP Queue 1 item F')
        self.model_cfg = model_cfg
        self.num_keypoints = int(model_cfg.NUM_KEYPOINTS)
        self.sources = list(model_cfg.FEATURES_SOURCE)
        self.bev_stride = int(bev_stride)
        self.fps_seeding = fps_seeding
        self.voxel_size = [float(v) for v in np.float32(voxel_size)]
        self.pcr = [float(v) for v in np.float32(point_cloud_range)]
        for name, (_, _, ds, _) in LEVELS.items():
            vs = np.float32(voxel_size) * ds
            self.register_buffer(f'{name}_voxel',
                                 torch.from_numpy(vs), persistent=False)
            self.register_buffer(f'{name}_half', torch.from_numpy(vs / 2),
                                 persistent=False)
        self.register_buffer('pcr_min', torch.from_numpy(
            np.float32(point_cloud_range)[:3]), persistent=False)
        c = num_bev_features if 'bev' in self.sources else 0
        if 'raw_points' in self.sources:
            self.SA_rawpoints = StackSAGroup(model_cfg.SA_LAYER.raw_points,
                                             num_raw_features)
            c += self.SA_rawpoints.out_channels
        self.SA_layers = nn.ModuleDict()
        for name, (_, _, _, channels) in LEVELS.items():
            if name in self.sources:
                self.SA_layers[name] = StackSAGroup(
                    model_cfg.SA_LAYER[name], channels)
                c += self.SA_layers[name].out_channels
        self.num_point_features_before_fusion = c
        self.num_point_features = int(model_cfg.NUM_OUTPUT_FEATURES)
        self.vsa_point_feature_fusion = SharedMLP(
            c, [self.num_point_features])

    def voxel_centers(self, batch, name):
        """(B, V, 3) xyz centers of a level's voxels; padded ones at
        ``_FAR``, where no ball reaches them."""
        coord_key, valid_key, _, _ = LEVELS[name]
        xyz = batch[coord_key].flip(-1).float()
        centers = xyz * getattr(self, f'{name}_voxel') + self.pcr_min + \
            getattr(self, f'{name}_half')
        return torch.where(batch[valid_key][..., None], centers,
                           _FAR).contiguous()

    def bev_interpolate(self, keypoints, bev):
        """Bilinear features of (B, C, H, W) ``bev`` at the keypoints' xy
        (``voxel_set_abstraction.py:176-205``) -> (B, K, C)."""
        B, C, H, W = bev.shape
        x_idx = (keypoints[..., 0] - self.pcr[0]) / self.voxel_size[0] / \
            self.bev_stride
        y_idx = (keypoints[..., 1] - self.pcr[1]) / self.voxel_size[1] / \
            self.bev_stride
        x0 = torch.floor(x_idx).clamp(0, W - 2)
        y0 = torch.floor(y_idx).clamp(0, H - 2)
        wx = (x_idx - x0).clamp(0.0, 1.0)[..., None]
        wy = (y_idx - y0).clamp(0.0, 1.0)[..., None]
        x0, y0 = x0.long(), y0.long()
        flat = bev.permute(0, 2, 3, 1).reshape(B, H * W, C)

        def at(yy, xx):
            return ops.gather_points(flat, yy * W + xx)
        return (at(y0, x0) * (1 - wy) * (1 - wx) +
                at(y0, x0 + 1) * (1 - wy) * wx +
                at(y0 + 1, x0) * wy * (1 - wx) +
                at(y0 + 1, x0 + 1) * wy * wx)

    def forward(self, batch):
        """Adds 'point_coords' (B, K, 3) keypoints, 'keypoint_idx' (B, K)
        into 'points', 'point_features_before_fusion' and 'point_features'
        (B, K, NUM_OUTPUT_FEATURES)."""
        points = batch['points']
        xyz = points[..., 0:3].contiguous()
        kp_idx = ops.farthest_point_sample(xyz, self.num_keypoints,
                                           seeding=self.fps_seeding)
        keypoints = ops.gather_points(xyz, kp_idx).contiguous()
        feats = []
        if 'bev' in self.sources:
            feats.append(self.bev_interpolate(keypoints,
                                              batch['spatial_features']))
        if 'raw_points' in self.sources:
            raw = points[..., 3:] if points.shape[-1] > 3 else None
            feats.append(self.SA_rawpoints(xyz, raw, keypoints))
        levels = batch['multi_scale_3d_features']
        for name, group in self.SA_layers.items():
            feats.append(group(self.voxel_centers(batch, name), levels[name],
                               keypoints))
        kp_features = torch.cat(feats, dim=-1)
        return dict(batch, point_coords=keypoints, keypoint_idx=kp_idx,
                    point_features_before_fusion=kp_features,
                    point_features=self.vsa_point_feature_fusion(kp_features))
