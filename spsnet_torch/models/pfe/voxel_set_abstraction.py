"""Voxel set abstraction, the keypoint encoder of PV-RCNN and PV-RCNN++.

Port of ``spsnet_tpu/models/pfe/voxel_set_abstraction.py`` (reference
``backbones_3d/pfe/voxel_set_abstraction.py``): NUM_KEYPOINTS keypoints of
the raw points, then per source the keypoints' features: the BEV map
bilinearly interpolated at their xy, and for the raw points and each sparse
level (its voxel centers, padded voxels at ``_FAR``) either an MSG group
(one fused ball query for the source's radii, K2 on the card; the stack
grouping's empty balls zeroed, a SharedMLP and a max over the ball) or,
where the source names VectorPoolAggregationModuleMSG (PV-RCNN++),
VectorPool aggregation (``model_utils/vector_pool.py``). The concatenation
is fused to NUM_OUTPUT_FEATURES by a SharedMLP.

SAMPLE_METHOD FPS (PV-RCNN): exact FPS of the raw points (K1 on the card;
``fps_seeding`` opts into seeded FPS as elsewhere). SPC (PV-RCNN++,
sectorized proposal-centric sampling): the points near a RoI of the batch's
'rois' (``sample_points_with_roi_mask``), split into NUM_SECTORS azimuth
sectors, each sector's quota of masked FPS picks (``sector_fps_dense``);
keypoint slots past the quotas' sum are invalid ('point_valid'), sit at
``_FAR`` and get zero features.

In training every BatchNorm takes the batch's statistics; the keypoints'
indices carry no gradient, the gathers and interpolation do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ... import ops
from ...utils.common import true_div
from ..blocks import SharedMLP
from ..model_utils.vector_pool import VectorPoolAggregationMSG

_FAR = 1e6
# source -> (coordinate key, valid key, downsample factor) of the sparse
# backbone's levels
LEVELS = {'x_conv1': ('voxel_coords', 'voxel_valid', 1),
          'x_conv2': ('down2_coords', 'down2_valid', 2),
          'x_conv3': ('down3_coords', 'down3_valid', 4),
          'x_conv4': ('down4_coords', 'down4_valid', 8)}
# the levels' channels of VoxelBackBone8x, the sparse backbone of PV-RCNN
BACKBONE8X_CHANNELS = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64,
                       'x_conv4': 64}


class LevelCenters(nn.Module):
    """The xyz centers of a sparse level's voxels, (coordinate + 0.5) times
    the level's voxel size plus the range's minimum, in fp32 as the JAX
    package computes them; padded voxels at ``_FAR``, where no ball
    reaches them. Holds only non-persistent buffers."""

    def __init__(self, voxel_size, point_cloud_range):
        super().__init__()
        for name, (_, _, ds) in LEVELS.items():
            vs = np.float32(voxel_size) * ds
            self.register_buffer(f'{name}_voxel',
                                 torch.from_numpy(vs), persistent=False)
            self.register_buffer(f'{name}_half', torch.from_numpy(vs / 2),
                                 persistent=False)
        self.register_buffer('pcr_min', torch.from_numpy(
            np.float32(point_cloud_range)[:3]), persistent=False)

    def forward(self, batch, name):
        """(B, V, 3) centers of level ``name``'s voxels."""
        coord_key, valid_key, _ = LEVELS[name]
        xyz = batch[coord_key].flip(-1).float()
        centers = xyz * getattr(self, f'{name}_voxel') + self.pcr_min + \
            getattr(self, f'{name}_half')
        return torch.where(batch[valid_key][..., None], centers,
                           _FAR).contiguous()


def _norm3(v):
    """(..., 3) -> (...): sqrt((x*x + y*y) + z*z)."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) +
                      v[..., 2] * v[..., 2])


def sample_points_with_roi_mask(xyz, rois, sample_radius_with_roi: float):
    """(B, N) bool: the points within the nearest RoI's half diagonal plus
    ``sample_radius_with_roi`` of its center (``voxel_set_abstraction.py:
    45-76``, the ragged compaction as a mask); where no point is near a
    RoI, point 0 alone, as the reference falls back to ``points[:1]``.
    ``rois`` (B, R, 7+), zero rows (dx <= 0) padding."""
    pad = rois[..., 3] <= 0
    d = _norm3(xyz[:, :, None, :] - rois[:, None, :, 0:3])   # (B, N, R)
    d = torch.where(pad[:, None, :], torch.inf, d)
    min_d, nearest = d.min(dim=-1)
    half_diag = _norm3(true_div(rois[..., 3:6], 2.0))
    mask = min_d < half_diag.gather(1, nearest) + \
        float(np.float32(sample_radius_with_roi))
    none = ~mask.any(dim=-1, keepdim=True)
    first = torch.arange(xyz.shape[1], device=xyz.device)[None] == 0
    return mask | (none & first)


def point_sectors(xyz, num_sectors: int):
    """(B, N) int64 azimuth sector of each point: floor((atan2(y, x) + pi) /
    (2 pi / S)), clipped to [0, S - 1]."""
    ang = torch.atan2(xyz[..., 1], xyz[..., 0]) + math.pi
    return torch.floor(true_div(ang, 2 * math.pi / num_sectors)).clamp(
        0, num_sectors - 1).to(torch.int64)


def sector_quotas(point_mask, sector, num_keypoints: int, num_sectors: int):
    """(B, S) int64 picks of each sector: min(cnt_s, ceil(cnt_s / total *
    K)), with cnt_s the masked points of sector s and total all masked
    points (at least 1)."""
    total = point_mask.sum(dim=-1).clamp(min=1).float()
    cnt = torch.stack([(point_mask & (sector == s)).sum(dim=-1)
                       for s in range(num_sectors)], dim=-1)
    quota = torch.ceil(cnt.float() / total[:, None] * num_keypoints)
    return torch.minimum(cnt, quota.to(torch.int64))


def sector_fps_dense(xyz, point_mask, num_keypoints: int, num_sectors: int):
    """Sectorized FPS (``voxel_set_abstraction.py:78-123``): one masked FPS
    a sector (K1 on the card) whose first quota picks fill the next slots
    of the K outputs, sector after sector. FPS is prefix-stable (its first
    q picks are an FPS of q picks), so each sector's FPS runs for the
    largest quota of the batch's frames (at least 1) in place of K: one
    host read of the quotas, the same outputs. Returns (idx (B, K) int64,
    valid (B, K) bool, quotas (B, S))."""
    B, N, _ = xyz.shape
    K = int(num_keypoints)
    sector = point_sectors(xyz, num_sectors)
    quota = sector_quotas(point_mask, sector, K, num_sectors)
    steps = quota.amax(dim=0).clamp(1, K).tolist()
    # slot K takes the picks past a quota, and is dropped
    out = torch.zeros((B, K + 1), dtype=torch.int64, device=xyz.device)
    offset = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    slots = torch.arange(K, device=xyz.device)
    for s in range(num_sectors):
        m = point_mask & (sector == s)
        picks = ops.farthest_point_sample(xyz, int(steps[s]), valid_mask=m)
        take = slots[None, :picks.shape[1]]
        pos = offset[:, None] + take
        ok = (take < quota[:, s:s + 1]) & (pos < K)
        out.scatter_(1, torch.where(ok, pos, K), picks)
        offset = (offset + quota[:, s]).clamp(max=K)
    return out[:, :K], slots[None] < offset[:, None], quota


class StackSAGroup(nn.Module):
    """The MSG group of one source around the keypoints: ``mlps.{i}`` for
    radius i over [center-relative xyz, features]."""

    def __init__(self, sa_cfg, in_channels: int):
        super().__init__()
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


def source_group(sa_cfg, in_channels: int):
    """A source's group: ``VectorPoolAggregationMSG`` where the config
    names VectorPoolAggregationModuleMSG, else ``StackSAGroup``."""
    if str(sa_cfg.get('NAME', '')) == 'VectorPoolAggregationModuleMSG':
        return VectorPoolAggregationMSG(sa_cfg, in_channels)
    return StackSAGroup(sa_cfg, in_channels)


class VoxelSetAbstraction(nn.Module):
    """Submodules ``SA_rawpoints``, ``SA_layers.{x_convN}`` (each a
    ``source_group``) and ``vsa_point_feature_fusion``.
    ``num_bev_features``: channels of 'spatial_features';
    ``num_raw_features``: point channels after xyz; ``level_channels``: the
    sparse levels' channels (VoxelBackBone8x's by default)."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 num_bev_features: int, num_raw_features: int,
                 bev_stride: int = 8, fps_seeding=None,
                 level_channels=None):
        super().__init__()
        self.sample_method = str(model_cfg.get('SAMPLE_METHOD', 'FPS'))
        if self.sample_method not in ('FPS', 'SPC'):
            raise ValueError(f'VSA SAMPLE_METHOD {self.sample_method}')
        self.model_cfg = model_cfg
        self.num_keypoints = int(model_cfg.NUM_KEYPOINTS)
        self.sources = list(model_cfg.FEATURES_SOURCE)
        self.bev_stride = int(bev_stride)
        self.fps_seeding = fps_seeding
        self.voxel_size = [float(v) for v in np.float32(voxel_size)]
        self.pcr = [float(v) for v in np.float32(point_cloud_range)]
        self.level_centers = LevelCenters(voxel_size, point_cloud_range)
        c = num_bev_features if 'bev' in self.sources else 0
        if 'raw_points' in self.sources:
            self.SA_rawpoints = source_group(model_cfg.SA_LAYER.raw_points,
                                             num_raw_features)
            c += self.SA_rawpoints.out_channels
        self.SA_layers = nn.ModuleDict()
        for name in LEVELS:
            if name in self.sources:
                self.SA_layers[name] = source_group(
                    model_cfg.SA_LAYER[name],
                    (level_channels or BACKBONE8X_CHANNELS)[name])
                c += self.SA_layers[name].out_channels
        self.num_point_features_before_fusion = c
        self.num_point_features = int(model_cfg.NUM_OUTPUT_FEATURES)
        self.vsa_point_feature_fusion = SharedMLP(
            c, [self.num_point_features])

    def voxel_centers(self, batch, name):
        """(B, V, 3) xyz centers of a level's voxels (``LevelCenters``)."""
        return self.level_centers(batch, name)

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

    def sample_keypoints(self, batch, xyz):
        """(keypoint indices (B, K) int64 into 'points', valid (B, K)
        bool): exact (or seeded) FPS, or SPC around the batch's 'rois'."""
        if self.sample_method == 'FPS':
            idx = ops.farthest_point_sample(xyz, self.num_keypoints,
                                            seeding=self.fps_seeding)
            return idx, torch.ones_like(idx, dtype=torch.bool)
        spc = self.model_cfg.SPC_SAMPLING
        near = sample_points_with_roi_mask(
            xyz, batch['rois'][..., :7], float(spc.SAMPLE_RADIUS_WITH_ROI))
        idx, valid, _ = sector_fps_dense(xyz, near, self.num_keypoints,
                                         int(spc.NUM_SECTORS))
        return idx, valid

    def forward(self, batch):
        """Adds 'point_coords' (B, K, 3) keypoints (invalid ones at
        ``_FAR``), 'keypoint_idx' (B, K) into 'points', 'point_valid' (B, K),
        'point_features_before_fusion' and 'point_features' (B, K,
        NUM_OUTPUT_FEATURES). SPC reads the batch's 'rois'."""
        points = batch['points']
        xyz = points[..., 0:3].contiguous()
        kp_idx, kp_valid = self.sample_keypoints(batch, xyz)
        keypoints = torch.where(kp_valid[..., None],
                                ops.gather_points(xyz, kp_idx),
                                _FAR).contiguous()
        feats = []
        if 'bev' in self.sources:
            feats.append(torch.where(kp_valid[..., None], self.bev_interpolate(
                keypoints, batch['spatial_features']), 0.0))
        sources = []
        if 'raw_points' in self.sources:
            raw = points[..., 3:] if points.shape[-1] > 3 else None
            sources.append((self.SA_rawpoints, xyz, raw))
        levels = batch['multi_scale_3d_features']
        for name, group in self.SA_layers.items():
            sources.append((group, self.voxel_centers(batch, name),
                            levels[name]))
        for group, support, support_feats in sources:
            if isinstance(group, VectorPoolAggregationMSG):
                feats.append(group(support, support_feats, keypoints,
                                   kp_valid))
            else:
                feats.append(group(support, support_feats, keypoints))
        kp_features = torch.cat(feats, dim=-1)
        return dict(batch, point_coords=keypoints, keypoint_idx=kp_idx,
                    point_valid=kp_valid,
                    point_features_before_fusion=kp_features,
                    point_features=self.vsa_point_feature_fusion(kp_features))
