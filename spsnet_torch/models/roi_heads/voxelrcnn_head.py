"""Voxel R-CNN's RoI head: RoI-grid pooling straight from the sparse
backbone's voxel features.

Port of ``spsnet_tpu/models/roi_heads/voxelrcnn_head.py:45-204``
(reference ``roi_heads/voxelrcnn_head.py`` with
``NeighborVoxelSAModuleMSG``). The proposals are the first stage's boxes
after class-agnostic NMS at NMS_CONFIG.TRAIN in training, TEST in eval; in
training with gt the RoI target sampling replaces them with ROI_PER_IMAGE
RoIs a frame (``pointrcnn_head.sample_roi_targets``, its draws from the
step's 'roi_sampling' generator). Each RoI carries a GRID_SIZE^3 lattice of
points (``pvrcnn_head.roi_grid_points``). For each source level of
FEATURES_SOURCE and each of its scales: ``mlps_in`` (Linear + BatchNorm)
runs on every voxel row of the level before the grouping; the grid points
query the level's voxel centers (padded voxels at 1e6) by ball query (K2
on the card, one launch a level), with the empty balls zeroed; ``mlps_pos``
(Linear + BatchNorm) of the center-relative xyz is added to the grouped
features, ReLU, a max over the slots and ``mlps_out`` (Linear, BatchNorm,
ReLU). The pooled (R, G^3, C) features are flattened point-major, as the
JAX package lays out ``shared_fc``'s first weight, then the shared FC
stack and the cls and reg towers (a Dropout after each layer but the
last, masks from the step's 'dropout' generator) refine each RoI, decoded
in its frame. The BatchNorms of the pool are flax's (momentum 0.9, eps
1e-5) with its running-variance rule (``blocks.BatchNormLast``). The loss
is PointRCNN's ``pointrcnn_head_loss``.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import ops
from ...utils import box_coder as box_coder_lib
from ..blocks import BatchNormLast, MLPHead, SharedMLP
from ..pfe.voxel_set_abstraction import LevelCenters
from .pointrcnn_head import (decode_in_roi_frame, proposal_layer,
                             sample_roi_targets)
from .pvrcnn_head import grid_template, roi_grid_points


def _dense_bn(c_in: int, c_out: int, relu: bool = False):
    """Linear without bias and BatchNorm (``_DenseBN``), with a ReLU."""
    return nn.Sequential(nn.Linear(c_in, c_out, bias=False),
                         BatchNormLast(c_out), *([nn.ReLU()] if relu else []))


class NeighborVoxelPool(nn.Module):
    """The pool of one source level: for scale i (MLPS[i] = [mid, ...,
    out]) ``mlps_in.{i}`` C -> mid, ``mlps_pos.{i}`` 3 -> mid and
    ``mlps_out.{i}`` mid -> out."""

    def __init__(self, pool_cfg, in_channels: int):
        super().__init__()
        self.radii = tuple(float(r) for r in pool_cfg.POOL_RADIUS)
        self.nsamples = tuple(int(n) for n in pool_cfg.NSAMPLE)
        mlps = [(int(m[0]), int(m[-1])) for m in pool_cfg.MLPS]
        self.mlps_in = nn.ModuleList(_dense_bn(in_channels, mid)
                                     for mid, _ in mlps)
        self.mlps_pos = nn.ModuleList(_dense_bn(3, mid) for mid, _ in mlps)
        self.mlps_out = nn.ModuleList(_dense_bn(mid, out, relu=True)
                                      for mid, out in mlps)
        self.out_channels = sum(out for _, out in mlps)

    def forward(self, centers, features, grid):
        """(B, V, 3) voxel centers with (B, V, C) features, (B, M, 3) grid
        points -> (B, M, out_channels)."""
        idx = ops.ball_query_multi(self.radii, self.nsamples, centers, grid)
        pooled = []
        for r, i, mlp_in, mlp_pos, mlp_out in zip(
                self.radii, idx, self.mlps_in, self.mlps_pos, self.mlps_out):
            grouped, _ = ops.query_and_group(r, i.shape[-1], centers, grid,
                                             mlp_in(features), idx=i)
            grouped = ops.zero_empty_balls(grouped, r)
            h = torch.relu(grouped[..., 3:] + mlp_pos(grouped[..., :3]))
            pooled.append(mlp_out(h.amax(dim=2)))
        return torch.cat(pooled, dim=-1)


class VoxelRCNNHead(nn.Module):
    """Submodules ``roi_grid_pool_layers.{x_convN}`` (one a source level,
    in FEATURES_SOURCE order), ``shared_fc_layer``, ``cls_layers`` and
    ``reg_layers``; ``level_channels``: the sparse levels' channels."""

    def __init__(self, model_cfg, num_class: int, voxel_size,
                 point_cloud_range, level_channels):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.box_coder = box_coder_lib.build_box_coder(
            model_cfg.TARGET_CONFIG.BOX_CODER)
        pool = model_cfg.ROI_GRID_POOL
        self.grid_size = int(pool.GRID_SIZE)
        self.register_buffer('template', torch.from_numpy(
            grid_template(self.grid_size)), persistent=False)
        self.sources = list(pool.FEATURES_SOURCE)
        self.level_centers = LevelCenters(voxel_size, point_cloud_range)
        self.roi_grid_pool_layers = nn.ModuleDict(
            (name, NeighborVoxelPool(pool.POOL_LAYERS[name],
                                     level_channels[name]))
            for name in self.sources)
        c = sum(layer.out_channels
                for layer in self.roi_grid_pool_layers.values())
        dp = float(model_cfg.get('DP_RATIO', 0.0))
        shared = list(model_cfg.SHARED_FC)
        self.shared_fc_layer = SharedMLP(
            self.grid_size ** 3 * c, shared, dropout=dp,
            dropout_idx=range(len(shared) - 1))
        c = self.shared_fc_layer.out_channels
        cls_fc, reg_fc = list(model_cfg.CLS_FC), list(model_cfg.REG_FC)
        self.cls_layers = MLPHead(c, cls_fc, num_class, dropout=dp,
                                  dropout_idx=range(len(cls_fc) - 1))
        self.reg_layers = MLPHead(c, reg_fc,
                                  self.box_coder.code_size * num_class,
                                  dropout=dp,
                                  dropout_idx=range(len(reg_fc) - 1))

    def roi_grid_pool(self, batch, rois):
        """(B, R, 7+) RoIs -> (B, R, G^3 * C) pooled voxel features,
        point-major (``voxelrcnn_head.py:123-156``)."""
        B, R, _ = rois.shape
        grid = roi_grid_points(rois[..., :7], self.template)
        grid = grid.reshape(B, -1, 3).contiguous()
        levels = batch['multi_scale_3d_features']
        pooled = torch.cat([
            layer(self.level_centers(batch, name), levels[name], grid)
            for name, layer in self.roi_grid_pool_layers.items()], dim=-1)
        return pooled.reshape(B, R, -1)

    def forward(self, batch):
        """As ``PVRCNNHead.forward``: the proposals (in training with
        'gt_boxes' the sampled RoIs and their targets), their refinement
        and the decoded boxes; adds 'rois', 'roi_valid' and 'roi_head_ret'
        and, in eval, 'batch_box_preds', 'batch_cls_preds' (logits),
        'batch_roi_labels' and 'has_class_labels' (the first stage had
        more than one class channel)."""
        has_class_labels = batch['batch_cls_preds'].shape[-1] > 1
        nms = self.model_cfg.NMS_CONFIG
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            batch, nms.TRAIN if self.training else nms.TEST)
        targets = None
        if self.training and 'gt_boxes' in batch:
            targets, rois, roi_labels, _, roi_valid = sample_roi_targets(
                batch, rois, roi_scores, roi_labels, roi_valid,
                self.model_cfg.TARGET_CONFIG)
        dropout = batch.get('rngs', {}).get('dropout') if self.training \
            else None
        shared = self.shared_fc_layer(self.roi_grid_pool(batch, rois),
                                      dropout)
        rcnn_cls = self.cls_layers(shared, dropout)
        rcnn_reg = self.reg_layers(shared, dropout)
        decoded = decode_in_roi_frame(self.box_coder, rcnn_reg, rois)
        batch = dict(batch, rois=rois, roi_valid=roi_valid,
                     roi_head_ret={'rcnn_cls': rcnn_cls, 'rcnn_reg': rcnn_reg,
                                   'rois': rois, 'targets': targets,
                                   'batch_box_preds': decoded})
        if not self.training:
            batch.update(batch_box_preds=decoded, batch_cls_preds=rcnn_cls,
                         batch_roi_labels=roi_labels,
                         has_class_labels=has_class_labels,
                         cls_preds_normalized=False)
        return batch
