"""SECOND (``detectors/second_net.py``, as
``spsnet_tpu/models/detectors/second_net.py``): MeanVFE, VoxelBackBone8x
over the host plan, HeightCompression, BaseBEVBackbone, AnchorHeadSingle.
The batch is ``data.processor.voxel_batch``'s, on the model's device; the
caller runs ``detector3d.post_processing``. In training with 'gt_boxes'
the anchor head assigns its targets, and ``loss`` is
``anchor_head_loss``.
"""
from __future__ import annotations

import numpy as np
from torch import nn

from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_3d.spconv_backbone import HeightCompression, VoxelBackBone8x
from ..dense_heads.anchor_head import AnchorHeadSingle, anchor_head_loss
from ..vfe import MeanVFE


class SECONDNet(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        pcr = np.asarray(point_cloud_range, dtype=np.float32)
        vs = np.asarray(voxel_size, dtype=np.float32)
        self.grid_size = tuple(int(x) for x in
                               np.round((pcr[3:6] - pcr[0:3]) / vs))
        self.vfe = MeanVFE()
        self.backbone_3d = VoxelBackBone8x(input_channels)
        self.map_to_bev_module = HeightCompression(final_grid_zyx)
        self.num_bev_features = int(model_cfg.MAP_TO_BEV.NUM_BEV_FEATURES)
        self.backbone_2d = BaseBEVBackbone(model_cfg.BACKBONE_2D,
                                           self.num_bev_features)
        self.dense_head = AnchorHeadSingle(
            model_cfg.DENSE_HEAD, num_class,
            self.backbone_2d.num_bev_features, self.grid_size, pcr)

    def stage_one(self, batch):
        """The voxel stack up to the anchor head's decoded boxes (and, in
        training with 'gt_boxes', its targets)."""
        for module in (self.vfe, self.backbone_3d, self.map_to_bev_module,
                       self.backbone_2d, self.dense_head):
            batch = module(batch)
        return batch

    def forward(self, batch):
        """The voxel batch -> the batch with every stage's outputs;
        'batch_box_preds' (B, H * W * A, 7) and 'batch_cls_preds'
        (B, H * W * A, num_class) are the anchor head's."""
        return self.stage_one(batch)

    def loss(self, batch):
        """(loss, tb) of a forward's output in training mode: the anchor
        head's ``anchor_head_loss`` (``spsnet_tpu/models/detectors/
        second_net.py:63-69``), tb holding 'rpn_loss_cls', 'rpn_loss_loc',
        'rpn_loss_dir' and 'rpn_loss'."""
        head = self.dense_head
        return anchor_head_loss(batch['anchor_head_ret'],
                                self.model_cfg.DENSE_HEAD.LOSS_CONFIG,
                                self.num_class, head.num_dir_bins,
                                head.dir_offset)
