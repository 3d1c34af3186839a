"""SECOND, forward only (``detectors/second_net.py``, as
``spsnet_tpu/models/detectors/second_net.py``): MeanVFE, VoxelBackBone8x
over the host plan, HeightCompression, BaseBEVBackbone, AnchorHeadSingle.
The batch is ``data.processor.voxel_batch``'s, on the model's device; the
caller runs ``detector3d.post_processing``. Training raises: its targets
and losses wait for their slice.
"""
from __future__ import annotations

import numpy as np
from torch import nn

from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_3d.spconv_backbone import HeightCompression, VoxelBackBone8x
from ..dense_heads.anchor_head import AnchorHeadSingle
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
        """The voxel stack up to the anchor head's decoded boxes."""
        if self.training:
            raise NotImplementedError(
                f'{self.model_cfg.NAME} training (anchor targets and '
                'losses): the port serves the voxel detectors; their '
                'training is on the ROADMAP')
        for module in (self.vfe, self.backbone_3d, self.map_to_bev_module,
                       self.backbone_2d, self.dense_head):
            batch = module(batch)
        return batch

    def forward(self, batch):
        """The voxel batch -> the batch with every stage's outputs;
        'batch_box_preds' (B, H * W * A, 7) and 'batch_cls_preds'
        (B, H * W * A, num_class) are the anchor head's."""
        return self.stage_one(batch)
