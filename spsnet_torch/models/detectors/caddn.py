"""CaDDN, camera-only 3D detection (``detectors/caddn.py``, as
``spsnet_tpu/models/detectors/caddn.py:20-75``): ImageVFE (the depth
distribution network, the frustum volume sampled at the voxel centres),
Conv2DCollapse, BaseBEVBackbone and AnchorHeadSingle on the grid
``round((range end - range start) / voxel size)``.

The batch is the JAX package's camera batch on the model's device
(``data.camera``): 'images' (B, H, W, 3), 'trans_lidar_to_cam' (B, 4, 4),
'trans_cam_to_img' (B, 3, 4); in training 'depth_maps' (B, H, W) at full
resolution, 'gt_boxes2d' (B, N, 4) and 'gt_boxes' (B, T, 8). The caller
runs ``detector3d.post_processing``. ``build_detector_from_cfg`` gives it
the config's point-cloud range and, as the JAX package does, no voxel
size (no ``transform_points_to_voxels`` step): the default 0.16 m, which
CaDDN.yaml's ``calculate_grid_size`` repeats.
"""
from __future__ import annotations

import numpy as np
from torch import nn

from ..backbones_2d import build_backbone_2d
from ..dense_heads.anchor_head import AnchorHeadSingle, anchor_head_loss
from ..map_to_bev import Conv2DCollapse
from ..vfe.image_vfe import ImageVFE, image_vfe_loss


class CaDDN(nn.Module):

    def __init__(self, model_cfg, num_class: int,
                 voxel_size=(0.16, 0.16, 0.16),
                 point_cloud_range=(2, -30.08, -3.0, 46.8, 30.08, 1.0)):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        pcr = np.asarray(point_cloud_range, dtype=np.float32)
        vs = np.asarray(voxel_size, dtype=np.float32)
        self.grid_size = tuple(int(x) for x in
                               np.round((pcr[3:6] - pcr[0:3]) / vs))
        self.vfe = ImageVFE(model_cfg.VFE, self.grid_size, pcr)
        channels = int(model_cfg.VFE.FFN.CHANNEL_REDUCE['out_channels'])
        self.map_to_bev_module = Conv2DCollapse(model_cfg.MAP_TO_BEV,
                                                self.grid_size, channels)
        self.backbone_2d = build_backbone_2d(
            model_cfg.BACKBONE_2D.NAME, model_cfg=model_cfg.BACKBONE_2D,
            input_channels=int(model_cfg.MAP_TO_BEV.NUM_BEV_FEATURES))
        self.dense_head = AnchorHeadSingle(
            model_cfg.DENSE_HEAD, num_class,
            self.backbone_2d.num_bev_features, self.grid_size, pcr)

    def forward(self, batch):
        """The camera batch -> the batch with every stage's outputs;
        'batch_box_preds' (B, N, 7) and 'batch_cls_preds' (B, N,
        num_class) are the anchor head's."""
        for module in (self.vfe, self.map_to_bev_module, self.backbone_2d,
                       self.dense_head):
            batch = module(batch)
        return batch

    def loss(self, batch):
        """(loss, tb) of a forward's output in training mode:
        ``anchor_head_loss`` plus ``image_vfe_loss`` (tb 'rpn_loss_cls',
        'rpn_loss_loc', 'rpn_loss_dir', 'rpn_loss', 'ddn_loss')."""
        cfg = self.model_cfg
        head = self.dense_head
        l_rpn, tb = anchor_head_loss(batch['anchor_head_ret'],
                                     cfg.DENSE_HEAD.LOSS_CONFIG,
                                     self.num_class, head.num_dir_bins,
                                     head.dir_offset)
        ffn = cfg.VFE.FFN
        l_depth, tb_depth = image_vfe_loss(
            batch['image_vfe_ret'], batch, dict(ffn.LOSS.get('ARGS', {})),
            dict(ffn.DISCRETIZE), self.vfe.downsample)
        return l_rpn + l_depth, dict(tb, **tb_depth)
