"""PartA2 and the anchor-free PartA2_free (``detectors/PartA2_net.py`` and
the reference's generic PointRCNN runner, as
``spsnet_tpu/models/detectors/part_a2.py:24-152``).

``PartA2Net``: SECOND's voxel stack with the UNetV2 backbone (its encoder
feeds HeightCompression and the anchor head, which makes the proposals),
then ``PointIntraPartOffsetHead`` over the decoder's voxel features and
``PartA2FCHead``. ``PartA2FreeNet`` (a PointRCNN config over UNetV2):
MeanVFE, UNetV2 without its encoded tensor, the part head with its box
branch, whose boxes a voxel row are the proposals, and the RoI head. The
batch is ``voxel_batch(..., up_tables=True)``'s; the caller runs
``detector3d.post_processing``, whose labels then come from the RoIs. In
training with 'gt_boxes' (and the step's generators in 'rngs') every head
assigns its targets, and ``loss`` sums the heads' losses.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..backbones_3d.spconv_unet import UNetV2
from ..dense_heads.point_intra_part_head import (PointIntraPartOffsetHead,
                                                 point_intra_part_loss)
from ..roi_heads.parta2_head import PartA2FCHead
from ..roi_heads.pointrcnn_head import pointrcnn_head_loss
from ..vfe import MeanVFE
from .second_net import SECONDNet


class VoxelCenters(nn.Module):
    """'voxel_coords' (B, V, 3) zyx -> the voxels' centres (B, V, 3) xyz:
    ``coords[..., ::-1] * voxel_size + range_min + voxel_size / 2``."""

    def __init__(self, voxel_size, point_cloud_range):
        super().__init__()
        vs = np.asarray(voxel_size, np.float32)
        pcr = np.asarray(point_cloud_range, np.float32)
        self.register_buffer('voxel_size', torch.from_numpy(vs),
                             persistent=False)
        self.register_buffer('range_min', torch.from_numpy(pcr[:3].copy()),
                             persistent=False)
        self.register_buffer('half_size', torch.from_numpy(vs / 2),
                             persistent=False)

    def forward(self, coords_zyx):
        return coords_zyx.flip(-1).float() * self.voxel_size + \
            self.range_min + self.half_size


def _heads(model_cfg, num_class, point_num_class):
    """The part head and the RoI head over UNetV2's 16 channels."""
    return (PointIntraPartOffsetHead(model_cfg.POINT_HEAD, point_num_class),
            PartA2FCHead(model_cfg.ROI_HEAD,
                         1 if model_cfg.ROI_HEAD.CLASS_AGNOSTIC
                         else num_class))


class PartA2Net(SECONDNet):

    @staticmethod
    def build_backbone_3d(backbone_cfg, input_channels: int):
        return UNetV2(input_channels,
                      bool(backbone_cfg.get('RETURN_ENCODED_TENSOR', True)))

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx,
                 class_names=None):
        super().__init__(model_cfg, num_class, input_channels, voxel_size,
                         point_cloud_range, final_grid_zyx, class_names)
        self.voxel_centers = VoxelCenters(voxel_size, point_cloud_range)
        self.point_head, self.roi_head = _heads(model_cfg, num_class, 1)

    def forward(self, batch):
        """SECOND's stages over UNetV2, then the part head and the RoI
        head; 'batch_box_preds' (B, R, 7) and 'batch_cls_preds' (B, R, 1)
        are the refined RoIs in eval."""
        batch = self.stage_one(batch)
        batch['voxel_centers'] = self.voxel_centers(batch['voxel_coords'])
        return self.roi_head(self.point_head(batch))

    def loss(self, batch):
        """(loss, tb): the anchor head's (tb as ``SECONDNet.loss``), the
        part head's ('point_seg_loss', 'point_part_loss') and the RoI
        head's ('rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss_corner',
        'rcnn_loss') losses summed."""
        l_rpn, tb = super().loss(batch)
        l_part, tb_part = point_intra_part_loss(
            batch['point_part_ret'], self.model_cfg.POINT_HEAD.LOSS_CONFIG)
        l_rcnn, tb_rcnn = pointrcnn_head_loss(
            batch['roi_head_ret'], self.model_cfg.ROI_HEAD.LOSS_CONFIG,
            self.roi_head.box_coder)
        return l_rpn + l_part + l_rcnn, {**tb, **tb_part, **tb_rcnn}


class PartA2FreeNet(nn.Module):
    """Built for a PointRCNN config whose BACKBONE_3D is UNetV2 (as
    ``spsnet_tpu/models/detectors/__init__.py:53-57`` routes it)."""

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx=None,
                 class_names=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.vfe = MeanVFE()
        self.backbone_3d = PartA2Net.build_backbone_3d(model_cfg.BACKBONE_3D,
                                                       input_channels)
        self.voxel_centers = VoxelCenters(voxel_size, point_cloud_range)
        self.point_head, self.roi_head = _heads(
            model_cfg, num_class,
            1 if model_cfg.POINT_HEAD.get('CLASS_AGNOSTIC', False)
            else num_class)

    def stage_one(self, batch):
        """The voxel stack up to the part head's boxes a voxel row (and, in
        training with 'gt_boxes', its targets)."""
        batch = self.backbone_3d(self.vfe(batch))
        batch['voxel_centers'] = self.voxel_centers(batch['voxel_coords'])
        return self.point_head(batch)

    def forward(self, batch):
        return self.roi_head(self.stage_one(batch))

    def loss(self, batch):
        """(loss, tb): the part head's ('point_seg_loss', 'point_part_loss',
        'point_box_loss') and the RoI head's losses summed."""
        l_part, tb = point_intra_part_loss(
            batch['point_part_ret'], self.model_cfg.POINT_HEAD.LOSS_CONFIG)
        l_rcnn, tb_rcnn = pointrcnn_head_loss(
            batch['roi_head_ret'], self.model_cfg.ROI_HEAD.LOSS_CONFIG,
            self.roi_head.box_coder)
        return l_part + l_rcnn, {**tb, **tb_rcnn}
