"""SECOND (``detectors/second_net.py``, as
``spsnet_tpu/models/detectors/second_net.py``): MeanVFE, the sparse
backbone over the host plan (VoxelBackBone8x, or VoxelResBackBone8x as the
config names it), HeightCompression, BaseBEVBackbone, and the first
stage's dense head. The batch is ``data.processor.voxel_batch``'s, on the
model's device; the caller runs ``detector3d.post_processing``. In
training with 'gt_boxes' the dense head assigns its targets, and ``loss``
is its loss. The two-stage voxel detectors (PV-RCNN, Voxel R-CNN),
CenterPoint and PointPillar build on this stage; a config without
BACKBONE_3D gets the pillar trunk (a pillar VFE and
``PointPillarScatter``) in place of the voxel one.
"""
from __future__ import annotations

import numpy as np
from torch import nn

from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_3d.spconv_backbone import BACKBONES_3D, HeightCompression
from ..dense_heads.anchor_head import (AnchorHeadMulti, AnchorHeadSingle,
                                       anchor_head_loss)
from ..dense_heads.center_head import CenterHead, center_head_loss
from ..dense_heads.center_head_iou import CenterHeadIoU, center_head_iou_loss
from ..map_to_bev import PointPillarScatter
from ..vfe import PILLAR_VFES, MeanVFE

# the MAP_TO_BEV names of the pillar scatter: the reference's Sparse2BEV
# (``pointpillar_scatter.py:99``) is the same dense scatter by (y, x), as
# ``spsnet_tpu/models/map_to_bev/__init__.py:5-7`` registers it
PILLAR_SCATTERS = ('PointPillarScatter', 'Sparse2BEV')


def build_dense_head(head_cfg, num_class: int, input_channels: int,
                     grid_size, voxel_size, point_cloud_range,
                     class_names=None, train_decode: bool = True,
                     plain_center: bool = False):
    """AnchorHeadSingle; ``AnchorHeadMulti`` for a DENSE_HEAD so named (as
    ``spsnet_tpu/models/detectors/{second_net,pointpillar}.py`` pick it);
    for a DENSE_HEAD named CenterHead or CenterHeadIoU the plain
    ``CenterHead`` where ``plain_center``, else ``CenterHeadIoU``, which
    needs CLASS_NAMES_EACH_HEAD (as ``spsnet_tpu/models/detectors/
    {centerpoint,pv_rcnn,voxel_rcnn,pv_rcnn_plusplus}.py`` pick them)."""
    if head_cfg.NAME in ('CenterHead', 'CenterHeadIoU'):
        if plain_center:
            return CenterHead(head_cfg, num_class, input_channels,
                              voxel_size, point_cloud_range)
        if head_cfg.get('CLASS_NAMES_EACH_HEAD', None) is None:
            raise ValueError(
                'CenterHeadIoU, the CenterHead of this detector (as the JAX '
                'package builds it), needs CLASS_NAMES_EACH_HEAD')
        return CenterHeadIoU(head_cfg, num_class, input_channels,
                             voxel_size, point_cloud_range, class_names,
                             train_decode)
    head = AnchorHeadMulti if head_cfg.NAME == 'AnchorHeadMulti' else \
        AnchorHeadSingle
    return head(head_cfg, num_class, input_channels, grid_size,
                point_cloud_range)


def pillar_trunk(model_cfg, input_channels: int, voxel_size,
                 point_cloud_range, grid_size):
    """The pillar trunk of a config without BACKBONE_3D (as
    ``spsnet_tpu/models/detectors/{pointpillar,centerpoint}.py`` build
    it): (the VFE, PillarVFE or DynamicPillarVFE; ``PointPillarScatter``,
    also named Sparse2BEV) on a grid one pillar high."""
    vfe, bev = model_cfg.VFE.NAME, model_cfg.MAP_TO_BEV.NAME
    if vfe not in PILLAR_VFES or bev not in PILLAR_SCATTERS:
        raise ValueError(f'a trunk without BACKBONE_3D is the pillar one: '
                         f'VFE {vfe} and MAP_TO_BEV {bev} are not '
                         f'{sorted(PILLAR_VFES)} and '
                         f'{sorted(PILLAR_SCATTERS)}')
    if grid_size[2] != 1:
        raise ValueError(f'pillars are one voxel high: grid {grid_size}')
    return (PILLAR_VFES[vfe](model_cfg.VFE, input_channels, voxel_size,
                             point_cloud_range),
            PointPillarScatter(grid_size))


class SECONDNet(nn.Module):
    """``train_decode``: whether a CenterHeadIoU decodes its boxes in
    training (the two-stage detectors take them as proposals)."""

    train_decode = True

    @staticmethod
    def plain_center_head(head_cfg) -> bool:
        """Whether a CenterHead DENSE_HEAD is the plain ``CenterHead``
        (PV-RCNN and Voxel R-CNN build ``CenterHeadIoU``)."""
        return False

    @staticmethod
    def build_backbone_3d(backbone_cfg, input_channels: int):
        """The sparse backbone BACKBONE_3D names (VoxelBackBone8x or
        VoxelResBackBone8x)."""
        return BACKBONES_3D[backbone_cfg.NAME](input_channels)

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx=None,
                 class_names=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        pcr = np.asarray(point_cloud_range, dtype=np.float32)
        vs = np.asarray(voxel_size, dtype=np.float32)
        self.grid_size = tuple(int(x) for x in
                               np.round((pcr[3:6] - pcr[0:3]) / vs))
        if model_cfg.get('BACKBONE_3D', None) is not None:
            self.vfe = MeanVFE()
            self.backbone_3d = self.build_backbone_3d(model_cfg.BACKBONE_3D,
                                                      input_channels)
            self.map_to_bev_module = HeightCompression(final_grid_zyx)
        else:
            self.vfe, self.map_to_bev_module = pillar_trunk(
                model_cfg, input_channels, vs, pcr, self.grid_size)
            self.backbone_3d = None
        self.num_bev_features = int(model_cfg.MAP_TO_BEV.NUM_BEV_FEATURES)
        self.backbone_2d = BaseBEVBackbone(model_cfg.BACKBONE_2D,
                                           self.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg.DENSE_HEAD, num_class,
            self.backbone_2d.num_bev_features, self.grid_size, vs, pcr,
            class_names, self.train_decode,
            self.plain_center_head(model_cfg.DENSE_HEAD))

    def stage_one(self, batch):
        """The voxel stack up to the dense head's decoded boxes (and, in
        training with 'gt_boxes', its targets)."""
        for module in (self.vfe, self.backbone_3d, self.map_to_bev_module,
                       self.backbone_2d, self.dense_head):
            if module is not None:
                batch = module(batch)
        return batch

    def forward(self, batch):
        """The voxel batch -> the batch with every stage's outputs;
        'batch_box_preds' (B, N, 7+) and 'batch_cls_preds' (B, N,
        num_class) are the anchor head's (N = H * W * A)."""
        return self.stage_one(batch)

    def loss(self, batch):
        """(loss, tb) of a forward's output in training mode: the dense
        head's loss, ``anchor_head_loss`` (``spsnet_tpu/models/detectors/
        second_net.py:63-69``; tb 'rpn_loss_cls', 'rpn_loss_loc',
        'rpn_loss_dir', 'rpn_loss'), ``center_head_iou_loss`` (tb
        'hm_loss_head_{g}', 'loc_loss_head_{g}', 'rpn_loss') or
        ``center_head_loss`` (tb 'hm_loss', 'loc_loss', 'center_loss')."""
        head = self.dense_head
        loss_cfg = self.model_cfg.DENSE_HEAD.LOSS_CONFIG
        if isinstance(head, CenterHead):
            return center_head_loss(batch['center_head_ret'], loss_cfg)
        if isinstance(head, CenterHeadIoU):
            return center_head_iou_loss(batch['center_head_iou_ret'],
                                        loss_cfg, head.head_order)
        return anchor_head_loss(batch['anchor_head_ret'], loss_cfg,
                                self.num_class, head.num_dir_bins,
                                head.dir_offset)
