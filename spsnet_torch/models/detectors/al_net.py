"""The AL / MLT-SSD detector (port of ``spsnet_tpu/models/detectors/
al_net.py:23``): the pillar trunk (PillarVFE over the host's pillars,
Sparse2BEV), ``AL3D`` (the BEV and range-view CP-UNets and their
fusion), the BACKBONE_2D it names (``RBFusion``) and ``CenterHeadIoU``,
which the JAX package builds whatever DENSE_HEAD.NAME says. The reference
drives this family through its generic PAGNet runner: a PAGNet config
with a VFE block, or a CenterPoint config over AL_3D, is this class
(``detectors.detector_class``).

The batch is ``data.processor.voxel_batch``'s (pillars and the sampled
'points'), on the model's device. A request ends at the head:
``detector3d.head_detections`` reads its class-specific NMS's
detections (MODEL.POST_PROCESSING holds no NMS). In training with
'gt_boxes' the head assigns its heatmap targets; ``loss`` is
``center_head_iou_loss``, plus the semantic loss on 'sem_labels' under
USE_DET_FOR_SEM, or the semantic loss alone under SEM_TASK.
"""
from __future__ import annotations

import numpy as np
from torch import nn

from ...utils.loss_utils import sem_seg_loss
from ..backbones_2d import build_backbone_2d
from ..backbones_3d.al_3d import AL3D
from ..dense_heads.center_head_iou import CenterHeadIoU, center_head_iou_loss
from .second_net import pillar_trunk


class ALNet(nn.Module):

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
        bev_shape = tuple(int(v) for v in model_cfg.BACKBONE_3D.BEV_SHAPE)
        if bev_shape != self.grid_size[1::-1]:
            raise ValueError(
                f'BACKBONE_3D.BEV_SHAPE {list(bev_shape)} is not the pillar '
                f'grid (ny, nx) = {self.grid_size[1::-1]} of VOXEL_SIZE '
                f'{[float(v) for v in voxel_size]} over POINT_CLOUD_RANGE '
                f'{[float(v) for v in point_cloud_range]}: the '
                "range branch's fusion and the BEV U-Net's d0 would be "
                'concatenated at different sizes (the JAX package fails '
                'there too)')
        self.vfe, self.map_to_bev_module = pillar_trunk(
            model_cfg, input_channels, vs, pcr, self.grid_size)
        self.backbone_3d = AL3D(model_cfg.BACKBONE_3D)
        self.backbone_2d = build_backbone_2d(
            model_cfg.BACKBONE_2D.NAME, model_cfg=model_cfg.BACKBONE_2D,
            input_channels=self.backbone_3d.num_bev_features)
        self.dense_head = CenterHeadIoU(
            model_cfg.DENSE_HEAD, num_class,
            self.backbone_2d.num_bev_features, vs, pcr, class_names,
            train_decode=False)

    def forward(self, batch):
        """The pillar batch -> the batch with every stage's outputs:
        'sem_pred' (B, N, SEM_CLS), the head's 'center_head_iou_ret' and,
        in eval mode, its detections ('final_boxes', 'final_scores',
        'final_labels', 'final_valid')."""
        for module in (self.vfe, self.map_to_bev_module, self.backbone_3d,
                       self.backbone_2d, self.dense_head):
            batch = module(batch)
        return batch

    def loss(self, batch):
        """(loss, tb) of a train forward's output (``ALNet.loss``): with
        DENSE_HEAD.SEM_TASK and 'sem_labels' the semantic loss alone (tb
        'sem_loss'); else ``center_head_iou_loss`` (tb 'hm_loss_head_{g}',
        'loc_loss_head_{g}', 'iou_loss_{g}', 'rpn_loss'), plus the
        foreground-only semantic loss (tb 'sem_loss') with
        USE_DET_FOR_SEM and 'sem_labels'."""
        cfg = self.model_cfg.DENSE_HEAD
        lw = cfg.LOSS_CONFIG.LOSS_WEIGHTS
        has_labels = 'sem_labels' in batch
        if cfg.get('SEM_TASK', False) and has_labels:
            loss = sem_seg_loss(batch['sem_pred'], batch['sem_labels'], lw)
            return loss, {'sem_loss': loss}
        total, tb = center_head_iou_loss(batch['center_head_iou_ret'],
                                         cfg.LOSS_CONFIG,
                                         self.dense_head.head_order)
        if cfg.get('USE_DET_FOR_SEM', False) and has_labels:
            sem = sem_seg_loss(batch['sem_pred'], batch['sem_labels'], lw,
                               fg_only=True)
            tb = dict(tb, sem_loss=sem)
            total = total + sem
        return total, tb
