"""PointRCNN, the two-stage detector of the point family (``detectors/
PointRCNN.py``, as ``spsnet_tpu/models/detectors/point_rcnn.py``):
PointNet2MSG backbone, PointHeadBox (stage 1), PointRCNNHead (stage 2); in
training, ``loss`` gives the sum of both stages' losses. The caller runs
``detector3d.post_processing``, whose labels then come from the RoIs."""
from __future__ import annotations

from torch import nn

from ..backbones_3d.pointnet2_backbone import PointNet2MSG
from ..dense_heads.point_head_box import PointHeadBox, point_head_box_loss
from ..roi_heads.pointrcnn_head import PointRCNNHead, pointrcnn_head_loss


class PointRCNN(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int = 4,
                 fps_seeding=None):
        super().__init__()
        name = model_cfg.BACKBONE_3D.NAME
        if name != 'PointNet2MSG':
            raise NotImplementedError(
                f'PointRCNN over BACKBONE_3D {name}: this class has the '
                'PointNet2MSG one (``build_detector`` serves a UNetV2 one '
                'as PartA2FreeNet)')
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.backbone_3d = PointNet2MSG(model_cfg.BACKBONE_3D, num_class,
                                        input_channels, fps_seeding)
        self.point_head = PointHeadBox(model_cfg.POINT_HEAD, num_class,
                                       self.backbone_3d.num_point_features)
        self.roi_head = PointRCNNHead(
            model_cfg.ROI_HEAD,
            1 if model_cfg.ROI_HEAD.CLASS_AGNOSTIC else num_class,
            self.backbone_3d.num_point_features)

    def forward(self, batch):
        """batch 'points' (B, N, 3 + C) -> the batch with the backbone's,
        the point head's and the RoI head's outputs; 'batch_box_preds'
        (B, R, 7) and 'batch_cls_preds' (B, R, 1) are the refined RoIs in
        eval. Training with 'gt_boxes' (B, T, 8) reads the step's
        generators from 'rngs' (``PointRCNNHead.forward``)."""
        return self.roi_head(self.point_head(self.backbone_3d(batch)))

    def loss(self, batch):
        """(loss, tb) of a forward's output in training mode
        (``spsnet_tpu/models/detectors/point_rcnn.py:40-54``): tb holds
        'point_loss_cls', 'point_loss_box', 'rcnn_loss_cls',
        'rcnn_loss_reg', 'rcnn_loss_corner' and 'rcnn_loss'."""
        l1, tb = point_head_box_loss(batch['point_head_ret'],
                                     self.model_cfg.POINT_HEAD.LOSS_CONFIG,
                                     self.num_class)
        l2, tb2 = pointrcnn_head_loss(batch['roi_head_ret'],
                                      self.model_cfg.ROI_HEAD.LOSS_CONFIG,
                                      self.roi_head.box_coder)
        return l1 + l2, {**tb, **tb2}
