"""PV-RCNN (``detectors/pv_rcnn.py``, as
``spsnet_tpu/models/detectors/pv_rcnn.py:27-117``): SECOND's voxel stack
for the proposals (its dense head AnchorHeadSingle, or CenterHeadIoU where
DENSE_HEAD names CenterHead, as ``pv_rcnn_with_centerhead_rpn.yaml``), then
VoxelSetAbstraction (keypoints), PointHeadSimple (their scores) and
PVRCNNHead (the RoI-grid refinement). The caller runs
``detector3d.post_processing``, whose labels then come from the RoIs. In
training with 'gt_boxes' (and the step's generators in 'rngs'), each head
assigns its targets, and ``loss`` sums the three heads' losses.
"""
from __future__ import annotations

from ..dense_heads.point_head_simple import (PointHeadSimple,
                                             point_head_simple_loss)
from ..pfe.voxel_set_abstraction import VoxelSetAbstraction
from ..roi_heads.pointrcnn_head import pointrcnn_head_loss
from ..roi_heads.pvrcnn_head import PVRCNNHead
from .second_net import SECONDNet


class PVRCNN(SECONDNet):

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx,
                 class_names=None, fps_seeding=None):
        super().__init__(model_cfg, num_class, input_channels, voxel_size,
                         point_cloud_range, final_grid_zyx, class_names)
        self.pfe = VoxelSetAbstraction(
            model_cfg.PFE, voxel_size, point_cloud_range,
            self.num_bev_features, input_channels - 3, bev_stride=8,
            fps_seeding=fps_seeding,
            level_channels=self.backbone_3d.level_channels)
        use_before = model_cfg.POINT_HEAD.get(
            'USE_POINT_FEATURES_BEFORE_FUSION', False)
        self.point_head = PointHeadSimple(
            model_cfg.POINT_HEAD, 1,
            self.pfe.num_point_features_before_fusion if use_before
            else self.pfe.num_point_features)
        self.roi_head = PVRCNNHead(
            model_cfg.ROI_HEAD,
            1 if model_cfg.ROI_HEAD.CLASS_AGNOSTIC else num_class,
            self.pfe.num_point_features)

    def forward(self, batch):
        """As SECOND's, then the keypoints, their scores and the RoI-grid
        head; 'batch_box_preds' (B, R, 7) and 'batch_cls_preds' (B, R, 1)
        are the refined RoIs in eval."""
        batch = self.stage_one(batch)
        return self.roi_head(self.point_head(self.pfe(batch)))

    def loss(self, batch):
        """(loss, tb) of a forward's output in training mode: the dense
        head's (tb as ``SECONDNet.loss``), the point head's and the RoI
        head's losses, tb also holding 'point_loss_cls', 'rcnn_loss_cls',
        'rcnn_loss_reg', 'rcnn_loss_corner' and 'rcnn_loss'."""
        l_rpn, tb = super().loss(batch)
        l_point, tb_point = point_head_simple_loss(
            batch['point_head_simple_ret'],
            self.model_cfg.POINT_HEAD.LOSS_CONFIG)
        l_rcnn, tb_rcnn = pointrcnn_head_loss(
            batch['roi_head_ret'], self.model_cfg.ROI_HEAD.LOSS_CONFIG,
            self.roi_head.box_coder)
        return l_rpn + l_point + l_rcnn, {**tb, **tb_point, **tb_rcnn}
