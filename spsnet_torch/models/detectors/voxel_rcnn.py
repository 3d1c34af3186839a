"""Voxel R-CNN (``detectors/voxel_rcnn.py``, as
``spsnet_tpu/models/detectors/voxel_rcnn.py:20-102``): SECOND's voxel
stack for the proposals (its dense head AnchorHeadSingle, or CenterHeadIoU
where DENSE_HEAD names CenterHead), then ``VoxelRCNNHead``, which pools the
sparse levels' voxel features at each RoI's grid. The caller runs
``detector3d.post_processing``, whose labels then come from the RoIs. In
training with 'gt_boxes' (and the step's generators in 'rngs') both heads
assign their targets, and ``loss`` sums the two heads' losses.
"""
from __future__ import annotations

from ..roi_heads.pointrcnn_head import pointrcnn_head_loss
from ..roi_heads.voxelrcnn_head import VoxelRCNNHead
from .second_net import SECONDNet


class VoxelRCNN(SECONDNet):

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx,
                 class_names=None):
        super().__init__(model_cfg, num_class, input_channels, voxel_size,
                         point_cloud_range, final_grid_zyx, class_names)
        self.roi_head = VoxelRCNNHead(
            model_cfg.ROI_HEAD,
            1 if model_cfg.ROI_HEAD.CLASS_AGNOSTIC else num_class,
            voxel_size, point_cloud_range, self.backbone_3d.level_channels)

    def forward(self, batch):
        """The voxel stack, then the RoI head; 'batch_box_preds' (B, R, 7)
        and 'batch_cls_preds' (B, R, 1) are the refined RoIs in eval."""
        return self.roi_head(self.stage_one(batch))

    def loss(self, batch):
        """(loss, tb) of a forward's output in training mode: the dense
        head's loss (tb as ``SECONDNet.loss``) plus the RoI head's
        (``pointrcnn_head_loss``: 'rcnn_loss_cls', 'rcnn_loss_reg',
        'rcnn_loss_corner', 'rcnn_loss')."""
        l_rpn, tb = super().loss(batch)
        l_rcnn, tb_rcnn = pointrcnn_head_loss(
            batch['roi_head_ret'], self.model_cfg.ROI_HEAD.LOSS_CONFIG,
            self.roi_head.box_coder)
        return l_rpn + l_rcnn, {**tb, **tb_rcnn}
