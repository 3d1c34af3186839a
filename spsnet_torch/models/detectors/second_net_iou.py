"""SECOND-IoU (``detectors/second_net_iou.py``, as
``spsnet_tpu/models/detectors/second_net_iou.py``): SECOND's stage for the
proposals, then ``SECONDHead``, which predicts an IoU for each RoI from the
BEV map. The caller runs ``detector3d.post_processing``, which rescores
the RoIs by NMS_CONFIG.SCORE_TYPE (``iou_rescore_post_processing``). In
training with 'gt_boxes' (and the step's generators in 'rngs') both heads
assign their targets, and ``loss`` sums the two heads' losses.
"""
from __future__ import annotations

from ..roi_heads.second_head import SECONDHead, second_head_loss
from .second_net import SECONDNet


class SECONDNetIoU(SECONDNet):

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx=None,
                 class_names=None):
        super().__init__(model_cfg, num_class, input_channels, voxel_size,
                         point_cloud_range, final_grid_zyx, class_names)
        self.roi_head = SECONDHead(
            model_cfg.ROI_HEAD, self.backbone_2d.num_bev_features,
            voxel_size, point_cloud_range,
            int(model_cfg.ROI_HEAD.get('BEV_STRIDE', 8)))

    def forward(self, batch):
        """The voxel stack, then the IoU head; in eval 'batch_box_preds'
        (B, R, 7) are the RoIs and 'batch_cls_preds' (B, R, 1) their raw
        IoU logits."""
        return self.roi_head(self.stage_one(batch))

    def loss(self, batch):
        """(loss, tb) of a forward's output in training mode: the anchor
        head's loss (tb as ``SECONDNet.loss``) plus ``second_head_loss``
        ('rcnn_iou_loss')."""
        l_rpn, tb = super().loss(batch)
        l_iou, tb_iou = second_head_loss(batch['second_head_ret'],
                                         self.model_cfg.ROI_HEAD.LOSS_CONFIG)
        return l_rpn + l_iou, {**tb, **tb_iou}
