"""IA-SSD point head, inference branch.

Port of the eval branch of ``IASSDHead.__call__``
(``spsnet_tpu/models/dense_heads/iassd_head.py:114-145``; reference
``dense_heads/IASSD_head.py``): cls and box FC stacks over the vote-center
features, then the bin-orientation decode with the predicted class's mean
size. Target assignment and the losses are the train step (ROADMAP Queue 1
item 5).
"""
from __future__ import annotations

from torch import nn

from ...utils import box_coder as box_coder_lib
from ..blocks import MLPHead


class IASSDHead(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        target_cfg = model_cfg.TARGET_CONFIG
        self.box_coder = box_coder_lib.build_box_coder(
            target_cfg.BOX_CODER, **target_cfg.BOX_CODER_CONFIG)
        self.cls_center_layers = MLPHead(input_channels,
                                         list(model_cfg.CLS_FC), num_class)
        self.box_center_layers = MLPHead(input_channels,
                                         list(model_cfg.REG_FC),
                                         self.box_coder.code_size)
        self.box_iou3d_layers = (
            MLPHead(input_channels, list(model_cfg.IOU_FC), 1)
            if model_cfg.get('IOU_FC', None) is not None else None)

    def forward(self, batch):
        center_features = batch['centers_features']   # (B, M, C)
        center_cls_preds = self.cls_center_layers(center_features)
        center_box_preds = self.box_center_layers(center_features)
        box_iou3d_preds = (self.box_iou3d_layers(center_features)
                           if self.box_iou3d_layers is not None else None)
        pred_classes = center_cls_preds.argmax(dim=-1) + 1
        point_box_preds = self.box_coder.decode(
            center_box_preds, batch['centers'], pred_classes=pred_classes)

        batch = dict(batch)
        batch['batch_cls_preds'] = center_cls_preds
        batch['batch_box_preds'] = point_box_preds
        batch['cls_preds_normalized'] = False
        batch['head_ret'] = {
            'center_cls_preds': center_cls_preds,
            'center_box_preds': center_box_preds,
            'ctr_offsets': batch['ctr_offsets'],
            'centers': batch['centers'],
            'centers_origin': batch['centers_origin'],
            'sa_ins_preds': batch['sa_ins_preds'],
            'encoder_xyz': batch['encoder_xyz'],
            'box_iou3d_preds': box_iou3d_preds,
            'point_box_preds': point_box_preds,
        }
        return batch
