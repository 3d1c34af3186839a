"""PointRCNN's stage-1 head: per-point foreground logits and box residuals.

Port of ``PointHeadBox``'s forward (``spsnet_tpu/models/dense_heads/
point_head_box.py:22-70``; reference ``dense_heads/point_head_box.py``):
the cls and box FC stacks over the backbone's point features, the
per-point score, and every point's box decoded with the
``PointResidualCoder`` and its predicted class's mean size, which the RoI
head takes as proposals. Submodules ``cls_layers`` and ``box_layers``, as
the reference's; its targets and loss come with PointRCNN training
(ROADMAP Queue 1).
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils import box_coder as box_coder_lib
from ..blocks import MLPHead


class PointHeadBox(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        target_cfg = model_cfg.TARGET_CONFIG
        self.box_coder = box_coder_lib.build_box_coder(
            target_cfg.BOX_CODER, **target_cfg.BOX_CODER_CONFIG)
        self.cls_layers = MLPHead(input_channels, list(model_cfg.CLS_FC),
                                  num_class)
        self.box_layers = MLPHead(input_channels, list(model_cfg.REG_FC),
                                  self.box_coder.code_size)

    def forward(self, batch):
        """Consumes 'point_features' (B, N, C) and 'point_coords'
        (B, N, 3); adds 'point_cls_scores' (B, N), 'batch_cls_preds'
        (B, N, num_class) logits, 'batch_box_preds' (B, N, 7) and
        'point_head_ret'."""
        if self.training and 'gt_boxes' in batch:
            raise NotImplementedError(
                'PointHeadBox targets and loss: PointRCNN training is '
                'ROADMAP Queue 1')
        coords = batch['point_coords']
        point_cls_preds = self.cls_layers(batch['point_features'])
        point_box_preds = self.box_layers(batch['point_features'])
        decoded = self.box_coder.decode(
            point_box_preds, coords,
            pred_classes=point_cls_preds.argmax(dim=-1) + 1)
        batch = dict(batch)
        batch['point_cls_scores'] = torch.sigmoid(point_cls_preds).amax(-1)
        batch['batch_cls_preds'] = point_cls_preds
        batch['batch_box_preds'] = decoded
        batch['cls_preds_normalized'] = False
        batch['point_head_ret'] = {'point_cls_preds': point_cls_preds,
                                   'point_box_preds_raw': point_box_preds,
                                   'point_box_preds': decoded,
                                   'point_coords': coords}
        return batch
