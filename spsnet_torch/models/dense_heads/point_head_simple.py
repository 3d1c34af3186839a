"""PV-RCNN's keypoint segmentation head, forward (``point_head_simple.py``,
as ``spsnet_tpu/models/dense_heads/point_head_simple.py:20-45``): a
``cls_layers`` MLPHead over the keypoint features (before the VSA's fusion
with USE_POINT_FEATURES_BEFORE_FUSION) and 'point_cls_scores', the largest
sigmoid, which weights the keypoints in the RoI-grid pool. Its targets and
loss wait for the training slice."""
from __future__ import annotations

import torch
from torch import nn

from ..blocks import MLPHead


class PointHeadSimple(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        self.model_cfg = model_cfg
        self.cls_layers = MLPHead(input_channels, list(model_cfg.CLS_FC),
                                  num_class)

    def forward(self, batch):
        key = 'point_features_before_fusion' if self.model_cfg.get(
            'USE_POINT_FEATURES_BEFORE_FUSION', False) else 'point_features'
        cls_preds = self.cls_layers(batch[key])
        return dict(batch, point_head_simple_ret={'point_cls_preds':
                                                  cls_preds},
                    point_cls_scores=torch.sigmoid(cls_preds).amax(dim=-1))
