"""PV-RCNN's keypoint segmentation head (``point_head_simple.py``, as
``spsnet_tpu/models/dense_heads/point_head_simple.py:20-61``): a
``cls_layers`` MLPHead over the keypoint features (before the VSA's fusion
with USE_POINT_FEATURES_BEFORE_FUSION) and 'point_cls_scores', the largest
sigmoid, which weights the keypoints in the RoI-grid pool. In training
with 'gt_boxes', each keypoint's binary target (``assign_targets_iassd``
on the detached keypoints, ignored inside the gt enlarged by
GT_EXTRA_WIDTH but outside the gt) and ``point_head_simple_loss``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import global_sum
from ...utils import box_utils, loss_utils
from ..blocks import MLPHead
from . import target_assign


class PointHeadSimple(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.cls_layers = MLPHead(input_channels, list(model_cfg.CLS_FC),
                                  num_class)

    def forward(self, batch):
        key = 'point_features_before_fusion' if self.model_cfg.get(
            'USE_POINT_FEATURES_BEFORE_FUSION', False) else 'point_features'
        cls_preds = self.cls_layers(batch[key])
        ret = {'point_cls_preds': cls_preds}
        if self.training and 'gt_boxes' in batch:
            gt = batch['gt_boxes']
            ret['targets'] = target_assign.assign_targets_iassd(
                batch['point_coords'].detach(), gt, box_utils.enlarge_box3d(
                    gt, self.model_cfg.TARGET_CONFIG.GT_EXTRA_WIDTH),
                set_ignore_flag=True, num_class=self.num_class,
                binary_label=True)
        return dict(batch, point_head_simple_ret=ret,
                    point_cls_scores=torch.sigmoid(cls_preds).amax(dim=-1))


def point_head_simple_loss(ret, loss_cfg):
    """The focal loss of every cared-for keypoint (label >= 0) against its
    one-hot target, normalised by the count of foreground keypoints (the
    joined batch's in a data-parallel step, ``parallel.global_sum``)
    (``point_head_template.py``), times point_cls_weight. Returns (loss,
    {'point_loss_cls': loss})."""
    labels = ret['targets'].cls_labels
    positives = labels > 0
    weights = ((labels == 0) | positives).float() / \
        global_sum(positives.float().sum()).clamp(min=1.0)
    num_class = ret['point_cls_preds'].shape[-1]
    one_hot = F.one_hot(labels.clamp(min=0), num_class + 1)[..., 1:].float()
    loss = loss_utils.sigmoid_focal_loss(ret['point_cls_preds'], one_hot,
                                         weights).sum() * \
        float(loss_cfg.LOSS_WEIGHTS.get('point_cls_weight', 1.0))
    return loss, {'point_loss_cls': loss}
