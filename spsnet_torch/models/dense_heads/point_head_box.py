"""PointRCNN's stage-1 head: per-point foreground logits and box residuals.

Port of ``PointHeadBox`` (``spsnet_tpu/models/dense_heads/
point_head_box.py``; reference ``dense_heads/point_head_box.py`` and
``point_head_template.py:131-191``): the cls and box FC stacks over the
backbone's point features, the per-point score, and every point's box
decoded with the ``PointResidualCoder`` and its predicted class's mean
size, which the RoI head takes as proposals; in training, each point's
target (``assign_targets_iassd`` with the ignore band of GT_EXTRA_WIDTH)
and ``point_head_box_loss``. Submodules ``cls_layers`` and
``box_layers``, as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import global_sum
from ...utils import box_coder as box_coder_lib
from ...utils import box_utils, loss_utils
from ..blocks import MLPHead
from . import target_assign


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
        'point_head_ret' (with the points' 'targets' in training with
        'gt_boxes' (B, T, 8))."""
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
        ret = {'point_cls_preds': point_cls_preds,
               'point_box_preds_raw': point_box_preds,
               'point_box_preds': decoded, 'point_coords': coords}
        if self.training and 'gt_boxes' in batch:
            gt = batch['gt_boxes']
            ret['targets'] = target_assign.assign_targets_iassd(
                coords.detach(), gt, box_utils.enlarge_box3d(
                    gt, self.model_cfg.TARGET_CONFIG.GT_EXTRA_WIDTH),
                set_ignore_flag=True, ret_box_labels=True,
                box_coder=self.box_coder, num_class=self.num_class)
        batch['point_head_ret'] = ret
        return batch


def point_head_box_loss(ret, loss_cfg, num_class: int):
    """Stage-1 loss (``spsnet_tpu/models/dense_heads/point_head_box.py:
    72-93``): the focal loss of every cared-for point (label >= 0) and the
    weighted smooth-L1 of the box residuals of the foreground points, both
    normalised by the count of foreground points (the joined batch's in a
    data-parallel step, ``parallel.global_sum``). Returns (loss, tb)."""
    lw = loss_cfg.LOSS_WEIGHTS
    labels = ret['targets'].cls_labels
    positives = labels > 0
    pos_norm = global_sum(positives.float().sum()).clamp(min=1.0)
    cls_weights = ((labels == 0) | positives).float() / pos_norm
    one_hot = F.one_hot(labels.clamp(min=0), num_class + 1)[..., 1:].float()
    cls_loss = loss_utils.sigmoid_focal_loss(
        ret['point_cls_preds'], one_hot, cls_weights).sum()
    cls_loss = cls_loss * lw['point_cls_weight']
    box_loss = loss_utils.weighted_smooth_l1(
        ret['point_box_preds_raw'], ret['targets'].box_labels,
        weights=positives.float() / pos_norm,
        code_weights=lw.get('code_weights', None)).sum()
    box_loss = box_loss * lw['point_box_weight']
    return cls_loss + box_loss, {'point_loss_cls': cls_loss,
                                 'point_loss_box': box_loss}
