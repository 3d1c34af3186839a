"""PartA2's intra-object part head and its loss.

Port of ``spsnet_tpu/models/dense_heads/point_intra_part_head.py:21-147``
(reference ``dense_heads/point_intra_part_head.py``): over the UNet
decoder's voxel features, a foreground segmentation (``cls_layers``) and
the regression of each voxel's place inside its gt box (``part_reg_layers``,
in [0, 1]^3); with TARGET_CONFIG.BOX_CODER (PartA2_free) also a box a voxel
row (``box_layers``), decoded with the ``PointResidualCoder`` at the
argmax class, which the RoI head takes as proposals. Targets
(``assign_targets_iassd`` on the detached voxel centres) come in training
with 'gt_boxes'.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import global_sum
from ...utils import box_coder as box_coder_lib
from ...utils import box_utils, loss_utils
from ...utils.common import rotate_points_along_z
from ..blocks import MLPHead
from . import target_assign


def intra_part_targets(points, gt_boxes):
    """(B, V, 3) points, (B, T, 8) gt -> (fg (B, V) bool, part locations
    (B, V, 3)): each foreground point's offset from its box's centre in
    the box's frame over the box's dims (clipped at 1e-4), plus 0.5,
    clipped to [0, 1]; zero off the foreground."""
    t = target_assign.assign_targets_iassd(
        points, gt_boxes, None, set_ignore_flag=False, num_class=1,
        binary_label=True)
    boxes = t.gt_box_of_points
    B, V, _ = points.shape
    canonical = rotate_points_along_z(
        (points - boxes[..., 0:3]).reshape(B * V, 1, 3),
        -boxes[..., 6].reshape(B * V)).reshape(B, V, 3)
    part = (canonical / boxes[..., 3:6].clamp(min=1e-4) + 0.5).clamp(0.0,
                                                                     1.0)
    return t.fg_mask, torch.where(t.fg_mask[..., None], part, 0.0)


class PointIntraPartOffsetHead(nn.Module):
    """Submodules ``cls_layers`` (CLS_FC, then num_class logits),
    ``part_reg_layers`` (PART_FC, then 3) and, with a BOX_CODER,
    ``box_layers`` (REG_FC, then the coder's code size)."""

    def __init__(self, model_cfg, num_class: int, input_channels: int = 16):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.cls_layers = MLPHead(input_channels, list(model_cfg.CLS_FC),
                                  num_class)
        self.part_reg_layers = MLPHead(input_channels,
                                       list(model_cfg.PART_FC), 3)
        target_cfg = model_cfg.TARGET_CONFIG
        self.box_coder = None
        if target_cfg.get('BOX_CODER', None) is not None:
            self.box_coder = box_coder_lib.build_box_coder(
                target_cfg.BOX_CODER, **dict(target_cfg.BOX_CODER_CONFIG))
            self.box_layers = MLPHead(input_channels,
                                      list(model_cfg.REG_FC),
                                      self.box_coder.code_size)

    def forward(self, batch):
        """Reads 'point_features' (B, V, C) and 'voxel_centers' (B, V, 3);
        adds 'point_part_ret' (the logits, in training with 'gt_boxes' the
        targets: 'fg_mask' (ANDed with 'voxel_valid'), 'part_targets',
        'valid' and with a box coder 'box_targets') and
        'point_part_features' (B, V, 3 + num_class): the sigmoids of the
        part and segmentation logits. With a box coder also
        'batch_cls_preds' (the logits) and 'batch_box_preds' (B, V, 7), one
        box a voxel row, padded rows included."""
        feats = batch['point_features']
        seg_preds = self.cls_layers(feats)
        part_preds = self.part_reg_layers(feats)
        ret = {'point_cls_preds': seg_preds, 'point_part_preds': part_preds}
        if self.box_coder is not None:
            box_preds = self.box_layers(feats)
            ret['point_box_preds_raw'] = box_preds
        coords = batch['voxel_centers']
        if self.training and 'gt_boxes' in batch:
            gt = batch['gt_boxes']
            fg, part = intra_part_targets(coords.detach(), gt)
            valid = batch.get('voxel_valid', torch.ones_like(fg))
            ret.update(fg_mask=fg & valid, part_targets=part, valid=valid)
            if self.box_coder is not None:
                ret['box_targets'] = target_assign.assign_targets_iassd(
                    coords.detach(), gt, box_utils.enlarge_box3d(
                        gt, self.model_cfg.TARGET_CONFIG.GT_EXTRA_WIDTH),
                    set_ignore_flag=True, ret_box_labels=True,
                    box_coder=self.box_coder, num_class=self.num_class)
        batch = dict(batch, point_part_ret=ret,
                     point_part_features=torch.cat(
                         [torch.sigmoid(part_preds),
                          torch.sigmoid(seg_preds)], dim=-1))
        if self.box_coder is not None:
            batch.update(batch_cls_preds=seg_preds,
                         batch_box_preds=self.box_coder.decode(
                             box_preds, coords,
                             pred_classes=seg_preds.argmax(dim=-1) + 1),
                         cls_preds_normalized=False)
        return batch


def point_intra_part_loss(ret, loss_cfg):
    """The part head's loss (``point_intra_part_head.py:104-147`` of the
    JAX package): the focal segmentation loss over the valid rows (with a
    box coder, of the ignore-banded class labels, ignored rows out),
    normalised by the positives; the part locations' BCE over the
    foreground, over 3 times its count; with a box coder the smooth-L1 of
    the box residuals over the positives. Each count is the joined batch's
    in a data-parallel step (``parallel.global_sum``). Returns (loss, tb)
    with 'point_seg_loss', 'point_part_loss' and 'point_box_loss'."""
    lw = loss_cfg.LOSS_WEIGHTS
    fg = ret['fg_mask']
    valid = ret['valid'].float()
    num_class = ret['point_cls_preds'].shape[-1]
    if 'box_targets' in ret:
        labels = ret['box_targets'].cls_labels
        weights = (labels >= 0).float() * valid / \
            global_sum((labels > 0).float().sum()).clamp(min=1.0)
        one_hot = F.one_hot(labels.clamp(min=0), num_class + 1)
    else:
        weights = valid / global_sum(fg.float().sum()).clamp(min=1.0)
        one_hot = F.one_hot(fg.long(), num_class + 1)
    seg_loss = loss_utils.sigmoid_focal_loss(
        ret['point_cls_preds'], one_hot[..., 1:].float(), weights).sum() * \
        float(lw.get('point_cls_weight', 1.0))
    fg_f = fg.float()
    bce = loss_utils.sigmoid_cross_entropy_with_logits(
        ret['point_part_preds'], ret['part_targets'])
    part_loss = (bce * fg_f[..., None]).sum() / \
        (global_sum(fg_f.sum()) * 3.0).clamp(min=1.0) * \
        float(lw.get('point_part_weight', 1.0))
    tb = {'point_seg_loss': seg_loss, 'point_part_loss': part_loss}
    total = seg_loss + part_loss
    if 'box_targets' in ret:
        t = ret['box_targets']
        pos = (t.cls_labels > 0).float()
        box_loss = loss_utils.weighted_smooth_l1(
            ret['point_box_preds_raw'], t.box_labels,
            weights=pos / global_sum(pos.sum()).clamp(min=1.0),
            code_weights=lw.get('code_weights', None)).sum() * \
            float(lw.get('point_box_weight', 1.0))
        tb['point_box_loss'] = box_loss
        total = total + box_loss
    return total, tb
