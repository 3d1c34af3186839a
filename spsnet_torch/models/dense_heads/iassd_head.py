"""IA-SSD point head: cls and box FC stacks, target assignment and losses.

Port of ``IASSDHead`` and ``iassd_head_loss``
(``spsnet_tpu/models/dense_heads/iassd_head.py``; reference
``dense_heads/IASSD_head.py``). Both modes run the cls and box FC stacks
over the vote-center features and decode boxes with the bin orientation
and the predicted class's mean size. In training, with ``gt_boxes`` in the
batch, the head also assigns targets (``assign_targets``), and
``iassd_head_loss`` turns the forward's ``head_ret`` into the loss. The
reference's quirks are kept, as the JAX package keeps them (its module
docstring lists them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import global_mean, global_sum
from ...utils import box_coder as box_coder_lib
from ...utils import box_utils, loss_utils
from ..blocks import MLPHead
from . import target_assign


class IASSDHead(nn.Module):
    # the loss masks the SA instance targets of ctr_aware levels by
    # centerness (``iassd_head_loss``)
    sa_centerness_mask = True

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
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

    def assign_targets(self, batch):
        """``IASSD_Head.assign_targets`` (``:238-400``) in dense form: the
        center targets, the per-level SA instance targets and the
        vote-origin targets. No gradient flows through the coordinates."""
        target_cfg = self.model_cfg.TARGET_CONFIG
        gt_boxes = batch['gt_boxes']
        if gt_boxes.shape[-1] == 10:  # nuScenes: drop velocity, keep class
            gt_boxes = torch.cat([gt_boxes[..., 0:7], gt_boxes[..., -1:]], -1)
        extend_gt = gt_boxes
        if target_cfg.get('EXTRA_WIDTH', False):
            extend_gt = box_utils.enlarge_box3d_for_class(
                gt_boxes, target_cfg.EXTRA_WIDTH)
        extend_gt_boxes = box_utils.enlarge_box3d(
            extend_gt, target_cfg.GT_EXTRA_WIDTH)
        kw = dict(box_coder=self.box_coder, num_class=self.num_class)

        out = {'center_targets': target_assign.assign_targets_iassd(
            batch['centers'].detach(), extend_gt, extend_gt_boxes,
            set_ignore_flag=True, ret_box_labels=True, **kw)}
        if target_cfg.get('INS_AWARE_ASSIGN', False):
            # level i pairs sa_ins_preds[i] with encoder_xyz[i + 1]; level 0
            # takes the ignore-flag variant, deeper ones the extended gt
            # (``IASSD_head.py:283-305``)
            sa_targets = []
            ext = box_utils.enlarge_box3d(gt_boxes, [0.5, 0.5, 0.5])
            for i, preds in enumerate(batch['sa_ins_preds']):
                sa_targets.append(None if preds is None else
                                  target_assign.assign_targets_iassd(
                                      batch['encoder_xyz'][i + 1].detach(),
                                      gt_boxes, ext, set_ignore_flag=(i == 0),
                                      use_ex_gt_assign=(i != 0), **kw))
            out['sa_targets'] = sa_targets
        extra = target_cfg.get('ASSIGN_METHOD', None)
        if extra is not None and extra.NAME == 'extend_gt':
            pts = batch['centers_origin'] if extra.get(
                'ASSIGN_TYPE', 'centers') == 'centers_origin' \
                else batch['centers']
            out['center_origin_targets'] = target_assign.assign_targets_iassd(
                pts.detach(), gt_boxes,
                box_utils.enlarge_box3d(gt_boxes, extra.EXTRA_WIDTH),
                set_ignore_flag=True, use_ex_gt_assign=True,
                fg_pc_ignore=bool(extra.get('FG_PC_IGNORE', False)),
                ret_box_labels=True, **kw)
        return out

    def forward(self, batch):
        center_features = batch['centers_features']   # (B, M, C)
        center_cls_preds = self.cls_center_layers(center_features)
        center_box_preds = self.box_center_layers(center_features)
        box_iou3d_preds = (self.box_iou3d_layers(center_features)
                           if self.box_iou3d_layers is not None else None)
        ret = {
            'center_cls_preds': center_cls_preds,
            'center_box_preds': center_box_preds,
            'ctr_offsets': batch['ctr_offsets'],
            'centers': batch['centers'],
            'centers_origin': batch['centers_origin'],
            'sa_ins_preds': batch['sa_ins_preds'],
            'encoder_xyz': batch['encoder_xyz'],
            'box_iou3d_preds': box_iou3d_preds,
        }
        if self.training and 'gt_boxes' in batch:
            ret.update(self.assign_targets(batch))
        pred_classes = center_cls_preds.argmax(dim=-1) + 1
        point_box_preds = self.box_coder.decode(
            center_box_preds, batch['centers'], pred_classes=pred_classes)
        ret['point_box_preds'] = point_box_preds

        batch = dict(batch)
        batch['batch_cls_preds'] = center_cls_preds
        batch['batch_box_preds'] = point_box_preds
        batch['cls_preds_normalized'] = False
        batch['head_ret'] = ret
        return batch


class MLTSSDHead(IASSDHead):
    """``MLT_SSD_Head``: the IA-SSD head without SA centerness masking
    (``dense_heads/MLT_SSD_head.py:603-605``), used by SPSNet.yaml."""
    sa_centerness_mask = False


def _masked_mean(x, mask, eps=1.0):
    return (x * mask).sum() / global_sum(mask.sum()).clamp(min=eps)


def _one_hot_fg(labels, num_class):
    """(B, M) labels (-1 ignored, 0 bg) -> (B, M, num_class) float one-hot
    of the foreground classes."""
    return F.one_hot(labels.clamp(min=0), num_class + 1)[..., 1:].float()


def _vote_loss(ret, vote_type, num_class):
    """Contextual vote loss (``IASSD_head.py:452-529``): ``none`` averages a
    per-class masked smooth-L1 over the classes present; ``ver1``/``ver2``
    average per gt instance (``ver2`` adds the spread around each
    instance's mean prediction)."""
    cot = ret['center_origin_targets']
    centers_pred = ret['centers_origin'] + ret['ctr_offsets']
    per_elem = loss_utils.smooth_l1(
        centers_pred - cot.gt_box_of_points[..., 0:3], beta=1.0)
    if vote_type in ('ver1', 'ver2'):
        max_t = 64
        one_hot_ins = F.one_hot(cot.box_idxs.clamp(0, max_t - 1),
                                max_t).float() * cot.fg_mask[..., None]
        ins_sum = torch.einsum('bm,bmt->bt', per_elem.sum(-1), one_hot_ins)
        ins_cnt = one_hot_ins.sum(dim=1)
        if vote_type == 'ver2':
            mean_pred = torch.einsum('bmc,bmt->btc', centers_pred,
                                     one_hot_ins) \
                / ins_cnt[..., None].clamp(min=1.0)
            spread = loss_utils.smooth_l1(
                centers_pred[:, :, None, :] - mean_pred[:, None, :, :],
                beta=1.0).sum(-1)
            ins_sum = ins_sum + 0.5 * (spread * one_hot_ins).sum(dim=1)
        has_ins = ins_cnt > 0
        ins_loss = ins_sum / ins_cnt.clamp(min=1.0)
        return torch.where(has_ins, ins_loss, 0.0).sum() \
            / global_sum(has_ins.sum()).clamp(min=1)
    losses, present = [], []
    counts = global_sum(torch.stack([(cot.cls_labels == c).float().sum()
                                     for c in range(1, num_class + 1)]))
    for c in range(1, num_class + 1):
        m = (cot.cls_labels == c).float()
        cnt = counts[c - 1]
        losses.append((per_elem * m[..., None]).sum()
                      / (cnt * 3.0).clamp(min=1.0))
        present.append((cnt > 0).float())
    losses, present = torch.stack(losses), torch.stack(present)
    return (losses * present).sum() / present.sum().clamp(min=1.0)


def iassd_head_loss(ret, loss_cfg, num_class, box_coder,
                    sa_centerness_mask=True, sample_method_list=None):
    """Total head loss from the forward's ``head_ret`` -> (loss, tb dict of
    each term), differentiable through the predictions
    (``spsnet_tpu/models/dense_heads/iassd_head.py:158-303``). Every
    batch-level normalizer (the positives, the classes and instances
    present, the points of the orientation residual's mean) counts the
    joined batch inside a data-parallel step (``parallel.global_sum``), so
    each rank's loss is its share of the joined batch's; 'center_pos_num'
    is the rank's own count."""
    lw = loss_cfg.LOSS_WEIGHTS
    tb = {}
    cls_loss_fn = loss_utils.build_cls_loss(loss_cfg.LOSS_CLS)
    ins_loss_fn = loss_utils.build_cls_loss(
        loss_cfg.get('LOSS_INS', loss_cfg.LOSS_CLS))

    vote_loss = _vote_loss(ret, loss_cfg.get('LOSS_VOTE_TYPE', 'none'),
                           num_class) * lw.get('vote_weight', 1.0)
    tb['center_origin_loss_reg'] = vote_loss

    # SA instance-aware loss (``IASSD_head.py:577-623``)
    sa_loss, n_levels = 0.0, 0
    for i, preds in enumerate(ret['sa_ins_preds']):
        if preds is None:
            continue
        t = ret['sa_targets'][i]
        labels = t.cls_labels
        positives = labels > 0
        weights = ((labels == 0) | positives).float() \
            / global_sum(positives.float().sum()).clamp(min=1.0)
        one_hot = _one_hot_fg(labels, num_class)
        if sa_centerness_mask and sample_method_list is not None and \
                'ctr' in sample_method_list[i + 1][0]:
            one_hot = one_hot * target_assign.centerness_mask(
                ret['encoder_xyz'][i + 1], labels, t.gt_box_of_points,
                t.fg_mask)[..., None]
        li = ins_loss_fn(preds, one_hot, weights).mean(dim=-1).sum() \
            * lw.get('ins_aware_weight', [1.0] * 8)[i]
        sa_loss = sa_loss + li
        n_levels += 1
        tb[f'sa{i}_loss_ins'] = li
    if n_levels:
        sa_loss = sa_loss / n_levels
    tb['sa_loss_ins'] = sa_loss

    # center cls loss (``:547-574``)
    ct = ret['center_targets']
    labels = ct.cls_labels
    positives = labels > 0
    pos_count = positives.float().sum()
    pos_norm = global_sum(pos_count)
    cls_weights = ((labels == 0) | positives).float() / pos_norm.clamp(min=1.0)
    one_hot = _one_hot_fg(labels, num_class)
    if loss_cfg.get('CENTERNESS_REGULARIZATION', False):
        one_hot = one_hot * target_assign.centerness_mask(
            ret['centers'], labels, ct.gt_box_of_points,
            ct.fg_mask)[..., None]
    cls_loss = cls_loss_fn(ret['center_cls_preds'], one_hot,
                           cls_weights).mean(dim=-1).sum() \
        * lw['point_cls_weight']
    tb['center_loss_cls'] = cls_loss
    tb['center_pos_num'] = pos_count

    # bin-orientation box loss (``:684-750``)
    box_preds = ret['center_box_preds']
    box_labels = ct.box_labels
    reg_weights = positives.float() / pos_norm.clamp(min=1.0)
    loss_xyzwhl = loss_utils.weighted_smooth_l1(
        box_preds[..., :6], box_labels[..., :6], weights=reg_weights,
        code_weights=lw.get('code_weights', None)).sum()
    bins = box_coder.bin_size
    label_bin_id = box_labels[..., 6].long()
    logp = F.log_softmax(box_preds[..., 6:6 + bins], dim=-1)
    ce = -logp.gather(-1, label_bin_id[..., None])[..., 0]
    loss_ori_cls = (ce * reg_weights).sum() * lw.get('dir_weight', 1.0)
    res_at_label = box_preds[..., 6 + bins:6 + 2 * bins].gather(
        -1, label_bin_id[..., None])[..., 0]
    # the reference's quirk: a mean over ALL points, times sum(reg_weights)
    loss_ori_reg = global_mean(loss_utils.smooth_l1(
        res_at_label - box_labels[..., 7], beta=1.0)) \
        * global_sum(reg_weights.sum())
    box_loss = (loss_xyzwhl + loss_ori_reg + loss_ori_cls) \
        * lw['point_box_weight']
    tb['center_loss_box'] = box_loss

    # corner loss (``:752-766``)
    corner_loss = 0.0
    if loss_cfg.get('CORNER_LOSS_REGULARIZATION', False):
        pred_boxes = ret['point_box_preds']
        B, M, _ = pred_boxes.shape
        pc = loss_utils.get_corner_loss_lidar(
            pred_boxes.reshape(B * M, 7),
            ct.gt_box_of_points[..., :7].reshape(B * M, 7))
        corner_loss = _masked_mean(pc, ct.fg_mask.reshape(-1).float()) \
            * lw['corner_weight']
        tb['corner_loss_reg'] = corner_loss

    total = vote_loss + sa_loss + cls_loss + box_loss + corner_loss
    tb['point_loss'] = total
    return total, tb
