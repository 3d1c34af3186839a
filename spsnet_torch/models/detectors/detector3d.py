"""Post-processing: per-frame NMS with fixed-shape outputs.

Port of ``spsnet_tpu/models/detectors/detector3d.py``:
``class_agnostic_nms_batch`` (reference ``model_nms_utils.
class_agnostic_nms``: score threshold, top-``nms_pre`` by score, rotated
BEV NMS, ``nms_post`` cap, all frames at once), ``multi_classes_nms_batch``
(``model_nms_utils.multi_classes_nms``: each class suppressed alone, the
survivors merged by score) and SECOND-IoU's ``iou_rescore_post_processing``
(``second_net_iou.py:76-180``).
"""
from __future__ import annotations

import torch

from ... import ops
from ...ops.boxes import topk_desc
from ...utils import box_utils


def class_agnostic_nms_batch(batch_box_preds, batch_cls_preds,
                             score_thresh: float, nms_thresh: float,
                             nms_pre: int, nms_post: int,
                             cls_preds_normalized: bool = False,
                             batch_label_preds=None):
    """
    Args:
        batch_box_preds: (B, M, 7+); batch_cls_preds: (B, M, num_class)
            logits (probabilities when ``cls_preds_normalized``);
        batch_label_preds: optional (B, M) labels gathered at the kept
            indices in place of argmax + 1 (the reference's
            ``has_class_labels`` route, ``detector3d_template.py:230-232``).
    Returns dict:
        boxes (B, P, 7+), scores (B, P), labels (B, P) int64 (1-based, 0
        pad), count (B,) int64, indices (B, P) int64 (-1 pad) into the M
        axis, with P = min(nms_post, nms_pre, M).
    """
    cls_scores = batch_cls_preds if cls_preds_normalized \
        else torch.sigmoid(batch_cls_preds)
    scores = cls_scores.amax(dim=-1)
    labels = cls_scores.argmax(dim=-1) + 1 if batch_label_preds is None \
        else batch_label_preds.long()  # argmax: the first maximal class
    keep_idx, count = ops.nms_bev(batch_box_preds, scores, nms_thresh,
                                  pre_maxsize=nms_pre, post_maxsize=nms_post,
                                  valid=scores > score_thresh)
    ok = keep_idx >= 0
    safe = keep_idx.clamp(min=0)
    boxes = batch_box_preds.gather(1, safe[..., None].expand(
        -1, -1, batch_box_preds.shape[-1]))
    return {
        'boxes': torch.where(ok[..., None], boxes, 0.0),
        'scores': torch.where(ok, scores.gather(1, safe), 0.0),
        'labels': torch.where(ok, labels.gather(1, safe), 0),
        'count': count,
        'indices': keep_idx,
    }


def multi_classes_nms_batch(batch_box_preds, batch_cls_preds,
                            score_thresh: float, nms_thresh: float,
                            nms_pre: int, nms_post: int,
                            cls_preds_normalized: bool = False):
    """Per-class NMS (``spsnet_tpu/models/detectors/detector3d.py:71-108``;
    reference ``model_nms_utils.multi_classes_nms``): each class of each
    frame is suppressed alone (its scores above ``score_thresh``, its top
    ``nms_pre``, at most P = min(nms_post, nms_pre, M) kept), the
    survivors concatenated class after class, empty slots scoring -1, and
    the ``nms_post`` best of them taken (the lower slot first among equal
    scores, as ``jax.lax.top_k``).

    One ``ops.nms_bev`` call holds all B x num_class (frame, class) rows:
    each row's top-``nms_pre`` candidates by ``topk_desc`` and their boxes
    gathered into (B * C, pre, 7), so the greedy loop runs once for all
    classes (a loop over the classes would run it C times). Index for
    index a per-class loop's result: each row's candidates are the ones
    ``nms_bev`` would pick, in its order.

    Returns dict: boxes (B, nms_post, 7+), scores (B, nms_post) (0 pad),
    labels (B, nms_post) int64 (1-based, 0 pad), count (B,) int64 and
    indices (B, nms_post) int64, each kept box's index into the M axis
    (-1 pad).
    """
    cls_scores = batch_cls_preds if cls_preds_normalized \
        else torch.sigmoid(batch_cls_preds)
    B, M, C = cls_scores.shape
    pre = min(nms_pre, M)
    rows = cls_scores.transpose(1, 2).reshape(B * C, M)
    top, cand = topk_desc(torch.where(rows > score_thresh, rows,
                                      -torch.inf), pre)
    frame = torch.arange(B, device=rows.device).repeat_interleave(C)
    boxes = batch_box_preds[frame[:, None], cand]            # (B*C, pre, D)
    keep, _ = ops.nms_bev(boxes[..., :7], top, nms_thresh,
                          pre_maxsize=pre, post_maxsize=nms_post,
                          valid=top > -torch.inf)
    ok = keep >= 0
    safe = keep.clamp(min=0)
    index = torch.where(ok, cand.gather(1, safe), -1).reshape(B, -1)
    scores = torch.where(ok, top.gather(1, safe), -1.0).reshape(B, -1)
    labels = torch.where(ok, torch.arange(1, C + 1, device=rows.device)
                         .repeat(B)[:, None], 0).reshape(B, -1)
    top_scores, order = topk_desc(scores, nms_post)
    kept = top_scores > -1.0
    index = torch.where(kept, index.gather(1, order), -1)
    boxes = batch_box_preds.gather(1, index.clamp(min=0)[..., None].expand(
        -1, -1, batch_box_preds.shape[-1]))
    return {'boxes': torch.where(kept[..., None], boxes, 0.0),
            'scores': torch.where(kept, top_scores, 0.0),
            'labels': torch.where(kept, labels.gather(1, order), 0),
            'count': kept.sum(dim=1), 'indices': index}


def post_processing(batch, post_cfg, class_names=None):
    """The configured NMS over a forward's outputs (``spsnet_tpu/models/
    detectors/detector3d.py:111-135``): SECOND-IoU's
    ``iou_rescore_post_processing`` when the batch says 'iou_rescoring';
    ``multi_classes_nms_batch`` under NMS_CONFIG.MULTI_CLASSES_NMS; else
    class-agnostic NMS, with the labels of 'batch_roi_labels' when the
    batch 'has_class_labels' (PointRCNN). ``class_names`` (the config's
    CLASS_NAMES) serve SCORE_TYPE score_by_class."""
    if batch.get('iou_rescoring', False):
        return iou_rescore_post_processing(batch, post_cfg, class_names)
    nms_cfg = post_cfg.NMS_CONFIG
    args = dict(score_thresh=float(post_cfg.SCORE_THRESH),
                nms_thresh=float(nms_cfg.NMS_THRESH),
                nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE),
                nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
                cls_preds_normalized=bool(batch.get('cls_preds_normalized',
                                                    False)))
    if nms_cfg.get('MULTI_CLASSES_NMS', False):
        return multi_classes_nms_batch(batch['batch_box_preds'],
                                       batch['batch_cls_preds'], **args)
    return class_agnostic_nms_batch(
        batch['batch_box_preds'], batch['batch_cls_preds'],
        batch_label_preds=batch['batch_roi_labels']
        if batch.get('has_class_labels', False) else None, **args)


def _points_in_each_box(points, boxes, valid=None):
    """(B, N, 3+) points, (B, R, 7) boxes -> (B, R) float: the points in
    each box (a point counts in every box holding it), by the canonical
    test with ``points_in_boxes_cpu``'s xy margin of 1e-2
    (``roiaware_pool3d.cpp:131``); zero-size boxes hold none; ``valid``
    (B, N) drops padded points."""
    local = box_utils.points_to_box_local(points[..., :3], boxes)
    inside = box_utils.in_canonical_box(local, boxes[:, None, :, 3:6],
                                        margin=1e-2) & \
        (boxes[:, None, :, 3] > 0)
    if valid is not None:
        inside = inside & valid[:, :, None]
    return inside.float().sum(dim=1)


def iou_rescore_post_processing(batch, post_cfg, class_names=None):
    """SECOND-IoU's post-processing (``spsnet_tpu/models/detectors/
    detector3d.py:138-232``; ``second_net_iou.py:76-180``): class-agnostic
    NMS over the RoIs with each box's score routed by NMS_CONFIG.SCORE_TYPE
    between the IoU head's prediction (sigmoid of 'batch_cls_preds') and
    the RPN's score (sigmoid of 'batch_roi_scores'):

    - absent or ``iou``: the IoU;
    - ``cls``: the RPN score;
    - ``weighted_iou_cls``: SCORE_WEIGHTS.iou x IoU + SCORE_WEIGHTS.cls x
      score;
    - ``num_pts_iou_cls``: (1 - alpha) score + alpha IoU, alpha 0 at or
      below SCORE_THRESH.cls points in the box, 1 at or above
      SCORE_THRESH.iou, (n - 10) / (iou - cls) between (the reference's
      hard-coded 10); points from 'points' ('points_valid' where given);
    - ``score_by_class``: per class (SCORE_BY_CLASS[name] == 'iou' or not;
      needs ``class_names``), the labels from 1 to the count of distinct
      labels in the frame (0 of padded RoIs included) scored, the others
      0 (the reference's ``range(torch.unique(labels).shape[0])``).

    Labels are 'batch_roi_labels' where the batch 'has_class_labels', else
    argmax + 1 of the IoU logits. Returns ``class_agnostic_nms_batch``'s
    dict plus 'cls_scores' and 'iou_scores' of the kept boxes (0 pad)."""
    nms_cfg = post_cfg.NMS_CONFIG
    iou_preds, cls_preds = batch['batch_cls_preds'], batch['batch_roi_scores']
    if not batch.get('cls_preds_normalized', False):
        iou_preds, cls_preds = torch.sigmoid(iou_preds), \
            torch.sigmoid(cls_preds)
    iou_max = iou_preds.amax(dim=-1)
    labels = batch['batch_roi_labels'].long() \
        if batch.get('has_class_labels', False) \
        else iou_preds.argmax(dim=-1) + 1
    kind = nms_cfg.get('SCORE_TYPE', None) or 'iou'
    if kind == 'score_by_class' and nms_cfg.get('SCORE_BY_CLASS', None):
        if class_names is None:
            raise ValueError('SCORE_TYPE score_by_class needs class_names')
        use_iou = torch.tensor(
            [True] + [nms_cfg.SCORE_BY_CLASS[c] == 'iou'
                      for c in class_names], device=labels.device)
        routed = torch.where(use_iou[labels.clamp(min=0)], iou_max,
                             cls_preds)
        n_unique = torch.stack([(labels == k).any(dim=1) for k in range(
            len(class_names) + 1)], dim=1).sum(dim=1, keepdim=True)
        scores = torch.where((labels >= 1) & (labels <= n_unique), routed,
                             0.0)
    elif kind == 'iou':
        scores = iou_max
    elif kind == 'cls':
        scores = cls_preds
    elif kind == 'weighted_iou_cls':
        w = nms_cfg.SCORE_WEIGHTS
        scores = float(w.iou) * iou_max + float(w.cls) * cls_preds
    elif kind == 'num_pts_iou_cls':
        cls_t, iou_t = float(nms_cfg.SCORE_THRESH.cls), \
            float(nms_cfg.SCORE_THRESH.iou)
        npts = _points_in_each_box(batch['points'],
                                   batch['batch_box_preds'][..., :7],
                                   batch.get('points_valid', None))
        alpha = torch.where(npts <= cls_t, 0.0, torch.where(
            npts >= iou_t, 1.0, (npts - 10.0) / (iou_t - cls_t)))
        scores = (1 - alpha) * cls_preds + alpha * iou_max
    else:
        raise NotImplementedError(f'SCORE_TYPE {kind}')
    dets = class_agnostic_nms_batch(
        batch['batch_box_preds'], scores[..., None],
        score_thresh=float(post_cfg.SCORE_THRESH),
        nms_thresh=float(nms_cfg.NMS_THRESH),
        nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE),
        nms_post=int(nms_cfg.NMS_POST_MAXSIZE), cls_preds_normalized=True,
        batch_label_preds=labels)
    ok = dets['indices'] >= 0
    safe = dets['indices'].clamp(min=0)
    dets['cls_scores'] = torch.where(ok, cls_preds.gather(1, safe), 0.0)
    dets['iou_scores'] = torch.where(ok, iou_max.gather(1, safe), 0.0)
    return dets


def head_detections(batch):
    """The detections a head decodes itself (``CenterHeadIoU``:
    CenterPoint's request ends there, its POST_PROCESSING holding no NMS)
    in ``class_agnostic_nms_batch``'s layout: boxes (B, P, 7+), scores
    (B, P), labels (B, P) (1-based, 0 where invalid), valid (B, P) and
    count (B,)."""
    valid = batch['final_valid']
    return {'boxes': batch['final_boxes'], 'scores': batch['final_scores'],
            'labels': batch['final_labels'], 'valid': valid,
            'count': valid.sum(dim=1)}
