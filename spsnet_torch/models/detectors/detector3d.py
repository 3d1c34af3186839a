"""Post-processing: per-frame class-agnostic NMS with fixed-shape outputs.

Port of ``class_agnostic_nms_batch`` (``spsnet_tpu/models/detectors/
detector3d.py:19-66``; reference ``model_nms_utils.class_agnostic_nms``):
score threshold, top-``nms_pre`` by score, rotated BEV NMS, ``nms_post``
cap, all frames at once.
"""
from __future__ import annotations

import torch

from ... import ops


def class_agnostic_nms_batch(batch_box_preds, batch_cls_preds,
                             score_thresh: float, nms_thresh: float,
                             nms_pre: int, nms_post: int,
                             cls_preds_normalized: bool = False,
                             batch_label_preds=None):
    """
    Args:
        batch_box_preds: (B, M, 7); batch_cls_preds: (B, M, num_class) logits
            (probabilities when ``cls_preds_normalized``);
        batch_label_preds: optional (B, M) labels gathered at the kept
            indices in place of argmax + 1 (the reference's
            ``has_class_labels`` route, ``detector3d_template.py:230-232``).
    Returns dict:
        boxes (B, P, 7), scores (B, P), labels (B, P) int64 (1-based, 0 pad),
        count (B,) int64, indices (B, P) int64 (-1 pad) into the M axis,
        with P = min(nms_post, nms_pre, M).
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
    boxes = batch_box_preds.gather(1, safe[..., None].expand(-1, -1, 7))
    return {
        'boxes': torch.where(ok[..., None], boxes, 0.0),
        'scores': torch.where(ok, scores.gather(1, safe), 0.0),
        'labels': torch.where(ok, labels.gather(1, safe), 0),
        'count': count,
        'indices': keep_idx,
    }


def post_processing(batch, post_cfg):
    """The configured NMS over a forward's outputs (``spsnet_tpu/models/
    detectors/detector3d.py:111-135``): class-agnostic NMS, the
    ``MULTI_CLASSES_NMS: False`` setting of the point configs, with the
    labels of 'batch_roi_labels' when the batch 'has_class_labels'
    (PointRCNN). Returns ``class_agnostic_nms_batch``'s dict."""
    nms_cfg = post_cfg.NMS_CONFIG
    if nms_cfg.get('MULTI_CLASSES_NMS', False):
        raise NotImplementedError(
            'MULTI_CLASSES_NMS (ROADMAP Queue 1 item F6)')
    return class_agnostic_nms_batch(
        batch['batch_box_preds'], batch['batch_cls_preds'],
        score_thresh=float(post_cfg.SCORE_THRESH),
        nms_thresh=float(nms_cfg.NMS_THRESH),
        nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE),
        nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
        cls_preds_normalized=bool(batch.get('cls_preds_normalized', False)),
        batch_label_preds=batch['batch_roi_labels']
        if batch.get('has_class_labels', False) else None)


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
