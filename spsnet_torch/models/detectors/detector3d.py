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
                             cls_preds_normalized: bool = False):
    """
    Args:
        batch_box_preds: (B, M, 7); batch_cls_preds: (B, M, num_class) logits
            (probabilities when ``cls_preds_normalized``).
    Returns dict:
        boxes (B, P, 7), scores (B, P), labels (B, P) int64 (1-based, 0 pad),
        count (B,) int64, indices (B, P) int64 (-1 pad) into the M axis,
        with P = min(nms_post, nms_pre, M).
    """
    cls_scores = batch_cls_preds if cls_preds_normalized \
        else torch.sigmoid(batch_cls_preds)
    scores = cls_scores.amax(dim=-1)
    labels = cls_scores.argmax(dim=-1) + 1  # first maximal class
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
