"""The losses of the heads (``spsnet_tpu/utils/loss_utils.py:19-136``;
reference ``pcdet/utils/loss_utils.py``): elementwise, no reduction unless
stated. ``WeightedCrossEntropy`` names the reference's sigmoid CE
(``WeightedClassificationLoss``, :232)."""
from __future__ import annotations

import numpy as np
import torch

from . import box_utils


def sigmoid_cross_entropy_with_logits(logits, labels):
    """``max(x, 0) - x*z + log(1 + exp(-|x|))``, stable."""
    return logits.clamp(min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def weighted_sigmoid_ce(logits, one_hot_targets, weights=None):
    """(..., C) logits and targets, (...,) weights -> (..., C)."""
    loss = sigmoid_cross_entropy_with_logits(logits, one_hot_targets)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_softmax_ce(logits, one_hot_targets, weights=None):
    """``WeightedCrossEntropyLoss`` (:422): the softmax cross entropy of
    (..., C) logits against (..., C) one-hot targets -> (...,)."""
    loss = -(one_hot_targets * torch.log_softmax(logits, dim=-1)).sum(-1)
    if weights is not None:
        loss = loss * weights
    return loss


def weighted_binary_ce(logits, one_hot_targets, weights=None):
    """Sigmoid CE averaged over classes -> (...,)."""
    loss = sigmoid_cross_entropy_with_logits(logits, one_hot_targets).mean(-1)
    if weights is not None:
        loss = loss * weights
    return loss


def sigmoid_focal_loss(logits, targets, weights=None, gamma=2.0, alpha=0.25):
    """``SigmoidFocalClassificationLoss`` (:12), elementwise."""
    pred_sigmoid = torch.sigmoid(logits)
    alpha_weight = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - pred_sigmoid) + (1.0 - targets) * pred_sigmoid
    loss = alpha_weight * torch.pow(pt, gamma) * \
        sigmoid_cross_entropy_with_logits(logits, targets)
    if weights is not None:
        loss = loss * (weights[..., None] if weights.dim() == loss.dim() - 1
                       else weights)
    return loss


def smooth_l1(diff, beta=1.0 / 9.0):
    if beta < 1e-5:
        return diff.abs()
    n = diff.abs()
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def weighted_smooth_l1(preds, targets, weights=None, beta=1.0 / 9.0,
                       code_weights=None):
    """``WeightedSmoothL1Loss`` (:290): nan targets are ignored. (..., C)
    preds and targets, (...,) weights -> (..., C)."""
    targets = torch.where(torch.isnan(targets), preds, targets)
    diff = preds - targets
    if code_weights is not None:
        diff = diff * diff.new_tensor(code_weights)
    loss = smooth_l1(diff, beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def get_corner_loss_lidar(pred_boxes, gt_boxes, weights=None):
    """8-corner smooth-L1 (beta 1) with the heading-flip min (:497-522):
    (N, 7) x (N, 7) -> (N,)."""
    pred_corners = box_utils.boxes_to_corners_3d(pred_boxes)
    gt_corners = box_utils.boxes_to_corners_3d(gt_boxes)
    gt_flip = gt_boxes.clone()
    gt_flip[:, 6] = gt_boxes[:, 6] + np.pi
    gt_corners_flip = box_utils.boxes_to_corners_3d(gt_flip)
    dist = torch.minimum(
        torch.linalg.norm(pred_corners - gt_corners, dim=2),
        torch.linalg.norm(pred_corners - gt_corners_flip, dim=2))
    loss = smooth_l1(dist, beta=1.0).mean(dim=1)
    if weights is not None:
        loss = loss * weights
    return loss


_CLS_LOSSES = {
    'WeightedBinaryCrossEntropy': weighted_binary_ce,
    'WeightedCrossEntropy': weighted_sigmoid_ce,
    'FocalLoss': sigmoid_focal_loss,
}


def build_cls_loss(name):
    """``IASSD_Head.build_losses``'s name dispatch (prefix match)."""
    for key, fn in _CLS_LOSSES.items():
        if name.startswith(key):
            return fn
    raise NotImplementedError(name)
