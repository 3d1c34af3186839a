"""The losses of the heads (``spsnet_tpu/utils/loss_utils.py:19-218``;
reference ``pcdet/utils/loss_utils.py``): elementwise, no reduction unless
stated. ``WeightedCrossEntropy`` names the reference's sigmoid CE
(``WeightedClassificationLoss``, :232). The AL family's semantic loss
(``cpgnet_criterion``, with ``lovasz_softmax``) reduces to scalars: inside
a data-parallel step, each rank's additive share of the joined batch's
(``parallel``: global counts, the Lovasz sort over the joined points)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from . import box_utils
from .common import true_div


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


def lovasz_grad(gt_sorted):
    """Gradient of the Jaccard loss's convex extension with respect to the
    sorted errors (Lovasz-Softmax, Berman et al.), along the last axis of
    the sorted 0 / 1 ground truth."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-9)
    if gt_sorted.shape[-1] > 1:
        jaccard = torch.cat([jaccard[..., :1],
                             jaccard[..., 1:] - jaccard[..., :-1]], -1)
    return jaccard


def lovasz_softmax(probs, labels, valid=None, classes='present'):
    """Flat Lovasz-softmax of (P, C) probabilities and (P,) int labels,
    all classes at once: an invalid point has zero error and sorts behind
    the valid ones, where it adds nothing. Each class's errors are sorted
    in descending order by a stable sort (``jnp.argsort(-err)``'s order):
    tied errors keep their point order, which decides each one's share of
    the gradient. ``classes`` 'present' averages over the classes with a
    foreground point, anything else over all.

    Inside a data-parallel step of more than one rank (the points
    frame-major, so the ranks' blocks in rank order are the joined order)
    the sort and ``lovasz_grad`` run over the joined points
    (``_joined_lovasz_weights``) and the rank's share is the sum over its
    own points of each error times its weight, over the joined batch's
    present classes: with the order fixed the term is linear in the
    errors, so the shares add up to the joined value and its gradient."""
    P, C = probs.shape
    if valid is None:
        valid = torch.ones(P, dtype=torch.bool, device=probs.device)
    fg = ((labels[None] == torch.arange(C, device=labels.device)[:, None])
          & valid).to(probs.dtype)
    err = (fg - probs.t()).abs() * valid
    if parallel.step_world() > 1:
        losses = (err * _joined_lovasz_weights(err, fg)).sum(1)
    else:
        order = torch.argsort(-err, dim=1, stable=True)
        losses = (err.gather(1, order) *
                  lovasz_grad(fg.gather(1, order))).sum(1)
    if classes == 'present':
        present = (parallel.global_sum(fg.sum(1)) > 0).to(probs.dtype)
        return (losses * present).sum() / present.sum().clamp(min=1.0)
    return losses.mean()


def _joined_lovasz_weights(err, fg):
    """(C, P) weights of this rank's points: ``lovasz_grad`` of the joined
    batch's ground truth in the stable descending order of its errors, at
    each point's place in that order. Ties keep the joined points' order,
    as the joined batch's sort does."""
    C, P = err.shape
    joined = parallel.gather_rows(torch.cat([err.t(), fg.t()], 1)).t()
    order = torch.argsort(-joined[:C], dim=1, stable=True)
    grad = lovasz_grad(joined[C:].gather(1, order))
    weights = torch.zeros_like(grad).scatter_(1, order, grad)
    own = parallel.step_rank()
    return weights[:, own * P:(own + 1) * P]


def cpgnet_criterion(logits, target, weight='dynamic-log', ignore=None,
                     classes='present', with_ls=True, valid=None):
    """The semantic-segmentation loss (``CPGNetCriterion``,
    ``loss_utils.py:157-203``): class-weighted softmax cross entropy
    normalised by the summed weights (as ``F.cross_entropy(weight=...)``)
    plus 2 x Lovasz-softmax. ``weight``: 'dynamic-log' (1 / (log(count + 1)
    / log(n + 1) + 1e-3) of each class's count among the n valid points),
    'dynamic' (1 / (count / n + 1e-3)) or a list a class; ``ignore``, the
    classes whose weight is 0.

    Args: logits (P, C); target (P,) int (clipped to [0, C - 1]); valid
    (P,) bool, the points that count.
    Inside a data-parallel step the class counts, n and the weight sum are
    the joined batch's (``parallel.global_sum``) and the Lovasz term is
    this rank's share (``lovasz_softmax``): each value is the rank's
    additive share of the joined batch's.

    Returns: {'loss_wce', 'loss_ls', 'loss'}.
    """
    P, C = logits.shape
    if valid is None:
        valid = torch.ones(P, dtype=torch.bool, device=logits.device)
    tgt = target.long().clamp(0, C - 1)
    onehot = F.one_hot(tgt, C).to(logits.dtype) * valid[:, None]
    if isinstance(weight, str) and weight.startswith('dynamic'):
        cnt = parallel.global_sum(onehot.sum(0))
        n = parallel.global_sum(valid.sum()).clamp(min=1).to(logits.dtype)
        freq = torch.log(cnt + 1) / torch.log(n + 1) \
            if weight == 'dynamic-log' else cnt / n
        w = 1.0 / (freq + 1e-3)
    else:
        w = torch.as_tensor(weight, dtype=logits.dtype, device=logits.device)
    if ignore:
        w = w.clone()
        w[list(ignore)] = 0.0
    per_pt_w = w[tgt] * valid
    ce = -(onehot * torch.log_softmax(logits, -1)).sum(-1)
    loss_wce = (ce * per_pt_w).sum() / \
        parallel.global_sum(per_pt_w.sum()).clamp(min=1e-9)
    loss_ls = lovasz_softmax(torch.softmax(logits, -1), tgt, valid,
                             classes) if with_ls else logits.new_zeros(())
    return {'loss_wce': loss_wce, 'loss_ls': loss_ls,
            'loss': loss_wce + 2.0 * loss_ls}


def sem_seg_loss(sem_pred, sem_labels, loss_weights, fg_only=False):
    """The AL family's per-point semantic loss (``ALNet.loss``, the head's
    SEM_TASK and USE_DET_FOR_SEM branches): ``cpgnet_criterion`` of the
    (B, N, C) logits against the (B, N) labels over the points labelled
    >= 0 (with ``fg_only``, > 0, the loss scaled by their share of the B N
    points; both the joined batch's in a data-parallel step), times
    LOSS_WEIGHTS' sem_weight (3.0); its class weights sem_cs_weight
    ('dynamic-log'), its ignored classes sem_ignore."""
    B, N, C = sem_pred.shape
    flat_t = sem_labels.reshape(B * N)
    valid = flat_t >= 0
    ratio = 1.0
    if fg_only:
        valid = valid & (flat_t > 0)
        ratio = true_div(parallel.global_sum(valid.sum()).to(sem_pred.dtype),
                         float(parallel.global_count(B * N)))
    out = cpgnet_criterion(
        sem_pred.reshape(B * N, C), flat_t,
        weight=loss_weights.get('sem_cs_weight', 'dynamic-log'),
        ignore=loss_weights.get('sem_ignore', None), valid=valid)
    return out['loss'] * ratio * float(loss_weights.get('sem_weight', 3.0))
