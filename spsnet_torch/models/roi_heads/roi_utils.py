"""RoI target sampling and RoI point pooling.

Port of ``spsnet_tpu/models/roi_heads/roi_utils.py`` (reference
``roi_heads/target_assigner/proposal_target_layer.py``,
``roi_head_template.py:104-137`` and ``roipoint_pool3d_kernel.cu:38-103``):
each RoI's best gt of its own class by exact 3D IoU, the fixed-shape
foreground / hard / easy subsampling, the labels and the gt moved into each
sampled RoI's frame; and the first ``num_sampled_points`` points inside
each (enlarged) RoI. Plain PyTorch on every device, as the JAX package
computes them outside any Pallas kernel.

The random numbers of the subsampling are drawn apart from it
(``draw_roi_sampling``, from an explicit CPU generator), so the card and
the CPU see the same draws and a test can hand in the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ... import ops
from ...ops.grouping import first_k_hits
from ...parallel import draw_rows
from ...utils import box_utils
from ...utils.common import rotate_points_along_z, to_device

# the upper end (exclusive) of the integer draws, as ``jax.random.randint(
# key, (M,), 0, 2 ** 30)`` in the JAX package
DRAW_HIGH = 2 ** 30


class RoiDraws(NamedTuple):
    rand: torch.Tensor      # (B, R) float32 uniforms in [0, 1)
    fg_hard: torch.Tensor   # (B, M) int64 in [0, 2^30): fg and hard draws
    easy: torch.Tensor      # (B, M) int64 in [0, 2^30): easy draws


class RoiTargets(NamedTuple):
    rois: torch.Tensor              # (B, M, 7)
    roi_labels: torch.Tensor        # (B, M) int64
    roi_scores: torch.Tensor        # (B, M)
    gt_of_rois: torch.Tensor        # (B, M, 8) gt in each RoI's frame
    gt_of_rois_src: torch.Tensor    # (B, M, 8) gt in the lidar frame
    gt_iou_of_rois: torch.Tensor    # (B, M)
    reg_valid_mask: torch.Tensor    # (B, M) bool
    rcnn_cls_labels: torch.Tensor   # (B, M) float (-1 = ignored)
    sampled: torch.Tensor           # (B, M) int64 indices into the RoI axis


def draw_roi_sampling(generator: torch.Generator, B: int, R: int, M: int,
                      device) -> RoiDraws:
    """The random numbers of ``subsample_rois`` for B frames of R RoIs, M
    sampled a frame, drawn from ``generator`` (a CPU ``torch.Generator``)
    and copied to ``device`` without a stream sync. The JAX package draws
    them per frame from ``split(key, 3)`` (``roi_utils.py:71-72,100,106``):
    the same roles, other bits. In a data-parallel step each of the three
    is the joined batch's draw, of which this rank keeps its frames
    (``parallel.draw_rows``)."""
    def uniform(shape, g):
        return torch.rand(shape, generator=g)

    def integers(shape, g):
        return torch.randint(0, DRAW_HIGH, shape, generator=g)
    rand = draw_rows(uniform, (B, R), generator)
    fg_hard = draw_rows(integers, (B, M), generator)
    easy = draw_rows(integers, (B, M), generator)
    return RoiDraws(*(to_device(t, device) for t in (rand, fg_hard, easy)))


def max_iou_with_same_class(rois, roi_labels, gt_boxes):
    """(..., R, 7) RoIs, (..., R) labels, (..., T, 8) gt -> (max_iou (...,
    R) clipped at 0, gt_idx (..., R)): the best 3D IoU with a gt of the
    RoI's own class, the first such gt on ties; padding gt (dx == 0) never
    matches (``ProposalTargetLayer.get_max_iou_with_same_class``)."""
    iou = ops.boxes_iou3d(rois, gt_boxes[..., :7])               # (..., R, T)
    same = roi_labels[..., :, None] == gt_boxes[..., None, :, 7].long()
    valid = gt_boxes[..., None, :, 3] > 0
    iou = torch.where(same & valid, iou, -1.0)
    max_iou = iou.amax(dim=-1)
    # torch.max promises no index among equal maxima: the first, as argmax
    first = (iou == max_iou[..., None]).to(torch.uint8).argmax(dim=-1)
    return max_iou.clamp(min=0.0), first


def subsample_rois(max_overlaps, roi_valid, draws: RoiDraws, cfg):
    """(..., R) max IoUs and valid mask, the frames' ``draws`` -> (..., M)
    int64 indices into the RoI axis (``ProposalTargetLayer.subsample_rois``
    in the JAX package's fixed-shape form, ``roi_utils.py:56-121``).

    The first min(#fg, FG_RATIO M) slots hold the foreground RoIs (IoU >=
    min(REG_FG_THRESH, CLS_FG_THRESH)) in a random order, further fg slots
    fg drawn with replacement; the rest background, HARD_BG_RATIO of it
    hard (CLS_BG_THRESH_LO <= IoU < REG_FG_THRESH) and the rest easy, both
    drawn with replacement. Without background every slot is fg; with
    only hard or only easy background, that kind fills the background."""
    M = int(cfg.ROI_PER_IMAGE)
    fg_quota = int(np.round(cfg.FG_RATIO * M))
    fg_thresh = min(float(cfg.REG_FG_THRESH), float(cfg.CLS_FG_THRESH))
    lo = float(cfg.CLS_BG_THRESH_LO)
    R = max_overlaps.shape[-1]
    rand = draws.rand

    fg = (max_overlaps >= fg_thresh) & roi_valid
    easy = (max_overlaps < lo) & roi_valid
    hard = (max_overlaps < float(cfg.REG_FG_THRESH)) & \
        (max_overlaps >= lo) & roi_valid
    n_fg, n_easy, n_hard = (m.sum(dim=-1, keepdim=True)
                            for m in (fg, easy, hard))
    n_bg = n_easy + n_hard

    def pool(mask):
        # members first, each group in the order of its draws
        return torch.argsort(torch.where(mask, rand, 2.0 + rand), dim=-1,
                             stable=True)

    n_fg_sel = torch.where(n_bg == 0, torch.where(n_fg > 0, M, 0),
                           n_fg.clamp(max=fg_quota))
    bg_needed = M - n_fg_sel
    n_hard_sel = torch.where(
        (n_hard > 0) & (n_easy > 0),
        torch.minimum((bg_needed * float(cfg.HARD_BG_RATIO)).long(),
                      bg_needed),
        torch.where(n_hard > 0, bg_needed, 0))

    slots = torch.arange(M, device=max_overlaps.device)
    fg_draw = torch.where(slots < n_fg.clamp(max=fg_quota), slots,
                          draws.fg_hard % n_fg.clamp(min=1))
    hard_draw = draws.fg_hard % n_hard.clamp(min=1)
    easy_draw = draws.easy % n_easy.clamp(min=1)

    def take(mask, draw):
        return pool(mask).gather(-1, draw.clamp(0, R - 1))

    in_fg = slots < n_fg_sel
    in_hard = (slots >= n_fg_sel) & (slots < n_fg_sel + n_hard_sel)
    return torch.where(in_fg, take(fg, fg_draw),
                       torch.where(in_hard, take(hard, hard_draw),
                                   take(easy, easy_draw)))


def _gather(t, idx):
    """(B, R, ...) gathered along the RoI axis by (B, M) -> (B, M, ...)."""
    return t.gather(1, idx.reshape(*idx.shape, *[1] * (t.dim() - 2)).expand(
        *idx.shape, *t.shape[2:]))


def proposal_target_layer(draws: RoiDraws, rois, roi_scores, roi_labels,
                          roi_valid, gt_boxes, cfg) -> RoiTargets:
    """RoI targets of B frames (``spsnet_tpu/models/roi_heads/roi_utils.py:
    124-167``): (B, R, 7) RoIs with their scores, labels and valid mask,
    (B, T, 8) gt -> the ``subsample_rois`` RoIs, their gt, labels and the
    gt in each RoI's frame with the heading flipped into [-pi/2, pi/2].
    Labels: 'cls' gives 1 above CLS_FG_THRESH, 0 at or below
    CLS_BG_THRESH, -1 (ignored) between; 'roi_iou' the IoU scaled
    linearly from CLS_BG_THRESH to CLS_FG_THRESH, clipped to [0, 1]. The
    RoIs keep their gradient, as in the JAX package."""
    max_iou, gt_idx = max_iou_with_same_class(rois[..., :7], roi_labels,
                                              gt_boxes)
    sel = subsample_rois(max_iou, roi_valid, draws, cfg)
    srois, slabels, sscores = (_gather(t, sel)
                               for t in (rois, roi_labels, roi_scores))
    sgt = _gather(gt_boxes, gt_idx.gather(1, sel))
    sious = max_iou.gather(1, sel)

    reg_valid = sious > float(cfg.REG_FG_THRESH)
    bg_t, fg_t = float(cfg.CLS_BG_THRESH), float(cfg.CLS_FG_THRESH)
    if cfg.CLS_SCORE_TYPE == 'cls':
        cls_labels = (sious > fg_t).float()
        cls_labels = torch.where((sious > bg_t) & (sious < fg_t), -1.0,
                                 cls_labels)
    elif cfg.CLS_SCORE_TYPE == 'roi_iou':
        cls_labels = ((sious - bg_t) / (fg_t - bg_t)).clamp(0.0, 1.0)
    else:
        raise NotImplementedError(cfg.CLS_SCORE_TYPE)

    # the gt in each RoI's frame: moved by minus its center, turned by
    # minus its heading
    roi_ry = srois[..., 6] % (2 * np.pi)
    B, M, _ = sgt.shape
    xyz = rotate_points_along_z(
        (sgt[..., 0:3] - srois[..., 0:3]).reshape(B * M, 1, 3),
        -roi_ry.reshape(B * M)).reshape(B, M, 3)
    heading = (sgt[..., 6] - roi_ry) % (2 * np.pi)
    opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
    heading = torch.where(opposite, (heading + np.pi) % (2 * np.pi), heading)
    heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)
    heading = heading.clamp(-np.pi / 2, np.pi / 2)
    gt_ct = torch.cat([xyz, sgt[..., 3:6], heading[..., None], sgt[..., 7:]],
                      dim=-1)
    return RoiTargets(rois=srois, roi_labels=slabels, roi_scores=sscores,
                      gt_of_rois=gt_ct, gt_of_rois_src=sgt,
                      gt_iou_of_rois=sious, reg_valid_mask=reg_valid,
                      rcnn_cls_labels=cls_labels, sampled=sel)


def roi_point_indices(points, rois, num_sampled_points=512,
                      pool_extra_width=(0.0, 0.0, 0.0)):
    """(B, N, 3) points, (B, R, 7) RoIs -> (idx (B, R, S) int64: the first
    S points inside each RoI enlarged by ``pool_extra_width``, in index
    order, slots past the last hit holding the first hit (0 for none);
    empty (B, R) bool: RoIs with no point inside). A RoI of zero length
    never holds a point."""
    ext = box_utils.enlarge_box3d(rois, pool_extra_width)
    local = box_utils.points_to_box_local(points, ext)        # (B, N, R, 3)
    inside = box_utils.in_canonical_box(local, ext[..., None, :, 3:6])
    inside = (inside & (ext[..., None, :, 3] > 0)).transpose(1, 2)
    return first_k_hits(inside, num_sampled_points), ~inside.any(dim=-1)


def roipoint_pool3d(points, point_features, rois, num_sampled_points=512,
                    pool_extra_width=(0.0, 0.0, 0.0)):
    """Pool a fixed number of in-box points per RoI.

    Args:
        points: (B, N, 3); point_features: (B, N, C); rois: (B, R, 7).
    Returns:
        pooled: (B, R, S, 3 + C), raw xyz and features of the
            ``roi_point_indices``;
        empty: (B, R) bool, RoIs with no point inside (their slots hold
            point 0; the caller zeroes them).
    """
    idx, empty = roi_point_indices(points, rois, num_sampled_points,
                                   pool_extra_width)
    full = torch.cat([points, point_features], dim=-1)
    B, R, S = idx.shape
    pooled = full.gather(1, idx.reshape(B, R * S, 1).expand(
        -1, -1, full.shape[-1]))
    return pooled.reshape(B, R, S, full.shape[-1]), empty
