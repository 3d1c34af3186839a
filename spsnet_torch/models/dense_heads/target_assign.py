"""Batched, masked point-to-box target assignment.

Port of ``spsnet_tpu/models/dense_heads/target_assign.py`` (the dense form
of ``IASSD_Head.assign_stack_targets_IASSD``, ``IASSD_head.py:124-236``):
every frame at once as (B, M) tensors with masks, no ragged gathers.

Box layout: gt_boxes (B, T, 8) = [x, y, z, dx, dy, dz, heading, class],
zero rows are padding (class 0).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ... import ops
from ...utils import common


class PointTargets(NamedTuple):
    cls_labels: torch.Tensor          # (B, M) int64: 0 bg, -1 ignored, c>0 fg
    box_idxs: torch.Tensor            # (B, M) int64 box index or -1
    gt_box_of_points: torch.Tensor    # (B, M, 8) containing box (zeros if none)
    fg_mask: torch.Tensor             # (B, M) bool
    box_labels: Optional[torch.Tensor] = None  # (B, M, 8) encoded or None


def _gather_boxes(gt_boxes, idx):
    """(B, T, 8) gathered by (B, M) clamp(idx, 0) -> (B, M, 8)."""
    safe = idx.clamp(min=0)
    return gt_boxes.gather(
        1, safe[..., None].expand(-1, -1, gt_boxes.shape[-1]))


def assign_targets_iassd(points, gt_boxes, extend_gt_boxes=None,
                         set_ignore_flag=True, use_ex_gt_assign=False,
                         fg_pc_ignore=False, ret_box_labels=False,
                         box_coder=None, num_class=3, binary_label=False):
    """(B, M, 3) points, (B, T, 8) gt boxes, (B, T, 8) enlarged boxes or
    None -> ``PointTargets``. Variants, as ``assign_stack_targets_IASSD``:

    - ``set_ignore_flag``: fg from the exact boxes; points only inside an
      enlarged box get label -1 (``IASSD_head.py:193-200``);
    - ``use_ex_gt_assign``: fg from the enlarged boxes, points inside an
      exact box keep its index (``:172-186``); with ``fg_pc_ignore`` the
      exact-box interior is ignored instead;
    - neither: fg from the exact boxes.
    """
    box_idxs = ops.points_in_boxes(points, gt_boxes[..., :7])
    box_fg = box_idxs >= 0
    if use_ex_gt_assign:
        ext_idxs = ops.points_in_boxes(points, extend_gt_boxes[..., :7])
        ext_fg = ext_idxs >= 0
        merged = torch.where(box_fg, box_idxs, ext_idxs)
        if fg_pc_ignore:
            fg = ext_fg ^ box_fg
            merged = torch.where(box_fg, -1, merged)
        else:
            fg = ext_fg
        box_idxs = merged
        ignore = torch.zeros_like(fg)
    elif set_ignore_flag:
        ext_idxs = ops.points_in_boxes(points, extend_gt_boxes[..., :7])
        fg = box_fg
        ignore = (ext_idxs >= 0) & ~fg
    else:
        fg = box_fg
        ignore = torch.zeros_like(fg)

    gt_of_points = _gather_boxes(gt_boxes, box_idxs)
    gt_cls = gt_of_points[..., 7].long()
    fg_label = torch.ones_like(gt_cls) if num_class == 1 or binary_label \
        else gt_cls
    cls_labels = torch.where(fg, fg_label, 0)
    cls_labels = torch.where(ignore, -1, cls_labels)
    # a fg point whose box has class 0 (degenerate) becomes bg, as the
    # reference's `fg_flag = fg_flag ^ (fg_flag & bg_flag)`
    fg = fg & (cls_labels > 0)

    box_labels = None
    if ret_box_labels:
        enc = box_coder.encode(gt_of_points[..., :7], points,
                               gt_classes=gt_cls)
        box_labels = torch.where(fg[..., None], enc, 0.0)
    gt_of_points = torch.where(fg[..., None], gt_of_points, 0.0)
    return PointTargets(cls_labels=cls_labels, box_idxs=box_idxs,
                        gt_box_of_points=gt_of_points, fg_mask=fg,
                        box_labels=box_labels)


def centerness_mask(points, cls_labels, gt_box_of_points, fg_mask):
    """Per-point centerness in its containing box (``IASSD_head.py:626-649``):
    the cube root of the product over x, y, z of min/max distance to the two
    faces, clamped at 1e-6; zero off the foreground. (B, M) float."""
    boxes = gt_box_of_points
    offset = points - boxes[..., 0:3]
    B, M, _ = offset.shape
    canonical = common.rotate_points_along_z(
        offset.reshape(B * M, 1, 3), -boxes[..., 6].reshape(B * M))
    canonical = canonical.reshape(B, M, 3)
    half = boxes[..., 3:6] / 2.0
    dist_plus = half - canonical
    dist_minus = half + canonical
    dmin = torch.minimum(dist_plus, dist_minus)
    dmax = torch.maximum(dist_plus, dist_minus)
    ratio = dmin / torch.where(dmax.abs() > 1e-12, dmax, 1e-12)
    centerness = ratio[..., 0] * ratio[..., 1] * ratio[..., 2]
    centerness = centerness.clamp(min=1e-6) ** (1.0 / 3.0)
    return torch.where(fg_mask, centerness, 0.0)
