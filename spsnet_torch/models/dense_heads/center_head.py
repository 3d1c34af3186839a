"""CenterPoint's heatmap targets and focal loss.

Port of ``gaussian_radius``, ``assign_center_targets`` and
``gaussian_focal_loss`` (``spsnet_tpu/models/dense_heads/center_head.py:
23-127``; reference ``model_utils/centernet_utils.py`` and
``center_head.py assign_target_of_single_head``), batched over frames.
The heatmap is the per-pixel, per-class maximum over dense Gaussians, one a
gt box, truncated at the CenterNet radius; the regression targets are
gathered at each box's centre pixel into ``num_max_objs`` slots with a mask.
The plain ``CenterHead`` and its loss (PV-RCNN++ only) wait for ROADMAP
Queue 1 item F4; the CenterPoint configs build ``CenterHeadIoU``
(``center_head_iou.py``).
"""
from __future__ import annotations

import torch


def _div(a, b: float):
    """``a / b`` with ``b`` a tensor on ``a``'s device: a CUDA kernel
    takes a host scalar divisor as a product with its reciprocal, which
    rounds otherwise than the true quotient of the CPU and the JAX
    package (the heatmap targets must agree bit for bit)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def gaussian_radius(height, width, min_overlap: float = 0.1):
    """CenterNet radius (``centernet_utils.py:9-35``), elementwise. The
    third root is divided by 2, not by 2 * a3, as in the reference (a
    CornerNet quirk that trained checkpoints saw)."""
    a1 = 1
    b1 = height + width
    c1 = _div(width * height * (1 - min_overlap), 1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * a1 * c1).clamp(min=0))) / 2
    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt((b2 ** 2 - 4 * a2 * c2).clamp(min=0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def gaussian(d2, sigma):
    """exp(-d2 / (2 sigma^2)): the fp32 argument as the JAX package forms
    it, its exp taken in float64 and rounded to fp32. Every fp32 exp
    (XLA:CPU's, torch's on the CPU and on the card) differs from the
    correctly rounded value by an ulp on some inputs, each library on
    others; the float64 route gives the card and the CPU the same bits
    and the JAX package's within an ulp."""
    arg = -d2 / (2 * sigma ** 2)
    return torch.exp(arg.double()).float()


def assign_center_targets(gt_boxes, num_classes: int, feature_map_size,
                          feature_map_stride: int, voxel_size,
                          point_cloud_range, num_max_objs: int = 500,
                          gaussian_overlap: float = 0.1,
                          min_radius: int = 2):
    """Targets of one head group for every frame.

    Args:
        gt_boxes: (B, T, 8) zero-padded [x, y, z, dx, dy, dz, heading,
            class], or (B, T, 10) with the velocity (vx, vy) before the
            class (nuScenes); classes 1..num_classes;
        feature_map_size: (W, H) of the BEV map.
    Returns:
        heatmap (B, num_classes, H, W), boxes (B, num_max_objs, 8, or 10
        with the velocity targets), inds (B, num_max_objs) int64 centre
        pixels y * W + x, mask (B, num_max_objs) int32, gt_raw (B,
        num_max_objs, 7): each slot's raw gt box (the IoU target of
        ``CenterHeadIoU``). Slot t holds gt box t; slots of padded boxes
        or past T are zero.
    """
    W, H = int(feature_map_size[0]), int(feature_map_size[1])
    B, T, width = gt_boxes.shape
    dev = gt_boxes.device
    vs = [float(v) for v in voxel_size]
    pcr = [float(v) for v in point_cloud_range]
    stride = int(feature_map_stride)
    x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
    coord_x = _div(_div(x - pcr[0], vs[0]), stride).clamp(0, W - 0.5)
    coord_y = _div(_div(y - pcr[1], vs[1]), stride).clamp(0, H - 0.5)
    cint_x = coord_x.to(torch.int64)
    cint_y = coord_y.to(torch.int64)

    dxm = _div(_div(gt_boxes[..., 3], vs[0]), stride)
    dym = _div(_div(gt_boxes[..., 4], vs[1]), stride)
    radius = gaussian_radius(dym, dxm, gaussian_overlap).to(
        torch.int64).clamp(min=min_radius)
    valid = (gt_boxes[..., 3] > 0) & (gt_boxes[..., 4] > 0)

    # dense Gaussians (B, H, W, T)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    ddx = xs - cint_x[:, None, None, :].float()
    ddy = ys - cint_y[:, None, None, :].float()
    sigma = _div(2 * radius.float() + 1, 6.0)
    g = gaussian(ddx ** 2 + ddy ** 2, sigma[:, None, None, :])
    r = radius[:, None, None, :]
    inside = (ddx.abs() <= r) & (ddy.abs() <= r) & valid[:, None, None, :]
    g = torch.where(inside, g, 0.0)
    cls_idx = (gt_boxes[..., -1].to(torch.int64) - 1).clamp(0,
                                                            num_classes - 1)
    # per pixel and class the maximum over the class's boxes
    heatmap = torch.stack([
        torch.where((cls_idx == c)[:, None, None, :], g, 0.0).amax(dim=-1)
        for c in range(num_classes)], dim=1)

    M = int(num_max_objs)
    slots = torch.arange(M, device=dev)
    take = slots.clamp(0, T - 1)[None].expand(B, -1)
    sl_valid = (slots < T)[None] & valid.gather(1, take)

    def at(t):
        return t.gather(1, take)
    dims = gt_boxes[..., 3:6].gather(1, take[..., None].expand(-1, -1, 3))
    heading = at(gt_boxes[..., 6])
    cols = [at(coord_x) - at(cint_x).float(), at(coord_y) - at(cint_y).float(),
            at(z)]
    boxes = torch.cat([torch.stack(cols, -1), torch.log(dims.clamp(min=1e-6)),
                       torch.cos(heading)[..., None],
                       torch.sin(heading)[..., None]], dim=-1)
    if width > 8:
        boxes = torch.cat([boxes, gt_boxes[..., 7:9].gather(
            1, take[..., None].expand(-1, -1, 2))], dim=-1)
    boxes = torch.where(sl_valid[..., None], boxes, 0.0)
    inds = torch.where(sl_valid, at(cint_y) * W + at(cint_x), 0)
    gt_raw = torch.where(sl_valid[..., None], gt_boxes[..., :7].gather(
        1, take[..., None].expand(-1, -1, 7)), 0.0)
    return heatmap, boxes, inds, sl_valid.to(torch.int32), gt_raw


def gaussian_focal_loss(pred_hm, gt_hm, eps: float = 1e-4):
    """Penalty-reduced focal loss over (B, C, H, W) logits and heatmap
    targets (``centernet_utils.neg_loss_cornernet``): the positives are the
    heatmap's peaks (value 1), the negatives weighted by (1 - target)^4;
    the sum over the number of positives, at least 1."""
    pred = torch.sigmoid(pred_hm).clamp(eps, 1 - eps)
    pos = (gt_hm >= 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gt_hm, 4)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, 2) * pos
    neg_loss = torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights * \
        (1 - pos)
    num_pos = pos.sum().clamp(min=1.0)
    return -(pos_loss.sum() + neg_loss.sum()) / num_pos
