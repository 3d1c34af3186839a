"""CenterPoint's heatmap targets and focal loss, and the plain CenterHead.

Port of ``gaussian_radius``, ``assign_center_targets``,
``gaussian_focal_loss``, ``CenterHead`` and ``center_head_loss``
(``spsnet_tpu/models/dense_heads/center_head.py:23-248``; reference
``model_utils/centernet_utils.py`` and ``center_head.py``), batched over
frames, NCHW. The heatmap is the per-pixel, per-class maximum over dense
Gaussians, one a gt box, truncated at the CenterNet radius; the regression
targets are gathered at each box's centre pixel into ``num_max_objs``
slots with a mask. The plain ``CenterHead`` (all classes in one heatmap
group: PV-RCNN++, and a CenterPoint without CLASS_NAMES_EACH_HEAD) is a
shared 3 x 3 conv with ReLU and no BatchNorm, then the 'hm', 'center',
'center_z', 'dim' and 'rot' 3 x 3 convs; its decode is the global top-K
of the (pixel, class) pairs with no peak filter. The configs with head
groups build ``CenterHeadIoU`` (``center_head_iou.py``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.boxes import topk_desc
from ...parallel import global_sum
from ...utils.common import true_div


def gaussian_radius(height, width, min_overlap: float = 0.1):
    """CenterNet radius (``centernet_utils.py:9-35``), elementwise. The
    third root is divided by 2, not by 2 * a3, as in the reference (a
    CornerNet quirk that trained checkpoints saw)."""
    a1 = 1
    b1 = height + width
    c1 = true_div(width * height * (1 - min_overlap), 1 + min_overlap)
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
    coord_x = true_div(true_div(x - pcr[0], vs[0]), stride).clamp(0, W - 0.5)
    coord_y = true_div(true_div(y - pcr[1], vs[1]), stride).clamp(0, H - 0.5)
    cint_x = coord_x.to(torch.int64)
    cint_y = coord_y.to(torch.int64)

    dxm = true_div(true_div(gt_boxes[..., 3], vs[0]), stride)
    dym = true_div(true_div(gt_boxes[..., 4], vs[1]), stride)
    radius = gaussian_radius(dym, dxm, gaussian_overlap).to(
        torch.int64).clamp(min=min_radius)
    valid = (gt_boxes[..., 3] > 0) & (gt_boxes[..., 4] > 0)

    # dense Gaussians (B, H, W, T)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    ddx = xs - cint_x[:, None, None, :].float()
    ddy = ys - cint_y[:, None, None, :].float()
    sigma = true_div(2 * radius.float() + 1, 6.0)
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
    the sum over the number of positives, at least 1 (the joined batch's
    in a data-parallel step, ``parallel.global_sum``)."""
    pred = torch.sigmoid(pred_hm).clamp(eps, 1 - eps)
    pos = (gt_hm >= 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gt_hm, 4)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, 2) * pos
    neg_loss = torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights * \
        (1 - pos)
    num_pos = global_sum(pos.sum()).clamp(min=1.0)
    return -(pos_loss.sum() + neg_loss.sum()) / num_pos


# the plain CenterHead's regression maps, in the order of its loss
REG_MAPS = (('center', 2), ('center_z', 1), ('dim', 3), ('rot', 2))


class CenterHead(nn.Module):
    """Submodules ``shared`` (Conv2d, a ReLU after it), ``hm`` (a channel a
    class, its bias starting at -2.19, ``fixed_init``) and the regression
    convs ``center``, ``center_z``, ``dim`` and ``rot``, all 3 x 3 with a
    bias, as the flax module names them."""

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.feature_map_stride = int(
            model_cfg.TARGET_ASSIGNER_CONFIG.get('FEATURE_MAP_STRIDE', 2))
        self.voxel_size = [float(v) for v in np.float32(voxel_size)]
        self.pcr = [float(v) for v in np.float32(point_cloud_range)]
        ch = int(model_cfg.get('SHARED_CONV_CHANNEL', 64))
        self.shared = nn.Conv2d(input_channels, ch, 3, padding=1)
        self.hm = nn.Conv2d(ch, num_class, 3, padding=1)
        for name, out in REG_MAPS:
            self.add_module(name, nn.Conv2d(ch, out, 3, padding=1))
        post = model_cfg.get('POST_CONFIG', None)
        self.max_obj = int(post.get('MAX_OBJ_PER_SAMPLE', 500)) if post \
            else 500

    @torch.no_grad()
    def fixed_init(self):
        self.hm.bias.fill_(-2.19)

    def forward(self, batch):
        """'spatial_features_2d' (B, C, H, W) -> adds 'center_head_ret' (the
        NCHW maps 'heatmap' and REG_MAPS; in training with 'gt_boxes'
        'heatmap_target', 'box_targets', 'inds' and 'masks'), the top-K
        boxes 'batch_box_preds' (B, K, 7), 'batch_cls_preds' (B, K,
        num_class) holding each box's score at its class and 0 elsewhere,
        and 'cls_preds_normalized' True."""
        x = torch.relu(self.shared(batch['spatial_features_2d']))
        ret = {'heatmap': self.hm(x)}
        for name, _ in REG_MAPS:
            ret[name] = getattr(self, name)(x)
        B, C, H, W = ret['heatmap'].shape
        if self.training and 'gt_boxes' in batch:
            tac = self.model_cfg.TARGET_ASSIGNER_CONFIG
            hm_t, boxes_t, inds_t, mask_t, _ = assign_center_targets(
                batch['gt_boxes'], self.num_class, (W, H),
                self.feature_map_stride, self.voxel_size, self.pcr,
                num_max_objs=int(tac.get('NUM_MAX_OBJS', 500)),
                gaussian_overlap=float(tac.get('GAUSSIAN_OVERLAP', 0.1)),
                min_radius=int(tac.get('MIN_RADIUS', 2)))
            ret.update(heatmap_target=hm_t, box_targets=boxes_t, inds=inds_t,
                       masks=mask_t)
        scores, top = topk_desc(_flat(torch.sigmoid(ret['heatmap'])).reshape(
            B, H * W * C), min(self.max_obj, H * W * C))
        cls_id, pix = top % C, top // C

        def at(name):
            m = _flat(ret[name])
            return m.gather(1, pix[..., None].expand(-1, -1, m.shape[-1]))
        c_off, dims, rots = at('center'), torch.exp(at('dim')), at('rot')
        s = self.feature_map_stride
        xs = ((pix % W).float() + c_off[..., 0]) * s * self.voxel_size[0] + \
            self.pcr[0]
        ys = ((pix // W).float() + c_off[..., 1]) * s * self.voxel_size[1] + \
            self.pcr[1]
        boxes = torch.stack([xs, ys, at('center_z')[..., 0], dims[..., 0],
                             dims[..., 1], dims[..., 2],
                             torch.atan2(rots[..., 1], rots[..., 0])], -1)
        one_hot = torch.nn.functional.one_hot(cls_id, C) > 0
        return dict(batch, center_head_ret=ret, batch_box_preds=boxes,
                    batch_cls_preds=torch.where(one_hot, scores[..., None],
                                                0.0),
                    cls_preds_normalized=True)


def _flat(m):
    """(B, C, H, W) -> (B, H * W, C), pixel y * W + x."""
    return m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, m.shape[1])


def center_head_loss(ret, loss_cfg):
    """(loss, tb) of the plain CenterHead: the focal heatmap loss times
    cls_weight, plus the masked L1 of the 8 regression channels at the
    centre pixels, weighted by code_weights, over the gt count (at least
    1; the joined batch's in a data-parallel step) times loc_weight; tb
    'hm_loss', 'loc_loss', 'center_loss'."""
    lw = loss_cfg.LOSS_WEIGHTS
    hm_loss = gaussian_focal_loss(ret['heatmap'], ret['heatmap_target']) * \
        lw.get('cls_weight', 1.0)
    preds = _flat(torch.cat([ret[name] for name, _ in REG_MAPS], dim=1))
    at_inds = preds.gather(1, ret['inds'][..., None].expand(-1, -1, 8))
    mask = ret['masks'].to(preds.dtype)[..., None]
    code_w = preds.new_tensor(list(lw.get('code_weights', [1.0] * 8))[:8])
    l1 = (at_inds - ret['box_targets'][..., :8]).abs() * mask * code_w
    loc_loss = l1.sum() / global_sum(mask.sum()).clamp(min=1.0) * \
        lw.get('loc_weight', 2.0)
    total = hm_loss + loc_loss
    return total, {'hm_loss': hm_loss, 'loc_loss': loc_loss,
                   'center_loss': total}
