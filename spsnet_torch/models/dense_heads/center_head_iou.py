"""CenterHeadIoU: the multi-group CenterPoint head, with the IoU-rectified
score of the fork's head, and its loss.

Port of ``spsnet_tpu/models/dense_heads/center_head_iou.py`` (reference
``dense_heads/center_head.py`` and the fork's ``center_head_iou.py``),
NCHW. A shared 3 x 3 conv with BatchNorm and ReLU, then one
``SeparateHead`` a group of CLASS_NAMES_EACH_HEAD: a heatmap with a
channel a class of the group and the HEAD_DICT regression maps. In
training with 'gt_boxes' each group gets its Gaussian heatmap and centre
targets (``center_head.assign_center_targets``) over its own classes,
relabelled 1..G. The decode has the JAX package's two protocols, both of
fixed shape:

- NAME 'CenterHead' (every CenterPoint config of the zoo): the top
  MAX_OBJ_PER_SAMPLE of the (pixel, class) pairs of a group, no peak
  filter, and class-agnostic NMS a group (``agnostic_nms``);
- NAME 'CenterHeadIoU': one candidate a pixel (its best class), the top
  NMS_PRE_MAXSIZE pixels, and per POST_PROCESSING.NMS_CONFIG.NMS_NAME
  ``class_specific_nms`` (an NMS and its own output slots a class) or
  ``agnostic_nms``.

Every score is rectified as score^(1 - r) * iou^r (r from RECTIFIER by
class; iou from the 'iou' map when the head has one, else 1), candidates
outside POST_CENTER_LIMIT_RANGE or at most SCORE_THRESH are invalid, and
each NMS runs ``ops.nms_bev`` with that valid mask. Every top-k takes the
lowest index first among equal scores (``ops.boxes.topk_desc``), as
``jax.lax.top_k`` does. The head's output is the detections
('final_boxes', 'final_scores', 'final_labels', 'final_valid'); a
two-stage detector takes 'batch_box_preds' and 'batch_cls_preds' as its
proposals.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ... import ops
from ...ops.boxes import topk_desc
from ...parallel import global_sum
from ..blocks import BatchNormNCHW
from .center_head import assign_center_targets, gaussian_focal_loss


def _conv(c_in: int, c_out: int, bias: bool):
    return nn.Conv2d(c_in, c_out, 3, padding=1, bias=bias)


class SeparateHead(nn.Module):
    """One conv stack an output, as the reference's: ``{name}.{k}`` is
    (Conv2d, BatchNorm, ReLU) for k < num_conv - 1, ``{name}.{num_conv -
    1}`` the biased output Conv2d. The stacks are created in sorted order
    of their names, as the flax module creates them. The heatmap's output
    bias starts at ``init_bias`` (``fixed_init``)."""

    def __init__(self, head_dict, shared_channels: int,
                 use_bias: bool = False, init_bias: float = -2.19):
        super().__init__()
        self.names = sorted(head_dict)
        self.init_bias = float(init_bias)
        for name in self.names:
            ch, num_conv = head_dict[name]
            layers = [nn.Sequential(
                _conv(shared_channels, shared_channels, use_bias),
                BatchNormNCHW(shared_channels), nn.ReLU())
                for _ in range(int(num_conv) - 1)]
            layers.append(_conv(shared_channels, int(ch), True))
            self.add_module(name, nn.Sequential(*layers))

    @torch.no_grad()
    def fixed_init(self):
        if 'hm' in self.names:
            self.hm[-1].bias.fill_(self.init_bias)

    def forward(self, x):
        return {name: getattr(self, name)(x) for name in self.names}


def _flat(m):
    """(B, C, H, W) -> (B, H * W, C), pixel y * W + x."""
    return m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, m.shape[1])


def _gather(m, pix):
    """(B, C, H, W) map at (B, K) flat pixels -> (B, K, C)."""
    flat = _flat(m)
    return flat.gather(1, pix[..., None].expand(-1, -1, flat.shape[-1]))


class CenterHeadIoU(nn.Module):
    """Submodules ``shared_conv`` (Conv2d, BatchNorm, ReLU) and
    ``heads_list.{g}``, as the reference's. ``class_names`` maps
    CLASS_NAMES_EACH_HEAD to class ids; ``train_decode`` keeps the decode
    in training, where a two-stage detector takes its boxes as proposals
    (CenterPoint's train step leaves it out: the JAX train step computes
    it, and XLA drops it as unused)."""

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, class_names=None,
                 train_decode: bool = True):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.train_decode = train_decode
        self.feature_map_stride = int(
            cfg.TARGET_ASSIGNER_CONFIG.get('FEATURE_MAP_STRIDE', 4))
        self.voxel_size = [float(v) for v in np.float32(voxel_size)]
        self.pcr = [float(v) for v in np.float32(point_cloud_range)]
        shared_ch = int(cfg.get('SHARED_CONV_CHANNEL', 64))
        use_bias = bool(cfg.get('USE_BIAS_BEFORE_NORM', False))
        names = list(class_names) if class_names is not None else \
            [str(i + 1) for i in range(num_class)]
        self.class_ids_each_head = tuple(
            tuple(names.index(n) for n in head if n in names)
            for head in cfg.CLASS_NAMES_EACH_HEAD)
        self.shared_conv = nn.Sequential(
            _conv(input_channels, shared_ch, use_bias),
            BatchNormNCHW(shared_ch), nn.ReLU())
        head_dict = {k: (int(v['out_channels']), int(v['num_conv']))
                     for k, v in dict(cfg.SEPARATE_HEAD_CFG.HEAD_DICT).items()}
        num_hm_conv = int(cfg.get('NUM_HM_CONV', 2))
        self.heads_list = nn.ModuleList(
            SeparateHead(dict(head_dict, hm=(len(ids), num_hm_conv)),
                         shared_ch, use_bias)
            for ids in self.class_ids_each_head)
        self.head_order = tuple(cfg.SEPARATE_HEAD_CFG.HEAD_ORDER)
        # each group's global class ids and its remap of 1-based global
        # labels to 1..G (-1: not in the group); the decode's settings
        for g, ids in enumerate(self.class_ids_each_head):
            remap = np.full(num_class + 1, -1, np.int64)
            remap[np.asarray(ids, np.int64) + 1] = np.arange(1, len(ids) + 1)
            self.register_buffer(f'ids_{g}', torch.tensor(ids,
                                                          dtype=torch.int64),
                                 persistent=False)
            self.register_buffer(f'remap_{g}', torch.from_numpy(remap),
                                 persistent=False)
        pp = cfg.POST_PROCESSING
        self.register_buffer('rectifier', torch.from_numpy(np.asarray(
            pp.get('RECTIFIER', 0.0), np.float32).reshape(-1)),
            persistent=False)
        self.register_buffer('post_range', torch.from_numpy(np.asarray(
            pp.get('POST_CENTER_LIMIT_RANGE',
                   [-1e9, -1e9, -1e9, 1e9, 1e9, 1e9]), np.float32)),
            persistent=False)

    def decode_at(self, pred, pix):
        """The boxes (B, K, 7, or 9 with 'vel') of the maps at (B, K) flat
        pixels: centre offset and height, the sizes exp of the 'dim' map
        clipped to [-10, 10], the heading atan2 of the 'rot' pair."""
        W = pred['center'].shape[-1]
        c_off = _gather(pred['center'], pix)
        c_z = _gather(pred['center_z'], pix)[..., 0]
        dims = torch.exp(_gather(pred['dim'], pix).clamp(-10.0, 10.0))
        rots = _gather(pred['rot'], pix)
        angle = torch.atan2(rots[..., 1], rots[..., 0])
        px = (pix % W).float()
        py = (pix // W).float()
        s = self.feature_map_stride
        xs = (px + c_off[..., 0]) * s * self.voxel_size[0] + self.pcr[0]
        ys = (py + c_off[..., 1]) * s * self.voxel_size[1] + self.pcr[1]
        out = torch.stack([xs, ys, c_z, dims[..., 0], dims[..., 1],
                           dims[..., 2], angle], dim=-1)
        if 'vel' in pred:
            out = torch.cat([out, _gather(pred['vel'], pix)], dim=-1)
        return out

    def assign_targets(self, gt_boxes, H: int, W: int):
        """Each group's targets: only its classes kept, relabelled 1..G
        (the class is the last gt column)."""
        tac = self.model_cfg.TARGET_ASSIGNER_CONFIG
        lbl = gt_boxes[..., -1].to(torch.int64).clamp(0, self.num_class)
        targets = []
        for g, ids in enumerate(self.class_ids_each_head):
            new_lbl = getattr(self, f'remap_{g}')[lbl]
            sel = new_lbl > 0
            gt = torch.where(sel[..., None], gt_boxes, 0.0)
            gt = torch.cat([gt[..., :-1], torch.where(
                sel, new_lbl, 0).to(gt.dtype)[..., None]], dim=-1)
            hm, boxes, inds, mask, gt7 = assign_center_targets(
                gt, len(ids), (W, H), self.feature_map_stride,
                self.voxel_size, self.pcr,
                num_max_objs=int(tac.get('NUM_MAX_OBJS', 500)),
                gaussian_overlap=float(tac.get('GAUSSIAN_OVERLAP', 0.1)),
                min_radius=int(tac.get('MIN_RADIUS', 2)))
            targets.append({'heatmap': hm, 'boxes': boxes, 'inds': inds,
                            'mask': mask, 'gt7': gt7})
        return targets

    def forward(self, batch):
        """'spatial_features_2d' (B, C, H, W) -> adds 'center_head_iou_ret'
        (the groups' 'pred_dicts' of NCHW maps; in training with
        'gt_boxes' their 'target_dicts' and 'decode_at_inds', the boxes
        at the target pixels) and, unless training without
        ``train_decode``, the decoded detections: 'final_boxes',
        'final_scores', 'final_labels' (1-based, 0 where invalid) and
        'final_valid', and for a second stage 'batch_box_preds', a
        one-hot 'batch_cls_preds' of the scores and 'cls_preds_normalized'
        True."""
        x = self.shared_conv(batch['spatial_features_2d'])
        B, _, H, W = x.shape
        pred_dicts = [head(x) for head in self.heads_list]
        ret = {'pred_dicts': pred_dicts}
        if self.training and 'gt_boxes' in batch:
            ret['target_dicts'] = self.assign_targets(batch['gt_boxes'], H,
                                                      W)
            ret['decode_at_inds'] = [
                self.decode_at(pd, td['inds'])
                for pd, td in zip(pred_dicts, ret['target_dicts'])]
        batch = dict(batch, center_head_iou_ret=ret)
        if self.training and not self.train_decode:
            return batch
        return self.decode(batch, pred_dicts)

    def decode(self, batch, pred_dicts):
        """The fixed-shape decode (``generate_predicted_boxes``) of each
        group, concatenated over the groups (and classes)."""
        pp = self.model_cfg.POST_PROCESSING
        dev = pred_dicts[0]['hm'].device
        rectifier, post_range = self.rectifier, self.post_range
        score_thresh = float(pp.get('SCORE_THRESH', 0.1))
        nms_cfg = pp.NMS_CONFIG
        n_pre = int(nms_cfg.get('NMS_PRE_MAXSIZE', 500))
        n_post = int(nms_cfg.get('NMS_POST_MAXSIZE', 80))
        upstream = str(self.model_cfg.get('NAME', 'CenterHeadIoU')) == \
            'CenterHead'
        nms_name = str(nms_cfg.get(
            'NMS_NAME', 'agnostic_nms' if upstream else 'class_specific_nms'))
        nms_thresh = float(nms_cfg.get('NMS_THRESH', 0.1))

        def nms(boxes, s, ok):
            keep, cnt = ops.nms_bev(boxes, torch.where(ok, s, 0.0),
                                        nms_thresh, pre_maxsize=n_pre,
                                        post_maxsize=n_post, valid=ok)
            sl = torch.arange(keep.shape[1], device=dev)[None] < cnt[:, None]
            kc = keep.clamp(min=0)
            kept = boxes.gather(1, kc[..., None].expand(-1, -1,
                                                        boxes.shape[-1]))
            return kept, torch.where(sl, s.gather(1, kc), 0.0), kc, sl

        outs = []
        for g, (ids, pred) in enumerate(zip(self.class_ids_each_head,
                                            pred_dicts)):
            hm = torch.sigmoid(pred['hm'])
            B, G, H, W = hm.shape
            if upstream:
                max_obj = int(pp.get('MAX_OBJ_PER_SAMPLE', 500))
                scores, top = topk_desc(_flat(hm).reshape(B, H * W * G),
                                        min(max_obj, H * W * G))
                cls_local, pix = top % G, top // G
            else:
                px_scores, px_cls = _flat(hm).max(dim=-1)
                scores, pix = topk_desc(px_scores, min(n_pre, H * W))
                cls_local = px_cls.gather(1, pix)
            boxes = self.decode_at(pred, pix)
            if 'iou' in pred:
                iou = _flat(pred['iou'])[..., 0].gather(1, pix)
                iou = ((iou + 1.0) * 0.5).clamp(0.0, 1.0)
            else:
                iou = torch.ones_like(scores)
            in_range = (boxes[..., :3] >= post_range[:3]).all(dim=-1) & \
                (boxes[..., :3] <= post_range[3:]).all(dim=-1)
            gids = getattr(self, f'ids_{g}')[cls_local]
            r = rectifier[gids] if rectifier.numel() > 1 else rectifier[0]
            s_all = torch.pow(scores.clamp(min=1e-9), 1.0 - r) * \
                torch.pow(iou.clamp(min=1e-9), r)
            if nms_name == 'agnostic_nms':
                ok = in_range & (s_all > score_thresh)
                bb, ss, kc, vv = nms(boxes, s_all, ok)
                outs.append((bb, ss, gids.gather(1, kc) + 1, vv))
            else:
                for li, gid in enumerate(ids):
                    ok = in_range & (s_all > score_thresh) & (cls_local == li)
                    bb, ss, _, vv = nms(boxes, s_all, ok)
                    outs.append((bb, ss, torch.full_like(vv, gid + 1,
                                                         dtype=torch.int64),
                                 vv))
        boxes, scores, labels, valid = (torch.cat(t, dim=1)
                                        for t in zip(*outs))
        one_hot = torch.nn.functional.one_hot(
            (labels - 1).clamp(0, self.num_class - 1), self.num_class) > 0
        return dict(batch, final_boxes=torch.where(valid[..., None], boxes,
                                                   0.0),
                    final_scores=scores,
                    final_labels=torch.where(valid, labels, 0),
                    final_valid=valid, batch_box_preds=boxes,
                    batch_cls_preds=torch.where(one_hot, scores[..., None],
                                                0.0),
                    cls_preds_normalized=True)


def center_head_iou_loss(ret, loss_cfg, head_order):
    """(loss, tb): the sum over the head groups of the focal heatmap loss,
    the masked L1 of the HEAD_ORDER maps at the centre pixels and, with an
    'iou' map, the L1 between it and 2 * IoU3D - 1 of the detached decoded
    boxes (clamped to +-200) and their gt (``center_head_iou.py get_loss``
    :501-583), each over its count (the joined batch's in a data-parallel
    step, ``parallel.global_sum``); tb holds 'hm_loss_head_{g}',
    'loc_loss_head_{g}', 'iou_loss_{g}' and 'rpn_loss'."""
    lw = loss_cfg.LOSS_WEIGHTS
    total = 0.0
    tb = {}
    for gi, (pred, tgt) in enumerate(zip(ret['pred_dicts'],
                                         ret['target_dicts'])):
        hm_loss = gaussian_focal_loss(pred['hm'], tgt['heatmap']) * \
            lw.get('cls_weight', 1.0)
        reg = _flat(torch.cat([pred[k] for k in head_order], dim=1))
        C = reg.shape[-1]
        at_inds = reg.gather(1, tgt['inds'][..., None].expand(-1, -1, C))
        mask = tgt['mask'].to(reg.dtype)[..., None]
        code_w = reg.new_tensor(
            list(lw.get('code_weights', [1.0] * C))[:C])
        l1 = (at_inds - tgt['boxes'][..., :C]).abs() * mask * code_w
        loc_loss = l1.sum() / global_sum(mask.sum()).clamp(min=1.0) * \
            lw.get('loc_weight', 0.25)
        total = total + hm_loss + loc_loss
        tb[f'hm_loss_head_{gi}'] = hm_loss
        tb[f'loc_loss_head_{gi}'] = loc_loss
        if 'iou' in pred:
            dec = ret['decode_at_inds'][gi][..., :7].detach().clamp(-200.0,
                                                                   200.0)
            m = tgt['mask'].to(reg.dtype)
            target = 2.0 * ops.boxes_iou3d_paired(dec, tgt['gt7']) - 1.0
            iou_at = _flat(pred['iou'])[..., 0].gather(1, tgt['inds'])
            iou_loss = ((iou_at - target).abs() * m).sum() / \
                (global_sum(m.sum()) + 1e-4) * lw.get('iou_weight', 1.0)
            total = total + iou_loss
            tb[f'iou_loss_{gi}'] = iou_loss
    tb['rpn_loss'] = total
    return total, tb
