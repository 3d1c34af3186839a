"""Anchors and the anchor heads of SECOND / PV-RCNN / PointPillars
(``anchor_head_single.py``, ``anchor_head_multi.py``,
``anchor_generator.py``, ``axis_aligned_target_assigner.py``, as
``spsnet_tpu/models/dense_heads/anchor_head.py``): the single head and the
grouped multi-head RPN, their forward and decode, and in training the
anchor targets (axis-aligned nearest-BEV IoU with per-class matched and
unmatched thresholds and the gt's force match) and ``anchor_head_loss``."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import global_count
from ...utils import box_coder as box_coder_lib
from ...utils import loss_utils
from ...utils.common import limit_period
from ..blocks import BatchNormNCHW


def generate_anchors(anchor_generator_configs, grid_size, point_cloud_range,
                     feature_map_stride):
    """(ny, nx, A, 7) float32 anchors on the host, each location's A slots
    ordered class, then bottom height, size and rotation (the order of the
    head's conv channels). ``align_center`` puts the anchors at cell
    centers (stride span / n, offset half a stride); without it they span
    the range inclusively (stride span / (n - 1)). z is the bottom height
    plus half the anchor's height. Also, for each slot, (A,) the class id
    (1-based, int32) and the class's matched and unmatched IoU thresholds
    (float32)."""
    pcr = np.asarray(point_cloud_range, dtype=np.float32)
    nx = int(grid_size[0]) // feature_map_stride
    ny = int(grid_size[1]) // feature_map_stride
    anchors, cls_ids, matched, unmatched = [], [], [], []
    for ci, cfg in enumerate(anchor_generator_configs):
        if cfg.get('align_center', False):
            x_stride = (pcr[3] - pcr[0]) / nx
            y_stride = (pcr[4] - pcr[1]) / ny
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (pcr[3] - pcr[0]) / (nx - 1)
            y_stride = (pcr[4] - pcr[1]) / (ny - 1)
            x_off, y_off = 0.0, 0.0
        xs = pcr[0] + x_off + np.arange(nx) * x_stride
        ys = pcr[1] + y_off + np.arange(ny) * y_stride
        sizes = np.asarray(cfg['anchor_sizes'], dtype=np.float32)
        rotations = np.asarray(cfg['anchor_rotations'], dtype=np.float32)
        for z_bottom in cfg['anchor_bottom_heights']:
            for size in sizes:
                for rot in rotations:
                    a = np.zeros((ny, nx, 7), dtype=np.float32)
                    a[..., 0] = xs[None, :]
                    a[..., 1] = ys[:, None]
                    a[..., 2] = float(z_bottom) + size[2] / 2
                    a[..., 3:6] = size
                    a[..., 6] = rot
                    anchors.append(a)
                    cls_ids.append(ci + 1)
                    matched.append(float(cfg['matched_threshold']))
                    unmatched.append(float(cfg['unmatched_threshold']))
    return (np.stack(anchors, axis=2), np.asarray(cls_ids, np.int32),
            np.asarray(matched, np.float32),
            np.asarray(unmatched, np.float32))


def _aligned_bev_boxes(boxes):
    """(..., 7) boxes -> (..., 4) [x0, y0, x1, y1] axis-aligned BEV
    envelopes: dx and dy swap when the heading, wrapped into [-pi/2,
    pi/2), lies at or beyond pi/4 of the x axis
    (``boxes3d_lidar_to_aligned_bev_boxes``)."""
    rot = limit_period(boxes[..., 6], offset=0.5, period=np.pi)
    along_x = rot.abs() < np.pi / 4
    dx = torch.where(along_x, boxes[..., 3], boxes[..., 4])
    dy = torch.where(along_x, boxes[..., 4], boxes[..., 3])
    return torch.stack([boxes[..., 0] - dx / 2, boxes[..., 1] - dy / 2,
                        boxes[..., 0] + dx / 2, boxes[..., 1] + dy / 2],
                       dim=-1)


def nearest_bev_iou(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) IoU of the axis-aligned BEV
    envelopes (``boxes3d_nearest_bev_iou``), the union clamped at 1e-6."""
    a = _aligned_bev_boxes(boxes_a)[..., :, None, :]
    b = _aligned_bev_boxes(boxes_b)[..., None, :, :]
    wh = (torch.minimum(a[..., 2:], b[..., 2:]) -
          torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


def assign_anchor_targets(anchors, anchor_cls, matched, unmatched, gt_boxes,
                          box_coder):
    """Targets of (N, 7) anchors with their (N,) class ids and matched /
    unmatched thresholds for (B, T, 8) gt boxes, or (B, T, 10) with the
    velocity before the class (the class last, rows with dx = 0 padding;
    the extra columns are encoded against the anchors zero-padded to the
    box width, ``spsnet_tpu/models/dense_heads/anchor_head.py:129-131``): per frame, each anchor's best gt of its own class by
    ``nearest_bev_iou`` (the first on ties), positive at or above its
    matched threshold, background below its unmatched one, ignored (-1)
    between; every anchor whose IoU equals a valid gt's best (when that is
    above 0) is positive too. Returns (labels (B, N) int64: -1, 0 or the
    gt's class; reg_targets (B, N, code_size): ``box_coder.encode`` of the
    gt against the anchor on the foreground, 0 elsewhere; reg_weights
    (B, N) float: 1 on the foreground; gt_idx (B, N) int64 the matched gt,
    and force (B, N) bool, the anchors a gt's best match took)."""
    gt_valid = gt_boxes[..., 3] > 0                           # (B, T)
    gt_cls = gt_boxes[..., -1].long()
    iou = nearest_bev_iou(anchors, gt_boxes[..., :7])         # (B, N, T)
    same = anchor_cls.long()[:, None] == gt_cls[:, None, :]
    iou = torch.where(same & gt_valid[:, None, :], iou, -1.0)
    a2g_max = iou.amax(dim=-1)
    # torch.max promises no index among equal maxima: the first, as argmax
    gt_idx = (iou == a2g_max[..., None]).to(torch.uint8).argmax(dim=-1)
    g2a_max = iou.amax(dim=1, keepdim=True)                   # (B, 1, T)
    # a gt with no positive overlap takes a sentinel no IoU equals
    g2a_max = torch.where(g2a_max <= 0, -2.0, g2a_max)
    force = ((iou == g2a_max) & gt_valid[:, None, :]).any(dim=-1)
    labels = torch.where(a2g_max < unmatched, 0, -1)
    labels = torch.where((a2g_max >= matched) | force,
                         gt_cls.gather(1, gt_idx), labels)
    fg = labels > 0
    box_dim = gt_boxes.shape[-1] - 1
    matched_gt = gt_boxes.gather(1, gt_idx[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))
    # gt with extra columns (nuScenes' velocity) is encoded against the
    # anchors zero-padded to its width, as the reference pads them
    enc = box_coder.encode(matched_gt[..., :box_dim],
                           F.pad(anchors, (0, max(box_dim - 7, 0))).expand(
                               gt_boxes.shape[0], -1, -1))
    reg_targets = torch.where(fg[..., None], enc, 0.0)
    return labels, reg_targets, fg.float(), gt_idx, force


def direction_bins(dir_preds):
    """(..., bins) direction logits -> (...,) the bin of each anchor (the
    first of equal logits)."""
    return dir_preds.argmax(dim=-1)


def decode_with_direction(head, box_preds, dir_preds):
    """``head.box_coder.decode`` of (B, N, code_size) residuals against
    ``head.anchors``, each heading (with direction logits) wrapped by
    DIR_LIMIT_OFFSET into one bin's period from ``head.dir_offset`` and
    put into the classifier's bin."""
    decoded = head.box_coder.decode(box_preds, head.anchors[None])
    if dir_preds is None:
        return decoded
    limit_offset = float(head.model_cfg.get('DIR_LIMIT_OFFSET', 0.0))
    period = 2 * math.pi / head.num_dir_bins
    rot = limit_period(decoded[..., 6] - head.dir_offset, limit_offset,
                       period)
    heading = rot + head.dir_offset + period * \
        direction_bins(dir_preds).to(decoded.dtype)
    return torch.cat([decoded[..., :6], heading[..., None],
                      decoded[..., 7:]], dim=-1)


class AnchorHeadSingle(nn.Module):
    """1 x 1 convolutions ``conv_cls``, ``conv_box`` and ``conv_dir_cls``
    over the BEV map; the anchors (a buffer, not in the state dict) in
    (H * W * A) order with each one's class and thresholds; the boxes
    decoded with ``ResidualCoder`` and their headings put into the
    direction classifier's bin."""

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        tac = model_cfg.TARGET_ASSIGNER_CONFIG
        self.box_coder = box_coder_lib.build_box_coder(
            tac.get('BOX_CODER', 'ResidualCoder'),
            **dict(tac.get('BOX_CODER_CONFIG', None) or {}))
        agc = list(model_cfg.ANCHOR_GENERATOR_CONFIG)
        anchors, cls_ids, matched, unmatched = generate_anchors(
            agc, grid_size, point_cloud_range,
            int(agc[0].get('feature_map_stride', 2)))
        ny, nx, A, _ = anchors.shape
        self.register_buffer('anchors',
                             torch.from_numpy(anchors.reshape(-1, 7)),
                             persistent=False)
        for name, per_slot in (('anchor_cls', cls_ids),
                               ('anchor_matched', matched),
                               ('anchor_unmatched', unmatched)):
            self.register_buffer(name, torch.from_numpy(
                np.tile(per_slot, ny * nx)), persistent=False)
        self.conv_cls = nn.Conv2d(input_channels, A * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels,
                                  A * self.box_coder.code_size, 1)
        self.use_dir = bool(model_cfg.get('USE_DIRECTION_CLASSIFIER', True))
        self.num_dir_bins = int(model_cfg.get('NUM_DIR_BINS', 2))
        self.dir_offset = float(model_cfg.get('DIR_OFFSET', 0.78539))
        if self.use_dir:
            self.conv_dir_cls = nn.Conv2d(input_channels,
                                          A * self.num_dir_bins, 1)

    @staticmethod
    def _flat(x, width):
        """(B, A * width, H, W) -> (B, H * W * A, width)."""
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)

    def assign_targets(self, gt_boxes):
        """``assign_anchor_targets`` of this head's anchors for (B, T, 8)
        gt boxes."""
        return assign_anchor_targets(
            self.anchors, self.anchor_cls, self.anchor_matched,
            self.anchor_unmatched, gt_boxes, self.box_coder)

    def forward(self, batch):
        """'spatial_features_2d' (B, C, H, W) -> adds 'batch_cls_preds'
        (B, H * W * A, num_class) logits, 'batch_box_preds' (B, H * W * A,
        7) decoded boxes, 'cls_preds_normalized' False and
        'anchor_head_ret' (the raw predictions and the anchors; in training
        with 'gt_boxes' (B, T, 8) also 'box_cls_labels', 'box_reg_targets'
        and 'reg_weights')."""
        x = batch['spatial_features_2d']
        cls_preds = self._flat(self.conv_cls(x), self.num_class)
        box_preds = self._flat(self.conv_box(x), self.box_coder.code_size)
        dir_preds = self._flat(self.conv_dir_cls(x), self.num_dir_bins) \
            if self.use_dir else None
        decoded = decode_with_direction(self, box_preds, dir_preds)
        ret = {'cls_preds': cls_preds, 'box_preds': box_preds,
               'dir_preds': dir_preds, 'anchors': self.anchors}
        if self.training and 'gt_boxes' in batch:
            labels, reg_targets, reg_weights, _, _ = self.assign_targets(
                batch['gt_boxes'])
            ret.update(box_cls_labels=labels, box_reg_targets=reg_targets,
                       reg_weights=reg_weights)
        return dict(batch, batch_cls_preds=cls_preds,
                    batch_box_preds=decoded, cls_preds_normalized=False,
                    anchor_head_ret=ret)



def _middle_convs(c_in: int, n: int, width: int) -> list:
    """``n`` x (3 x 3 no-bias conv, BatchNorm with flax's momentum 0.99
    and eps 1e-3, ReLU) of ``width`` channels."""
    layers = []
    for _ in range(n):
        layers += [nn.Conv2d(c_in, width, 3, padding=1, bias=False),
                   BatchNormNCHW(width), nn.ReLU()]
        c_in = width
    return layers


class _GroupHead(nn.Module):
    """One RPN_HEAD_CFGS group of ``AnchorHeadMulti`` (the reference's
    ``SingleHead``): ``conv_cls`` (A * C logits), ``conv_box`` and
    ``conv_dir_cls`` (A * bins) over the shared map. Without
    SEPARATE_REG_CONFIG the first two are 1 x 1 convolutions; with it
    ``conv_cls`` is a middle stack and a 3 x 3 conv, and ``conv_box`` holds
    a middle stack and a 3 x 3 conv of A * ch channels for each REG_LIST
    entry ``name:ch``, as ``conv_box.conv_{name}``."""

    def __init__(self, c_in: int, A: int, C: int, code_size: int,
                 num_dir_bins: int, use_dir: bool, sep, reg_list):
        super().__init__()
        self.A, self.C, self.code_size = A, C, code_size
        self.num_dir_bins = num_dir_bins
        if sep is None:
            self.conv_cls = nn.Conv2d(c_in, A * C, 1)
            self.conv_box = nn.Conv2d(c_in, A * code_size, 1)
        else:
            n, width = int(sep.NUM_MIDDLE_CONV), int(sep.NUM_MIDDLE_FILTER)
            c_mid = width if n else c_in
            self.conv_cls = nn.Sequential(*_middle_convs(c_in, n, width),
                                          nn.Conv2d(c_mid, A * C, 3,
                                                    padding=1))
            self.conv_box = nn.ModuleDict({
                f'conv_{name}': nn.Sequential(
                    *_middle_convs(c_in, n, width),
                    nn.Conv2d(c_mid, A * ch, 3, padding=1))
                for name, ch in reg_list})
        self.conv_dir_cls = nn.Conv2d(c_in, A * num_dir_bins, 1) \
            if use_dir else None
        self.reg_list = reg_list

    def forward(self, x):
        """(B, c_in, H, W) -> cls (B, A * H * W, C), box (B, A * H * W,
        code_size), dir (B, A * H * W, bins) or None, anchor-major: each
        conv's channel a * width + j is anchor slot a's entry j."""
        A = self.A
        if isinstance(self.conv_box, nn.ModuleDict):
            box = torch.cat([_anchor_major(
                self.conv_box[f'conv_{name}'](x), A, ch, False)
                for name, ch in self.reg_list], dim=-1)
            box = box.reshape(x.shape[0], -1, self.code_size)
        else:
            box = _anchor_major(self.conv_box(x), A, self.code_size)
        dirs = _anchor_major(self.conv_dir_cls(x), A, self.num_dir_bins) \
            if self.conv_dir_cls is not None else None
        return _anchor_major(self.conv_cls(x), A, self.C), box, dirs


def _anchor_major(x, A: int, width: int, flat: bool = True):
    """(B, A * width, H, W) -> (B, A, H, W, width), or flattened to
    (B, A * H * W, width)."""
    B, _, H, W = x.shape
    x = x.reshape(B, A, width, H, W).permute(0, 1, 3, 4, 2)
    return x.reshape(B, A * H * W, width) if flat else x


class AnchorHeadMulti(nn.Module):
    """The grouped multi-head RPN (``anchor_head_multi.py``, as
    ``spsnet_tpu/models/dense_heads/anchor_head.py:299-501``): an optional
    ``shared_conv`` (3 x 3 no-bias conv of SHARED_CONV_NUM_FILTER, BN,
    ReLU), then one ``_GroupHead`` a RPN_HEAD_CFGS group in
    ``rpn_heads``, each over the anchors of only its classes'
    ANCHOR_GENERATOR_CONFIG entries (at the stride of entry 0), flattened
    anchor-major ((A, H, W)) and concatenated in group order. Each group's
    class logits are scattered into one dense (B, N, num_class) matrix at
    its classes' columns (the class names' order of
    ANCHOR_GENERATOR_CONFIG), -1e9 elsewhere: sigmoid 0 there, so the focal
    loss and its gradient are 0 and no NMS keeps such a box. The class
    logits' biases start at -log 99. The batch keys are
    ``AnchorHeadSingle``'s."""

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        tac = model_cfg.TARGET_ASSIGNER_CONFIG
        self.box_coder = box_coder_lib.build_box_coder(
            tac.get('BOX_CODER', 'ResidualCoder'),
            **dict(tac.get('BOX_CODER_CONFIG', None) or {}))
        code_size = self.box_coder.code_size
        agc = list(model_cfg.ANCHOR_GENERATOR_CONFIG)
        names = [c['class_name'] for c in agc]
        stride = int(agc[0].get('feature_map_stride', 2))
        self.use_dir = bool(model_cfg.get('USE_DIRECTION_CLASSIFIER', True))
        self.num_dir_bins = int(model_cfg.get('NUM_DIR_BINS', 2))
        self.dir_offset = float(model_cfg.get('DIR_OFFSET', 0.78539))

        shared = model_cfg.get('SHARED_CONV_NUM_FILTER', None)
        self.shared_conv = None
        if shared is not None:
            self.shared_conv = nn.Sequential(*_middle_convs(
                input_channels, 1, int(shared)))
            input_channels = int(shared)
        sep = model_cfg.get('SEPARATE_REG_CONFIG', None)
        reg_list = None
        if sep is not None:
            reg_list = [(s.split(':')[0], int(s.split(':')[1]))
                        for s in sep.REG_LIST]
            if sum(ch for _, ch in reg_list) != code_size:
                raise ValueError(f'REG_LIST {list(sep.REG_LIST)} does not '
                                 f'sum to the code size {code_size}')

        self.rpn_heads = nn.ModuleList()
        anchors, cls_ids, matched, unmatched = [], [], [], []
        for hcfg in model_cfg.RPN_HEAD_CFGS:
            head_names = list(hcfg['HEAD_CLS_NAME'])
            sub = [c for c in agc if c['class_name'] in head_names]
            a, local, m, u = generate_anchors(sub, grid_size,
                                              point_cloud_range, stride)
            ny, nx, A, _ = a.shape
            C = len(head_names)
            gids = np.asarray([names.index(sub[c - 1]['class_name']) + 1
                               for c in local], np.int32)
            anchors.append(a.transpose(2, 0, 1, 3).reshape(-1, 7))
            for out, per_slot in ((cls_ids, gids), (matched, m),
                                  (unmatched, u)):
                out.append(np.repeat(per_slot, ny * nx))
            self.register_buffer(
                f'columns{len(self.rpn_heads)}',
                torch.tensor([names.index(n) for n in head_names]),
                persistent=False)
            self.rpn_heads.append(_GroupHead(
                input_channels, A, C, code_size, self.num_dir_bins,
                self.use_dir, sep, reg_list))
        self.register_buffer('anchors',
                             torch.from_numpy(np.concatenate(anchors)),
                             persistent=False)
        for name, parts in (('anchor_cls', cls_ids),
                            ('anchor_matched', matched),
                            ('anchor_unmatched', unmatched)):
            self.register_buffer(name, torch.from_numpy(
                np.concatenate(parts)), persistent=False)

    @torch.no_grad()
    def fixed_init(self):
        """The class logits' biases at -log 99 (a prior of 0.01)."""
        for head in self.rpn_heads:
            conv = head.conv_cls if isinstance(head.conv_cls, nn.Conv2d) \
                else head.conv_cls[-1]
            conv.bias.fill_(-math.log(99.0))

    def assign_targets(self, gt_boxes):
        """``assign_anchor_targets`` of the concatenated anchors for
        (B, T, 8) or (B, T, 10) gt boxes."""
        return assign_anchor_targets(
            self.anchors, self.anchor_cls, self.anchor_matched,
            self.anchor_unmatched, gt_boxes, self.box_coder)

    def forward(self, batch):
        """'spatial_features_2d' (B, C, H, W) -> adds what
        ``AnchorHeadSingle`` adds, over the N anchors of every group:
        'batch_cls_preds' (B, N, num_class), 'batch_box_preds' (B, N,
        7 + extra code channels) decoded with the direction bins."""
        x = batch['spatial_features_2d']
        if self.shared_conv is not None:
            x = self.shared_conv(x)
        cls, box, dirs = [], [], []
        for g, head in enumerate(self.rpn_heads):
            c, b, d = head(x)
            dense = c.new_full((*c.shape[:2], self.num_class), -1e9)
            cls.append(dense.index_copy(2, getattr(self, f'columns{g}'), c))
            box.append(b)
            dirs.append(d)
        cls_preds, box_preds = torch.cat(cls, 1), torch.cat(box, 1)
        if cls_preds.shape[1] != self.anchors.shape[0]:
            raise ValueError(f'{cls_preds.shape[1]} predictions for '
                             f'{self.anchors.shape[0]} anchors: the map is '
                             f'not the anchors\' grid')
        dir_preds = torch.cat(dirs, 1) if self.use_dir else None
        decoded = decode_with_direction(self, box_preds, dir_preds)
        ret = {'cls_preds': cls_preds, 'box_preds': box_preds,
               'dir_preds': dir_preds, 'anchors': self.anchors}
        if self.training and 'gt_boxes' in batch:
            labels, reg_targets, reg_weights, _, _ = self.assign_targets(
                batch['gt_boxes'])
            ret.update(box_cls_labels=labels, box_reg_targets=reg_targets,
                       reg_weights=reg_weights)
        return dict(batch, batch_cls_preds=cls_preds,
                    batch_box_preds=decoded, cls_preds_normalized=False,
                    anchor_head_ret=ret)


def anchor_head_loss(ret, loss_cfg, num_class: int, num_dir_bins: int,
                     dir_offset: float):
    """The anchor head's loss (``spsnet_tpu/models/dense_heads/
    anchor_head.py:242-296``; ``anchor_head_template.py``): the focal loss
    of every cared-for anchor (label >= 0) weighted by neg_cls_weight /
    pos_cls_weight; the smooth-L1 of the foreground's residuals with the
    heading compared as sin(p - t) = sin p cos t - cos p sin t and
    ``code_weights``; with direction logits, the softmax cross entropy
    against the bin of the gt heading, floor(limit_period(heading -
    dir_offset, 0, 2 pi) / (2 pi / bins)). Each weight is divided by its
    frame's positives (at least 1) and each term by B (the joined batch's
    in a data-parallel step, ``parallel.global_count``). Returns (loss, tb)
    with 'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir' and 'rpn_loss'."""
    lw = loss_cfg.LOSS_WEIGHTS
    labels = ret['box_cls_labels']                               # (B, N)
    B = global_count(labels.shape[0])
    positives = labels > 0
    pos_norm = positives.sum(dim=1, keepdim=True).float().clamp(min=1.0)
    cls_w = (float(lw.get('neg_cls_weight', 1.0)) * (labels == 0).float() +
             float(lw.get('pos_cls_weight', 1.0)) * positives.float())
    one_hot = F.one_hot(labels.clamp(min=0), num_class + 1)[..., 1:].float()
    cls_loss = loss_utils.sigmoid_focal_loss(
        ret['cls_preds'], one_hot, cls_w / pos_norm).sum() / B * \
        float(lw['cls_weight'])
    tb = {'rpn_loss_cls': cls_loss}

    reg_w = ret['reg_weights'] / pos_norm
    preds, targets = ret['box_preds'], ret['box_reg_targets']
    sin_p = torch.sin(preds[..., 6:7]) * torch.cos(targets[..., 6:7])
    sin_t = torch.cos(preds[..., 6:7]) * torch.sin(targets[..., 6:7])
    preds = torch.cat([preds[..., :6], sin_p, preds[..., 7:]], dim=-1)
    targets = torch.cat([targets[..., :6], sin_t, targets[..., 7:]], dim=-1)
    loc_loss = loss_utils.weighted_smooth_l1(
        preds, targets, weights=reg_w,
        code_weights=lw.get('code_weights', None)).sum() / B * \
        float(lw['loc_weight'])
    tb['rpn_loss_loc'] = loc_loss
    total = cls_loss + loc_loss

    if ret.get('dir_preds', None) is not None:
        gt_rot = ret['box_reg_targets'][..., 6] + ret['anchors'][None, :, 6]
        dir_t = torch.floor(limit_period(gt_rot - dir_offset, 0.0,
                                         2 * np.pi) /
                            (2 * np.pi / num_dir_bins)).long()
        dir_t = dir_t.clamp(0, num_dir_bins - 1)
        dir_loss = loss_utils.weighted_softmax_ce(
            ret['dir_preds'], F.one_hot(dir_t, num_dir_bins).float(),
            reg_w).sum() / B * float(lw['dir_weight'])
        tb['rpn_loss_dir'] = dir_loss
        total = total + dir_loss
    tb['rpn_loss'] = total
    return total, tb
