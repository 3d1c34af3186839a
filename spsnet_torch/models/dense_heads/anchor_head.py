"""Anchors and the single anchor head of SECOND / PV-RCNN, forward and
decode (``anchor_head_single.py``, ``anchor_generator.py``, as
``spsnet_tpu/models/dense_heads/anchor_head.py:30-86, 158-239``). The
target assignment and the loss wait for the training slice."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...utils import box_coder as box_coder_lib
from ...utils.common import limit_period


def generate_anchors(anchor_generator_configs, grid_size, point_cloud_range,
                     feature_map_stride):
    """(ny, nx, A, 7) float32 anchors on the host, each location's A slots
    ordered class, then bottom height, size and rotation (the order of the
    head's conv channels). ``align_center`` puts the anchors at cell
    centers (stride span / n, offset half a stride); without it they span
    the range inclusively (stride span / (n - 1)). z is the bottom height
    plus half the anchor's height. Also the class id (1-based) of each
    slot, (A,) int32."""
    pcr = np.asarray(point_cloud_range, dtype=np.float32)
    nx = int(grid_size[0]) // feature_map_stride
    ny = int(grid_size[1]) // feature_map_stride
    anchors, cls_ids = [], []
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
    return np.stack(anchors, axis=2), np.asarray(cls_ids, np.int32)


class AnchorHeadSingle(nn.Module):
    """1 x 1 convolutions ``conv_cls``, ``conv_box`` and ``conv_dir_cls``
    over the BEV map; the anchors (a buffer, not in the state dict) in
    (H * W * A) order; the boxes decoded with ``ResidualCoder`` and their
    headings put into the direction classifier's bin."""

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
        anchors, _ = generate_anchors(
            agc, grid_size, point_cloud_range,
            int(agc[0].get('feature_map_stride', 2)))
        A = anchors.shape[2]
        self.register_buffer('anchors',
                             torch.from_numpy(anchors.reshape(-1, 7)),
                             persistent=False)
        self.conv_cls = nn.Conv2d(input_channels, A * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels,
                                  A * self.box_coder.code_size, 1)
        self.use_dir = bool(model_cfg.get('USE_DIRECTION_CLASSIFIER', True))
        self.num_dir_bins = int(model_cfg.get('NUM_DIR_BINS', 2))
        if self.use_dir:
            self.conv_dir_cls = nn.Conv2d(input_channels,
                                          A * self.num_dir_bins, 1)

    @staticmethod
    def _flat(x, width):
        """(B, A * width, H, W) -> (B, H * W * A, width)."""
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)

    def forward(self, batch):
        """'spatial_features_2d' (B, C, H, W) -> adds 'batch_cls_preds'
        (B, H * W * A, num_class) logits, 'batch_box_preds' (B, H * W * A,
        7) decoded boxes, 'cls_preds_normalized' False and
        'anchor_head_ret' (the raw predictions and the anchors)."""
        x = batch['spatial_features_2d']
        cls_preds = self._flat(self.conv_cls(x), self.num_class)
        box_preds = self._flat(self.conv_box(x), self.box_coder.code_size)
        dir_preds = self._flat(self.conv_dir_cls(x), self.num_dir_bins) \
            if self.use_dir else None
        decoded = self.box_coder.decode(box_preds, self.anchors[None])
        if dir_preds is not None:
            dir_offset = float(self.model_cfg.get('DIR_OFFSET', 0.78539))
            limit_offset = float(self.model_cfg.get('DIR_LIMIT_OFFSET', 0.0))
            period = 2 * math.pi / self.num_dir_bins
            rot = limit_period(decoded[..., 6] - dir_offset, limit_offset,
                               period)
            heading = rot + dir_offset + period * \
                dir_preds.argmax(dim=-1).to(decoded.dtype)
            decoded = torch.cat([decoded[..., :6], heading[..., None],
                                 decoded[..., 7:]], dim=-1)
        ret = {'cls_preds': cls_preds, 'box_preds': box_preds,
               'dir_preds': dir_preds, 'anchors': self.anchors}
        return dict(batch, batch_cls_preds=cls_preds,
                    batch_box_preds=decoded, cls_preds_normalized=False,
                    anchor_head_ret=ret)
