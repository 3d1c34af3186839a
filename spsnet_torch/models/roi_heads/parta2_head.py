"""PartA2's RoI head: RoI-aware voxel pooling and the dense 3D refinement.

Port of ``spsnet_tpu/models/roi_heads/parta2_head.py:29-251`` (reference
``roi_heads/partA2_head.py`` with ``roiaware_pool3d``). The proposals are
the first stage's boxes after class-agnostic NMS at NMS_CONFIG.TRAIN in
training, TEST in eval; in training with gt the RoI target sampling
replaces them with ROI_PER_IMAGE RoIs a frame
(``pointrcnn_head.sample_roi_targets``, its draws from the step's
'roi_sampling' generator). The voxel centres inside a RoI fall into a
POOL_SIZE^3 grid of it: the part features (the part head's part
sigmoids, or the centres with DISABLE_PART, zeroed below
SEG_MASK_SCORE_THRESH, and the detached score) are averaged a cell, the
UNet's features max-pooled. Two submanifold blocks each (``conv_part``,
``conv_rpn``: a dense 3 x 3 x 3 convolution over the grid, the BatchNorm
of the active cells, ReLU, the mask), the grids concatenated rpn first
and flattened channel-major, then ``shared_fc_layer`` and the cls and reg
towers (Dropout masks from the step's 'dropout' generator) refine each
RoI, decoded in its frame. The loss is PointRCNN's
``pointrcnn_head_loss``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...parallel import step_world, sum_over_ranks
from ...utils import box_coder as box_coder_lib
from ...utils import box_utils
from ..blocks import MLPHead, SharedMLP
from .pointrcnn_head import (decode_in_roi_frame, proposal_layer,
                             sample_roi_targets)

# (voxel, RoI) pairs tested for inside-ness at once: the RoIs go in
# chunks of at most this many pairs a chunk
POOL_PAIRS = 2 ** 24


def roi_cells(points, rois, pool_size: int):
    """(B, V, 3) points, (B, R, 7) RoIs -> the (voxel, RoI) pairs with the
    voxel inside the RoI, as flat indices (P,) into (B, V) and into (B, R,
    G^3) of its cell: the point in the RoI's frame over the RoI's dims
    (clipped at 1e-4) plus 0.5 lies in [0, 1) on every axis, cell
    ``clip(int(rel * G), 0, G - 1)`` a axis, flattened (x G + y) G + z.
    The RoIs are taken in chunks of at most POOL_PAIRS pairs."""
    B, V, _ = points.shape
    R = rois.shape[1]
    G = int(pool_size)
    step = max(1, POOL_PAIRS // max(B * V, 1))
    rows, slots = [], []
    for r0 in range(0, R, step):
        box = rois[:, r0:r0 + step, :7]
        local = box_utils.points_to_box_local(points, box)     # (B, V, r, 3)
        rel = local / box[..., 3:6].clamp(min=1e-4)[:, None] + 0.5
        inside = ((rel >= 0) & (rel < 1)).all(-1)
        b, v, r = inside.nonzero(as_tuple=True)
        cell = (rel[b, v, r] * G).to(torch.int32).clamp(0, G - 1).long()
        flat = (cell[:, 0] * G + cell[:, 1]) * G + cell[:, 2]
        rows.append(b * V + v)
        slots.append((b * R + r + r0) * G ** 3 + flat)
    return torch.cat(rows), torch.cat(slots)


def roiaware_pool(points, features, rois, pool_size: int, method='max',
                  cells=None):
    """(B, V, 3) points with (B, V, C) features, (B, R, 7) RoIs -> (B, R,
    G^3, C): per cell of each RoI the max (empty cells 0) or the mean
    (``method`` 'avg') of the features of the points inside it, over the
    inside pairs only (``roi_cells``, or ``cells`` from a call of it). The
    max is exact and splits its gradient evenly among tied points; the mean
    sums in the order of the pairs (atomics on the card)."""
    B, V, C = features.shape
    R, G3 = rois.shape[1], int(pool_size) ** 3
    row, slot = roi_cells(points, rois, pool_size) if cells is None \
        else cells
    src = features.reshape(B * V, C)[row]
    if method == 'max':
        out = features.new_full((B * R * G3, C), -1e9).scatter_reduce(
            0, slot[:, None].expand(-1, C), src, 'amax', include_self=True)
        out = torch.where(out <= -1e9, 0.0, out)
    else:
        total = features.new_zeros((B * R * G3, C)).index_add(0, slot, src)
        count = torch.bincount(slot, minlength=B * R * G3).to(features.dtype)
        out = total / count.clamp(min=1.0)[:, None]
    return out.reshape(B, R, G3, C)


def _global_masked_stats(x, mask, dims):
    """(n, mean, var), biased, of ``x`` over the active cells of ``mask``
    on every rank of the active data-parallel step, n clipped at 2, as
    ``blocks._global_stats``: two passes of a differentiable all-reduce,
    the sums and the count in float64."""
    s = (x * mask).sum(dims).double()
    stats = sum_over_ranks(torch.cat([s, mask.sum().double().reshape(1)]))
    n = stats[-1].clamp(min=2.0)
    mean = (stats[:-1] / n).to(x.dtype)
    d = (x - mean[:, None, None, None]) ** 2 * mask
    var = (sum_over_ranks(d.sum(dims).double()) / n).to(x.dtype)
    return n.to(x.dtype), mean, var


class MaskedBatchNorm(nn.BatchNorm3d):
    """The BatchNorm of spconv's sparse tensors as a dense grid's twin: in
    training its statistics run over the active cells only (``mask`` (N, 1,
    G, G, G), their count n clipped at 2), and the running variance takes
    torch's unbiased update (var * n / (n - 1)), at momentum 0.01 (flax's
    decay 0.99) and eps 1e-3 (``parta2_head.py:75-103`` of the JAX
    package). The port's other BatchNorms (``blocks.BatchNormLast``,
    ``BatchNormNCHW``) keep flax's biased rule. Eval normalises every cell
    by the running statistics. Inside a data-parallel step of more than one
    rank the count, mean and variance are those of every rank's active
    cells (``_global_masked_stats``), and so is the running rule's n."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=0.01)

    def forward(self, x, mask):
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3, 4)
        if step_world() > 1:
            n, mean, var = _global_masked_stats(x, mask, dims)
        else:
            n = mask.sum().clamp(min=2.0)
            mean = (x * mask).sum(dims) / n
            var = ((x - mean[:, None, None, None]) ** 2 * mask).sum(dims) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var +
                                   m * var * n / (n - 1).clamp(min=1.0))
            self.num_batches_tracked += 1
        shape = (1, -1, 1, 1, 1)
        return (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self.eps) * self.weight.reshape(shape) + \
            self.bias.reshape(shape)


class SubMConvBlock(nn.Sequential):
    """The reference's submanifold ``post_act_block`` on a dense (N, C_in,
    G, G, G) grid: a 3 x 3 x 3 convolution without bias, padding 1 (0,
    ``Conv3d``; its flax kernel (3, 3, 3, C_in, C_out) over the grid's x,
    y, z), the masked BatchNorm (1), ReLU, then the mask: inactive inputs
    are zero, so the dense convolution sums the active neighbours as
    SubMConv3d does, and the mask keeps the outputs at the active cells."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.Conv3d(in_channels, out_channels, 3, padding=1,
                                   bias=False),
                         MaskedBatchNorm(out_channels))

    def forward(self, x, mask):
        return torch.relu(self[1](self[0](x), mask)) * mask


class PartA2FCHead(nn.Module):
    """Submodules ``conv_part`` (two ``SubMConvBlock``s, 4 -> 64 -> c0),
    ``conv_rpn`` (C -> 64 -> c0; c0 = ROI_AWARE_POOL.NUM_FEATURES / 2),
    ``shared_fc_layer`` (SHARED_FC over 2 c0 G^3 channels, a Dropout of
    DP_RATIO after each block but the last), ``cls_layers`` and
    ``reg_layers`` (a Dropout after their first block); ``input_channels``:
    the UNet's feature channels."""

    def __init__(self, model_cfg, num_class: int, input_channels: int = 16):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.box_coder = box_coder_lib.build_box_coder(
            model_cfg.TARGET_CONFIG.BOX_CODER)
        pool = model_cfg.ROI_AWARE_POOL
        self.pool_size = int(pool.POOL_SIZE)
        c0 = int(pool.NUM_FEATURES) // 2
        self.conv_part = nn.ModuleList([SubMConvBlock(4, 64),
                                        SubMConvBlock(64, c0)])
        self.conv_rpn = nn.ModuleList([SubMConvBlock(input_channels, 64),
                                       SubMConvBlock(64, c0)])
        dp = float(model_cfg.get('DP_RATIO', 0.0))
        shared = list(model_cfg.SHARED_FC)
        self.shared_fc_layer = SharedMLP(
            2 * c0 * self.pool_size ** 3, shared, dropout=dp,
            dropout_idx=range(len(shared) - 1))
        c = self.shared_fc_layer.out_channels
        self.cls_layers = MLPHead(c, list(model_cfg.CLS_FC), num_class,
                                  dropout=dp, dropout_idx=(0,))
        self.reg_layers = MLPHead(c, list(model_cfg.REG_FC),
                                  self.box_coder.code_size * num_class,
                                  dropout=dp, dropout_idx=(0,))

    def pool(self, batch, rois):
        """The RoI-aware pools of the part features (avg) and the UNet's
        features (max) at the voxel centres (padded rows at 1e6): (part
        (B, R, G^3, 4), rpn (B, R, G^3, C))."""
        centers = batch['voxel_centers']
        if 'voxel_valid' in batch:
            centers = torch.where(batch['voxel_valid'][..., None], centers,
                                  1e6)
        part_feats = batch['point_part_features']
        score = part_feats[..., -1:].detach()
        part3 = centers if self.model_cfg.get('DISABLE_PART', False) \
            else part_feats[..., 0:3]
        thresh = float(self.model_cfg.get('SEG_MASK_SCORE_THRESH', 0.3))
        part3 = torch.where(score < thresh, 0.0, part3)
        cells = roi_cells(centers, rois[..., :7], self.pool_size)
        return (roiaware_pool(centers, torch.cat([part3, score], dim=-1),
                              rois, self.pool_size, 'avg', cells),
                roiaware_pool(centers, batch['point_features'], rois,
                              self.pool_size, 'max', cells))

    def refine(self, pooled_part, pooled_rpn, generator=None):
        """The pooled grids -> (rcnn_cls (B, R, num_class), rcnn_reg (B, R,
        code_size num_class)); the active cells are those whose part
        features do not sum to 0."""
        B, R, G3, _ = pooled_part.shape
        G = self.pool_size

        def grid(x):
            return x.reshape(B * R, G, G, G, -1).permute(0, 4, 1, 2, 3)
        mask = (pooled_part.sum(-1) != 0).to(pooled_part.dtype).reshape(
            B * R, 1, G, G, G)
        xp, xr = grid(pooled_part), grid(pooled_rpn)
        for block in self.conv_part:
            xp = block(xp, mask)
        for block in self.conv_rpn:
            xr = block(xr, mask)
        x = torch.cat([xr, xp], dim=1).reshape(B, R, -1)
        shared = self.shared_fc_layer(x, generator)
        return (self.cls_layers(shared, generator),
                self.reg_layers(shared, generator))

    def forward(self, batch):
        """As ``VoxelRCNNHead.forward``: the proposals (in training with
        'gt_boxes' the sampled RoIs and their targets), the pools, their
        refinement and the decoded boxes; adds 'rois', 'roi_valid' and
        'roi_head_ret' and, in eval, 'batch_box_preds', 'batch_cls_preds'
        (logits), 'batch_roi_labels' and 'has_class_labels'."""
        has_class_labels = batch['batch_cls_preds'].shape[-1] > 1
        nms = self.model_cfg.NMS_CONFIG
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            batch, nms.TRAIN if self.training else nms.TEST)
        targets = None
        if self.training and 'gt_boxes' in batch:
            targets, rois, roi_labels, _, roi_valid = sample_roi_targets(
                batch, rois, roi_scores, roi_labels, roi_valid,
                self.model_cfg.TARGET_CONFIG)
        dropout = batch.get('rngs', {}).get('dropout') if self.training \
            else None
        rcnn_cls, rcnn_reg = self.refine(*self.pool(batch, rois), dropout)
        decoded = decode_in_roi_frame(self.box_coder, rcnn_reg, rois)
        batch = dict(batch, rois=rois, roi_valid=roi_valid,
                     roi_head_ret={'rcnn_cls': rcnn_cls, 'rcnn_reg': rcnn_reg,
                                   'rois': rois, 'targets': targets,
                                   'batch_box_preds': decoded})
        if not self.training:
            batch.update(batch_box_preds=decoded, batch_cls_preds=rcnn_cls,
                         batch_roi_labels=roi_labels,
                         has_class_labels=has_class_labels,
                         cls_preds_normalized=False)
        return batch
