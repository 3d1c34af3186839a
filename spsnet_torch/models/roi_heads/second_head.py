"""SECOND-IoU's head: BEV RoI-grid pooling and an IoU prediction.

Port of ``spsnet_tpu/models/roi_heads/second_head.py`` (reference
``roi_heads/second_head.py``): proposal NMS over the anchor head's boxes
on the raw class logits, in training the RoI targets
(``roi_utils.proposal_target_layer``, whose RoIs replace the proposals), a
G x G grid of bilinear samples of the BEV map in each RoI, ``shared_fc_layer``
and ``iou_layers`` to one IoU logit a RoI. The head writes the raw logits;
``detector3d.iou_rescore_post_processing`` turns them into scores. The
pooling reads detached RoIs and a detached BEV map, so the IoU head does
not train the trunk.
"""
from __future__ import annotations

import torch
from torch import nn

from ...parallel import global_sum
from ...utils.common import true_div
from ..blocks import MLPHead, SharedMLP
from ..detectors.detector3d import class_agnostic_nms_batch
from .pointrcnn_head import sample_roi_targets


def bev_roi_grid_pool(rois, bev, grid_size: int, voxel_size,
                      point_cloud_range, downsample_ratio: float):
    """(B, R, 7) RoIs, (B, C, H, W) BEV map -> (B, R, C * G * G) bilinear
    samples, channel-major (c * G * G + i * G + j, the reference's
    ``(B * R, C, G, G).view(B * R, -1)``, so ``shared_fc_layer``'s weights
    map one for one).

    The geometry of the reference's ``affine_grid`` + ``grid_sample``
    (``second_head.py:75-105``, as ``spsnet_tpu/models/roi_heads/
    second_head.py:29-98``): both with ``align_corners=False`` and zero
    padding, theta with the legacy (W - 1) and (H - 1) factors; the four
    corners gathered explicitly. Divisions by the geometry are true
    quotients on every device (``true_div``)."""
    B, R, _ = rois.shape
    G = int(grid_size)
    _, C, H, W = bev.shape
    ds = float(downsample_ratio)
    cx = true_div(rois[..., 0] - float(point_cloud_range[0]),
                  float(voxel_size[0]) * ds)
    cy = true_div(rois[..., 1] - float(point_cloud_range[1]),
                  float(voxel_size[1]) * ds)
    hx = true_div(true_div(rois[..., 3], float(voxel_size[0]) * ds), 2.0)
    hy = true_div(true_div(rois[..., 4], float(voxel_size[1]) * ds), 2.0)
    x1, x2, y1, y2 = cx - hx, cx + hx, cy - hy, cy + hy
    cosa = torch.cos(rois[..., 6])[..., None, None]
    sina = torch.sin(rois[..., 6])[..., None, None]

    # affine_grid's base coordinates at the output pixels' centers
    base = true_div(2.0 * torch.arange(G, dtype=rois.dtype,
                                       device=rois.device) + 1.0, G) - 1.0
    xb, yb = base[None, :], base[:, None]
    sx = true_div(x2 - x1, W - 1)[..., None, None]
    tx = true_div(x1 + x2 - (W - 1), W - 1)[..., None, None]
    sy = true_div(y2 - y1, H - 1)[..., None, None]
    ty = true_div(y1 + y2 - (H - 1), H - 1)[..., None, None]
    gx = sx * (xb * cosa - yb * sina) + tx                 # (B, R, G, G)
    gy = sy * (xb * sina + yb * cosa) + ty

    ix = true_div((gx + 1.0) * W - 1.0, 2.0)
    iy = true_div((gy + 1.0) * H - 1.0, 2.0)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = ix - x0, iy - y0
    x0, y0 = x0.long(), y0.long()
    flat = bev.reshape(B, C, H * W)

    def corner(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        lin = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        v = flat.gather(2, lin.reshape(B, 1, R * G * G).expand(-1, C, -1))
        return torch.where(inside.reshape(B, 1, -1), v, 0.0)

    out = (corner(y0, x0) * ((1 - wy) * (1 - wx)).reshape(B, 1, -1) +
           corner(y0, x0 + 1) * ((1 - wy) * wx).reshape(B, 1, -1) +
           corner(y0 + 1, x0) * (wy * (1 - wx)).reshape(B, 1, -1) +
           corner(y0 + 1, x0 + 1) * (wy * wx).reshape(B, 1, -1))
    return out.reshape(B, C, R, G * G).transpose(1, 2).reshape(
        B, R, C * G * G)


class SECONDHead(nn.Module):
    """``shared_fc_layer`` (SHARED_FC, a Dropout of DP_RATIO after each
    block but the last) and ``iou_layers`` (IOU_FC, a Dropout after its
    first block, then one output) over ``bev_roi_grid_pool`` of the BEV
    map's ``input_channels`` at ROI_GRID_POOL.GRID_SIZE and
    DOWNSAMPLE_RATIO (``bev_stride`` when absent)."""

    def __init__(self, model_cfg, input_channels: int, voxel_size,
                 point_cloud_range, bev_stride: int = 8):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        pool = model_cfg.ROI_GRID_POOL
        self.grid_size = int(pool.GRID_SIZE)
        self.downsample_ratio = float(pool.get('DOWNSAMPLE_RATIO',
                                               bev_stride))
        dp = float(model_cfg.get('DP_RATIO', 0.0))
        shared = list(model_cfg.SHARED_FC)
        self.shared_fc_layer = SharedMLP(
            input_channels * self.grid_size ** 2, shared, dropout=dp,
            dropout_idx=tuple(range(len(shared) - 1)))
        self.iou_layers = MLPHead(self.shared_fc_layer.out_channels,
                                  list(model_cfg.IOU_FC), 1, dropout=dp,
                                  dropout_idx=(0,))

    def proposals(self, batch):
        """Class-agnostic NMS of the anchor head's boxes (NMS_CONFIG.TRAIN
        in training, TEST in eval) on the raw max class logit, no score
        threshold: (rois (B, R, 7), roi_scores (B, R) raw logits,
        roi_labels (B, R), roi_valid (B, R))."""
        nms = self.model_cfg.NMS_CONFIG.TRAIN if self.training \
            else self.model_cfg.NMS_CONFIG.TEST
        dets = class_agnostic_nms_batch(
            batch['batch_box_preds'], batch['batch_cls_preds'],
            score_thresh=-1e9, nms_thresh=float(nms.NMS_THRESH),
            nms_pre=int(nms.NMS_PRE_MAXSIZE),
            nms_post=int(nms.NMS_POST_MAXSIZE), cls_preds_normalized=True)
        R = dets['boxes'].shape[1]
        valid = torch.arange(R, device=dets['count'].device)[None, :] < \
            dets['count'][:, None]
        return dets['boxes'], dets['scores'], dets['labels'], valid

    def forward(self, batch):
        """Adds 'second_head_ret' ('rcnn_iou' (B, R) logits, 'rois',
        'targets' or None); in eval, for ``post_processing``,
        'batch_box_preds' (the RoIs), 'batch_cls_preds' (B, R, 1) raw IoU
        logits, 'batch_roi_scores' (raw RPN logits), 'batch_roi_labels',
        'has_class_labels' (the dense head had more than one class
        channel), 'cls_preds_normalized' False and 'iou_rescoring' True.
        Training reads the step's generators from ``batch['rngs']``
        (``runtime.trainer.step_rngs``): 'roi_sampling' for the RoI draws,
        'dropout' for the FC stacks."""
        has_class_labels = batch['batch_cls_preds'].shape[-1] > 1
        rois, roi_scores, roi_labels, roi_valid = self.proposals(batch)
        targets = None
        if self.training and 'gt_boxes' in batch:
            targets, rois, roi_labels, roi_scores, _ = sample_roi_targets(
                batch, rois, roi_scores, roi_labels, roi_valid,
                self.model_cfg.TARGET_CONFIG)
        pooled = bev_roi_grid_pool(
            rois[..., :7].detach(), batch['spatial_features_2d'].detach(),
            self.grid_size, self.voxel_size, self.point_cloud_range,
            self.downsample_ratio)
        dropout = batch.get('rngs', {}).get('dropout') if self.training \
            else None
        rcnn_iou = self.iou_layers(self.shared_fc_layer(pooled, dropout),
                                   dropout)[..., 0]
        batch = dict(batch, second_head_ret={'rcnn_iou': rcnn_iou,
                                             'rois': rois,
                                             'targets': targets})
        if not self.training:
            batch.update(batch_box_preds=rois[..., :7],
                         batch_cls_preds=rcnn_iou[..., None],
                         batch_roi_scores=roi_scores,
                         batch_roi_labels=roi_labels,
                         has_class_labels=has_class_labels,
                         cls_preds_normalized=False, iou_rescoring=True)
        return batch


def second_head_loss(ret, loss_cfg):
    """The IoU head's loss (``second_head.py:182-206``): IOU_LOSS
    'BinaryCrossEntropy' (with logits), 'L2' or 'smoothL1' (beta 1/9) of
    'rcnn_iou' against the targets' ``rcnn_cls_labels``, averaged over the
    RoIs whose label is not below 0 (the joined batch's in a data-parallel
    step, ``parallel.global_sum``), times LOSS_WEIGHTS.rcnn_iou_weight.
    Returns (loss, {'rcnn_iou_loss': loss})."""
    labels = ret['targets'].rcnn_cls_labels
    logits = ret['rcnn_iou']
    kind = loss_cfg.get('IOU_LOSS', 'BinaryCrossEntropy')
    if kind == 'BinaryCrossEntropy':
        per = logits.clamp(min=0) - logits * labels + \
            torch.log1p(torch.exp(-logits.abs()))
    elif kind == 'L2':
        per = (logits - labels) ** 2
    elif kind == 'smoothL1':
        diff = (logits - labels).abs()
        beta = 1.0 / 9.0
        per = torch.where(diff < beta, 0.5 * diff ** 2 / beta,
                          diff - 0.5 * beta)
    else:
        raise NotImplementedError(f'IOU_LOSS {kind}')
    care = (labels >= 0).float()
    loss = (per * care).sum() / global_sum(care.sum()).clamp(min=1.0) * \
        float(loss_cfg.LOSS_WEIGHTS.get('rcnn_iou_weight', 1.0))
    return loss, {'rcnn_iou_loss': loss}
