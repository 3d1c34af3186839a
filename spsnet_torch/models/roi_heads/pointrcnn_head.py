"""PointRCNN's RoI refinement head and its loss.

Port of ``PointRCNNHead`` and ``pointrcnn_head_loss`` (``spsnet_tpu/models/
roi_heads/pointrcnn_head.py``; reference ``roi_heads/pointrcnn_head.py``
and ``roi_head_template.py``): proposal NMS over the point head's boxes
(NMS_CONFIG.TRAIN in training, TEST in eval), in training with gt the
RoI target sampling (``roi_utils.proposal_target_layer``), whose RoIs
replace the proposals; RoI point pooling with the canonical transform, the
xyz-up and merge MLPs, an SA stack over the (B * R, S, C) pooled points,
the cls and reg towers, and the refined boxes decoded in each RoI's frame
and rotated back. Submodules ``xyz_up_layer``, ``merge_down_layer``,
``SA_modules``, ``cls_layers`` and ``reg_layers``, as the reference's. The
USE_BN flag governs the xyz-up and merge MLPs; the SA layers carry
BatchNorm as the JAX package's ``SAModule`` does, and the cls and reg
towers always do (``roi_head_template.py:36-44``), with a Dropout after
their first block as the reference puts it there (p = DP_RATIO, the
identity in eval).

Gradients follow the JAX package: the RoIs keep theirs (its NMS gathers
the boxes without ``stop_gradient``), so the RoI loss reaches the point
head's box layers through the canonical transform, the regression targets
and the corner loss; only the point scores and the pooled points are
detached. The reference samples its RoIs under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils import box_coder as box_coder_lib
from ...utils import loss_utils
from ...utils.common import rotate_points_along_z
from ..blocks import MLPHead, SharedMLP
from ..detectors.detector3d import class_agnostic_nms_batch
from ..sa_module import SAModule
from .roi_utils import (draw_roi_sampling, proposal_target_layer,
                        roipoint_pool3d)

# channels before the point features in a pooled point: canonical xyz, the
# point score and the depth feature
N_PREFIX = 5


def proposal_layer(batch, nms_cfg):
    """The first stage's boxes -> (rois (B, R, 7), roi_scores (B, R),
    roi_labels (B, R), roi_valid (B, R)) by class-agnostic NMS at
    ``nms_cfg`` with no score threshold (``roi_head_template.py:35-100``);
    R is NMS_POST_MAXSIZE, rows past a frame's count zero."""
    dets = class_agnostic_nms_batch(
        batch['batch_box_preds'], batch['batch_cls_preds'],
        score_thresh=-1e9, nms_thresh=float(nms_cfg.NMS_THRESH),
        nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE),
        nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
        cls_preds_normalized=bool(batch.get('cls_preds_normalized', False)))
    R = dets['boxes'].shape[1]
    valid = torch.arange(R, device=dets['count'].device)[None, :] < \
        dets['count'][:, None]
    return dets['boxes'], dets['scores'], dets['labels'], valid


def decode_in_roi_frame(box_coder, rcnn_reg, rois):
    """Refined boxes: the residuals decoded against each RoI moved to the
    origin with zero heading, then rotated by the RoI's heading and moved
    to its center."""
    B, R, _ = rois.shape
    local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:6],
                       torch.zeros_like(rois[..., 6:7])], dim=-1)
    dec = box_coder.decode(rcnn_reg.reshape(B, R, box_coder.code_size),
                           local)
    xyz = rotate_points_along_z(dec[..., 0:3].reshape(B * R, 1, 3),
                                rois[..., 6].reshape(B * R))
    return torch.cat([xyz.reshape(B, R, 3) + rois[..., 0:3], dec[..., 3:6],
                      dec[..., 6:7] + rois[..., 6:7], dec[..., 7:]], dim=-1)


class PointRCNNHead(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.box_coder = box_coder_lib.build_box_coder(
            model_cfg.TARGET_CONFIG.BOX_CODER)
        use_bn = bool(model_cfg.USE_BN)
        self.xyz_up_layer = SharedMLP(N_PREFIX, list(model_cfg.XYZ_UP_LAYER),
                                      use_bn)
        c_out = self.xyz_up_layer.out_channels
        self.merge_down_layer = SharedMLP(c_out + input_channels, [c_out],
                                          use_bn)
        sa_cfg = model_cfg.SA_CONFIG
        self.SA_modules = nn.ModuleList()
        channel_in = c_out
        for k, npoint in enumerate(sa_cfg.NPOINTS):
            module = SAModule(channel_in, None if npoint == -1 else npoint,
                              [sa_cfg.RADIUS[k]], [sa_cfg.NSAMPLE[k]],
                              [sa_cfg.MLPS[k]])
            self.SA_modules.append(module)
            channel_in = module.out_channels
        dp = max(float(model_cfg.get('DP_RATIO', 0.0)), 0.0)
        self.cls_layers = MLPHead(channel_in, list(model_cfg.CLS_FC),
                                  num_class, dropout=dp, dropout_idx=(0,))
        self.reg_layers = MLPHead(channel_in, list(model_cfg.REG_FC),
                                  self.box_coder.code_size * num_class,
                                  dropout=dp, dropout_idx=(0,))

    def proposal_layer(self, batch):
        """``proposal_layer`` at NMS_CONFIG.TRAIN in training, TEST in
        eval."""
        nms_cfg = self.model_cfg.NMS_CONFIG.TRAIN if self.training \
            else self.model_cfg.NMS_CONFIG.TEST
        return proposal_layer(batch, nms_cfg)

    def pool(self, batch, rois):
        """``roipoint_pool3d`` in the raw frame of each point's xyz, score,
        depth ``|xyz| / DEPTH_NORMALIZER - 0.5`` and features: ((B, R, S,
        5 + C), (B, R) empty)."""
        pool_cfg = self.model_cfg.ROI_POINT_POOL
        coords = batch['point_coords']
        sq = (coords[..., 0] * coords[..., 0] + coords[..., 1] * coords[..., 1]
              ) + coords[..., 2] * coords[..., 2]
        depths = torch.sqrt(sq) / float(pool_cfg.DEPTH_NORMALIZER) - 0.5
        feats = torch.cat([batch['point_cls_scores'][..., None].detach(),
                           depths[..., None], batch['point_features']], dim=-1)
        return roipoint_pool3d(
            coords, feats, rois[..., :7],
            num_sampled_points=int(pool_cfg.NUM_SAMPLED_POINTS),
            pool_extra_width=tuple(pool_cfg.POOL_EXTRA_WIDTH))

    def roipool(self, batch, rois):
        """(B, R, S, 5 + C) pooled points of each RoI in its canonical
        frame (xyz relative to the RoI center, rotated by minus its
        heading), with the point score and the depth before the point
        features; RoIs with no point are all zero."""
        pooled, empty = self.pool(batch, rois)
        pooled = pooled.detach()
        B, R, S, D = pooled.shape
        xyz = pooled[..., 0:3] - rois[..., None, 0:3]
        xyz = rotate_points_along_z(xyz.reshape(B * R, S, 3),
                                    -rois[..., 6].reshape(B * R))
        pooled = torch.cat([xyz.reshape(B, R, S, 3), pooled[..., 3:]], -1)
        return torch.where(empty[..., None, None], 0.0, pooled)

    def refine(self, pooled, generator=None):
        """(B, R, S, 5 + C) pooled points -> (rcnn_cls (B, R, num_class),
        rcnn_reg (B, R, code_size * num_class), the FPS picks of each SA
        layer ((B * R, npoint) or None)); ``generator`` draws the towers'
        dropout masks in training."""
        B, R, S, D = pooled.shape
        x = pooled.reshape(B * R, S, D)
        xyz_feat = self.xyz_up_layer(x[..., :N_PREFIX])
        merged = self.merge_down_layer(
            torch.cat([xyz_feat, x[..., N_PREFIX:]], dim=-1))
        l_xyz, l_feat, picks = x[..., 0:3], merged, []
        for module in self.SA_modules:
            l_xyz, l_feat, idx = module(l_xyz, l_feat)
            picks.append(idx)
        shared = l_feat[:, 0, :]
        return (self.cls_layers(shared, generator).reshape(B, R, -1),
                self.reg_layers(shared, generator).reshape(B, R, -1), picks)

    def decode(self, rcnn_reg, rois):
        return decode_in_roi_frame(self.box_coder, rcnn_reg, rois)

    def forward(self, batch):
        """The proposals, in training with 'gt_boxes' the sampled RoIs and
        their targets, their refinement and the decoded boxes. Adds
        'roi_head_ret' (rcnn_cls, rcnn_reg, rois, targets or None, the
        refined 'batch_box_preds'), 'rois', 'roi_scores', 'roi_valid' and
        'roi_sa_idx'; in eval, for ``post_processing``, 'batch_box_preds'
        (B, R, 7), 'batch_cls_preds' (B, R, num_class) logits,
        'batch_roi_labels' and 'has_class_labels' (the point head had more
        than one class channel, ``roi_head_template.py:102``). Training
        reads the step's generators from ``batch['rngs']``: 'roi_sampling'
        for the RoI draws (with 'gt_boxes') and 'dropout' for the towers
        (``runtime.trainer.step_rngs``)."""
        has_class_labels = batch['batch_cls_preds'].shape[-1] > 1
        rois, roi_scores, roi_labels, roi_valid = self.proposal_layer(batch)
        rngs = batch.get('rngs', {}) if self.training else {}
        targets = None
        if self.training and 'gt_boxes' in batch:
            B, R, _ = rois.shape
            draws = draw_roi_sampling(
                rngs['roi_sampling'], B, R,
                int(self.model_cfg.TARGET_CONFIG.ROI_PER_IMAGE), rois.device)
            targets = proposal_target_layer(
                draws, rois, roi_scores, roi_labels, roi_valid,
                batch['gt_boxes'], self.model_cfg.TARGET_CONFIG)
            rois, roi_labels = targets.rois, targets.roi_labels
            roi_scores = targets.roi_scores
            roi_valid = roi_valid.gather(1, targets.sampled)
        rcnn_cls, rcnn_reg, picks = self.refine(self.roipool(batch, rois),
                                                rngs.get('dropout'))
        decoded = self.decode(rcnn_reg, rois)
        batch = dict(batch)
        batch['roi_head_ret'] = {'rcnn_cls': rcnn_cls, 'rcnn_reg': rcnn_reg,
                                 'rois': rois, 'targets': targets,
                                 'batch_box_preds': decoded}
        batch.update(rois=rois, roi_scores=roi_scores, roi_valid=roi_valid,
                     roi_sa_idx=picks)
        if not self.training:
            batch.update(batch_box_preds=decoded, batch_cls_preds=rcnn_cls,
                         batch_roi_labels=roi_labels,
                         has_class_labels=has_class_labels,
                         cls_preds_normalized=False)
        return batch


def pointrcnn_head_loss(ret, loss_cfg, box_coder):
    """RoI head loss (``spsnet_tpu/models/roi_heads/pointrcnn_head.py:
    164-208``; ``roi_head_template.py:136-232``): the binary cross entropy
    of the sampled RoIs against their (possibly soft) labels, -1 ignored;
    the smooth-L1 of the residuals of the RoIs above REG_FG_THRESH against
    ``box_coder.encode`` of their gt in the RoI's frame, the RoI at the
    origin with zero heading as the anchor; with
    CORNER_LOSS_REGULARIZATION, the corner loss of the refined boxes
    against the gt in the lidar frame. Returns (loss, tb)."""
    lw = loss_cfg.LOSS_WEIGHTS
    t = ret['targets']
    B, R = t.rcnn_cls_labels.shape
    tb = {}
    labels = t.rcnn_cls_labels
    care = (labels >= 0).float()
    bce = loss_utils.sigmoid_cross_entropy_with_logits(
        ret['rcnn_cls'].reshape(B, R), labels.clamp(0.0, 1.0))
    cls_loss = (bce * care).sum() / care.sum().clamp(min=1.0) * \
        lw['rcnn_cls_weight']
    tb['rcnn_loss_cls'] = cls_loss

    code_size = box_coder.code_size
    rois = t.rois[..., :code_size]
    anchors = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:6],
                         torch.zeros_like(rois[..., 6:7]), rois[..., 7:]],
                        dim=-1)
    reg_targets = box_coder.encode(t.gt_of_rois[..., :code_size], anchors)
    fg = t.reg_valid_mask.float()
    fg_sum = fg.sum().clamp(min=1.0)
    reg_loss = loss_utils.weighted_smooth_l1(
        ret['rcnn_reg'].reshape(B, R, code_size), reg_targets,
        code_weights=lw.get('code_weights', None))
    reg_loss = (reg_loss * fg[..., None]).sum() / fg_sum * \
        lw['rcnn_reg_weight']
    tb['rcnn_loss_reg'] = reg_loss

    total = cls_loss + reg_loss
    if loss_cfg.get('CORNER_LOSS_REGULARIZATION', False):
        corner = loss_utils.get_corner_loss_lidar(
            ret['batch_box_preds'].reshape(B * R, -1)[:, :7],
            t.gt_of_rois_src[..., :7].reshape(B * R, 7))
        corner_loss = (corner * fg.reshape(-1)).sum() / fg_sum * \
            lw['rcnn_corner_weight']
        tb['rcnn_loss_corner'] = corner_loss
        total = total + corner_loss
    tb['rcnn_loss'] = total
    return total, tb
