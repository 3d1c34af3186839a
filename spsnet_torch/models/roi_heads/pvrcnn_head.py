"""PV-RCNN's RoI-grid head (``roi_heads/pvrcnn_head.py``, as
``spsnet_tpu/models/roi_heads/pvrcnn_head.py:26-200``).

The proposals are the anchor head's boxes after class-agnostic NMS at
NMS_CONFIG.TRAIN in training, TEST in eval; in training with gt the RoI
target sampling (``roi_utils.proposal_target_layer``, its draws from the
step's 'roi_sampling' generator) replaces them with ROI_PER_IMAGE RoIs a
frame (``pointrcnn_head.sample_roi_targets``). Each RoI carries a GRID_SIZE^3 lattice of points (cell
centers of the box in its frame, rotated and moved to the world); each
grid point groups the keypoints, their features weighted by the detached
point scores, by MSG ball query (one fused K2 launch for both radii on the
card) with the stack grouping's empty balls zeroed, a SharedMLP and a max.
The pooled (R, G^3, C) features are flattened channel-major, the layout
``shared_fc``'s first weight is laid out for, then the shared FC stack
(a Dropout after each layer but the last) and the cls and reg towers (a
Dropout after their first block, masks from the step's 'dropout'
generator) refine each RoI, decoded in its frame. Where ROI_GRID_POOL
names VectorPoolAggregationModuleMSG (PV-RCNN++) the grid points pool the
keypoints by VectorPool aggregation instead, the invalid keypoints moved
to 1e6 first (``pvrcnn_head.py:51-56, 104-111``). PV-RCNN++ calls
``propose_and_assign`` before its keypoints (their sampling needs the
RoIs) and hands its result to ``forward(batch, precomputed)``. As in the
JAX package the RoIs keep their gradient (into the grid points, the
regression targets and the corner loss's decode); only the point scores
are detached. The loss is PointRCNN's ``pointrcnn_head_loss``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils import box_coder as box_coder_lib
from ...utils.common import rotate_points_along_z
from ..blocks import MLPHead, SharedMLP
from ..pfe.voxel_set_abstraction import source_group
from .pointrcnn_head import (decode_in_roi_frame, proposal_layer,
                             sample_roi_targets)


def grid_template(grid_size: int):
    """(G^3, 3) float32 cell centers of the unit box in [-0.5, 0.5]^3,
    the first axis slowest."""
    idx = np.stack(np.meshgrid(*[np.arange(grid_size)] * 3, indexing='ij'),
                   axis=-1).reshape(-1, 3).astype(np.float32)
    return (idx + np.float32(0.5)) / np.float32(grid_size) - np.float32(0.5)


def roi_grid_points(rois, template):
    """(B, R, 7) RoIs, (G^3, 3) template -> (B, R, G^3, 3) world-frame grid
    points (``get_global_grid_points_of_roi``)."""
    B, R, _ = rois.shape
    local = template[None, None] * rois[:, :, None, 3:6]
    rot = rotate_points_along_z(local.reshape(B * R, -1, 3),
                                rois[..., 6].reshape(B * R))
    return rot.reshape(B, R, -1, 3) + rois[:, :, None, 0:3]


class PVRCNNHead(nn.Module):
    """Submodules ``roi_grid_pool_layer`` (``mlps.{i}``, or PV-RCNN++'s
    VectorPool groups), ``shared_fc_layer``, ``cls_layers`` and
    ``reg_layers``, as the reference's; ``input_channels``: the keypoint
    features'."""

    def __init__(self, model_cfg, num_class: int, input_channels: int):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.box_coder = box_coder_lib.build_box_coder(
            model_cfg.TARGET_CONFIG.BOX_CODER)
        pool = model_cfg.ROI_GRID_POOL
        self.grid_size = int(pool.GRID_SIZE)
        self.register_buffer('template', torch.from_numpy(
            grid_template(self.grid_size)), persistent=False)
        self.use_vector_pool = \
            str(pool.get('NAME', '')) == 'VectorPoolAggregationModuleMSG'
        self.roi_grid_pool_layer = source_group(
            pool, int(pool.get('IN_CHANNEL', 90)) if self.use_vector_pool
            else input_channels)
        dp = float(model_cfg.get('DP_RATIO', 0.0))
        shared = list(model_cfg.SHARED_FC)
        self.shared_fc_layer = SharedMLP(
            self.grid_size ** 3 * self.roi_grid_pool_layer.out_channels,
            shared, dropout=dp, dropout_idx=range(len(shared) - 1))
        c = self.shared_fc_layer.out_channels
        self.cls_layers = MLPHead(c, list(model_cfg.CLS_FC), num_class,
                                  dropout=dp, dropout_idx=(0,))
        self.reg_layers = MLPHead(c, list(model_cfg.REG_FC),
                                  self.box_coder.code_size * num_class,
                                  dropout=dp, dropout_idx=(0,))

    def roi_grid_pool(self, batch, rois):
        """(B, R, 7+) RoIs -> (B, R, C * G^3) pooled keypoint features,
        channel-major (``pvrcnn_head.py:155-158``)."""
        kp_feats = batch['point_features']
        if 'point_cls_scores' in batch:
            kp_feats = kp_feats * batch['point_cls_scores'].detach()[..., None]
        B, R, _ = rois.shape
        grid = roi_grid_points(rois[..., :7], self.template)
        kp = batch['point_coords']
        if self.use_vector_pool and 'point_valid' in batch:
            kp = torch.where(batch['point_valid'][..., None], kp, 1e6)
        pooled = self.roi_grid_pool_layer(kp, kp_feats,
                                          grid.reshape(B, -1, 3).contiguous())
        G3 = grid.shape[2]
        return pooled.reshape(B, R, G3, -1).transpose(2, 3).reshape(B, R, -1)

    def propose_and_assign(self, batch):
        """The proposals by class-agnostic NMS (NMS_CONFIG.TRAIN in
        training, TEST in eval) and, in training with 'gt_boxes', the
        sampled RoIs and their targets (the draws of the step's
        'roi_sampling' generator): {'rois', 'roi_labels', 'roi_valid',
        'targets' (None in eval)}."""
        nms = self.model_cfg.NMS_CONFIG
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            batch, nms.TRAIN if self.training else nms.TEST)
        targets = None
        if self.training and 'gt_boxes' in batch:
            targets, rois, roi_labels, _, roi_valid = sample_roi_targets(
                batch, rois, roi_scores, roi_labels, roi_valid,
                self.model_cfg.TARGET_CONFIG)
        return {'rois': rois, 'roi_labels': roi_labels,
                'roi_valid': roi_valid, 'targets': targets}

    def forward(self, batch, precomputed=None):
        """The proposals (``propose_and_assign``'s, or ``precomputed``),
        their refinement and the decoded boxes. Adds 'rois',
        'roi_valid' and 'roi_head_ret' (rcnn_cls, rcnn_reg, rois, targets
        or None, the refined 'batch_box_preds'); in eval, for
        ``post_processing``, 'batch_box_preds' (B, R, 7), 'batch_cls_preds'
        (B, R, num_class) logits, 'batch_roi_labels' and
        'has_class_labels' (the dense head had more than one class
        channel, ``roi_head_template.py:102``). Training reads the step's
        generators from ``batch['rngs']`` (``runtime.trainer.step_rngs``):
        'roi_sampling' for the RoI draws and 'dropout' for the FC
        stacks."""
        has_class_labels = batch['batch_cls_preds'].shape[-1] > 1
        pre = precomputed if precomputed is not None else \
            self.propose_and_assign(batch)
        rois, roi_labels = pre['rois'], pre['roi_labels']
        roi_valid, targets = pre['roi_valid'], pre['targets']
        rngs = batch.get('rngs', {}) if self.training else {}
        dropout = rngs.get('dropout')
        shared = self.shared_fc_layer(self.roi_grid_pool(batch, rois),
                                      dropout)
        rcnn_cls = self.cls_layers(shared, dropout)
        rcnn_reg = self.reg_layers(shared, dropout)
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
