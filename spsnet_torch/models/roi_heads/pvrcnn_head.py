"""PV-RCNN's RoI-grid head, eval (``roi_heads/pvrcnn_head.py``, as
``spsnet_tpu/models/roi_heads/pvrcnn_head.py:26-200``).

The proposals are the anchor head's boxes after class-agnostic NMS at
NMS_CONFIG.TEST. Each RoI carries a GRID_SIZE^3 lattice of points (cell
centers of the box in its frame, rotated and moved to the world); each
grid point groups the keypoints, their features weighted by the detached
point scores, by MSG ball query (one fused K2 launch for both radii on the
card) with the stack grouping's empty balls zeroed, a SharedMLP and a max.
The pooled (R, G^3, C) features are flattened channel-major, the layout
``shared_fc``'s first weight is laid out for, then the shared FC stack
(a Dropout after each layer but the last) and the cls and reg towers (a
Dropout after their first block) refine each RoI, decoded in its frame.
Training (the RoI targets at NMS_CONFIG.TRAIN) waits for its slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils import box_coder as box_coder_lib
from ...utils.common import rotate_points_along_z
from ..blocks import MLPHead, SharedMLP
from ..pfe.voxel_set_abstraction import StackSAGroup
from .pointrcnn_head import decode_in_roi_frame, proposal_layer


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
    """Submodules ``roi_grid_pool_layer`` (``mlps.{i}``),
    ``shared_fc_layer``, ``cls_layers`` and ``reg_layers``, as the
    reference's; ``input_channels``: the keypoint features'."""

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
        self.roi_grid_pool_layer = StackSAGroup(pool, input_channels)
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
        pooled = self.roi_grid_pool_layer(
            batch['point_coords'], kp_feats,
            grid.reshape(B, -1, 3).contiguous())
        G3 = grid.shape[2]
        return pooled.reshape(B, R, G3, -1).transpose(2, 3).reshape(B, R, -1)

    def forward(self, batch):
        """Eval: the proposals, their refinement and the decoded boxes.
        Adds 'rois', 'roi_valid', 'roi_head_ret' and, for
        ``post_processing``, 'batch_box_preds' (B, R, 7), 'batch_cls_preds'
        (B, R, num_class) logits, 'batch_roi_labels' and
        'has_class_labels' (the anchor head had more than one class
        channel, ``roi_head_template.py:102``)."""
        if self.training:
            raise NotImplementedError(
                'PV-RCNN training (RoI targets, the losses of its heads): the '
                'port serves PV-RCNN; its training is on the ROADMAP')
        has_class_labels = batch['batch_cls_preds'].shape[-1] > 1
        rois, _, roi_labels, roi_valid = proposal_layer(
            batch, self.model_cfg.NMS_CONFIG.TEST)
        shared = self.shared_fc_layer(self.roi_grid_pool(batch, rois))
        rcnn_cls = self.cls_layers(shared)
        rcnn_reg = self.reg_layers(shared)
        decoded = decode_in_roi_frame(self.box_coder, rcnn_reg, rois)
        return dict(batch, rois=rois, roi_valid=roi_valid,
                    roi_head_ret={'rcnn_cls': rcnn_cls, 'rcnn_reg': rcnn_reg,
                                  'rois': rois, 'batch_box_preds': decoded},
                    batch_box_preds=decoded, batch_cls_preds=rcnn_cls,
                    batch_roi_labels=roi_labels,
                    has_class_labels=has_class_labels,
                    cls_preds_normalized=False)
