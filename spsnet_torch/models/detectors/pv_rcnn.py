"""PV-RCNN, forward only (``detectors/pv_rcnn.py``, as
``spsnet_tpu/models/detectors/pv_rcnn.py:27-95``): SECOND's voxel stack for
the proposals, then VoxelSetAbstraction (keypoints), PointHeadSimple (their
scores) and PVRCNNHead (the RoI-grid refinement). The caller runs
``detector3d.post_processing``, whose labels then come from the RoIs.
"""
from __future__ import annotations

from ..dense_heads.point_head_simple import PointHeadSimple
from ..pfe.voxel_set_abstraction import VoxelSetAbstraction
from ..roi_heads.pvrcnn_head import PVRCNNHead
from .second_net import SECONDNet


class PVRCNN(SECONDNet):

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx,
                 fps_seeding=None):
        super().__init__(model_cfg, num_class, input_channels, voxel_size,
                         point_cloud_range, final_grid_zyx)
        self.pfe = VoxelSetAbstraction(
            model_cfg.PFE, voxel_size, point_cloud_range,
            self.num_bev_features, input_channels - 3, bev_stride=8,
            fps_seeding=fps_seeding)
        use_before = model_cfg.POINT_HEAD.get(
            'USE_POINT_FEATURES_BEFORE_FUSION', False)
        self.point_head = PointHeadSimple(
            model_cfg.POINT_HEAD, 1,
            self.pfe.num_point_features_before_fusion if use_before
            else self.pfe.num_point_features)
        self.roi_head = PVRCNNHead(
            model_cfg.ROI_HEAD,
            1 if model_cfg.ROI_HEAD.CLASS_AGNOSTIC else num_class,
            self.pfe.num_point_features)

    def forward(self, batch):
        """As SECOND's, then the keypoints, their scores and the RoI-grid
        head; 'batch_box_preds' (B, R, 7) and 'batch_cls_preds' (B, R, 1)
        are the refined RoIs."""
        batch = self.stage_one(batch)
        return self.roi_head(self.point_head(self.pfe(batch)))
