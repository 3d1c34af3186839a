"""PV-RCNN++ (``detectors/pv_rcnn_plusplus.py``, as
``spsnet_tpu/models/detectors/pv_rcnn_plusplus.py:29-107``): PV-RCNN's
stages with the plain ``CenterHead`` as the dense head, and the proposals
(and in training the sampled RoIs) made before the keypoints, whose
sectorized proposal-centric sampling (SPC) needs them; the VSA's sources
and the RoI-grid pool use VectorPool aggregation. Forward order: MeanVFE,
VoxelBackBone8x or VoxelResBackBone8x, HeightCompression, BaseBEVBackbone,
CenterHead, ``PVRCNNHead.propose_and_assign`` (which reads the step's
'roi_sampling' generator in training), VoxelSetAbstraction,
PointHeadSimple, the RoI-grid head. ``loss`` (``PVRCNN.loss``) is
``center_head_loss`` + ``point_head_simple_loss`` +
``pointrcnn_head_loss``.
"""
from __future__ import annotations

from .pv_rcnn import PVRCNN


class PVRCNNPlusPlus(PVRCNN):

    @staticmethod
    def plain_center_head(head_cfg) -> bool:
        return True

    def forward(self, batch):
        """The voxel stack and the CenterHead's top-K boxes, the RoIs
        ('rois', 'roi_labels'), the keypoints around them, their scores
        and the RoI-grid head; 'batch_box_preds' (B, R, 7) and
        'batch_cls_preds' (B, R, 1) are the refined RoIs in eval."""
        batch = self.stage_one(batch)
        pre = self.roi_head.propose_and_assign(batch)
        batch = dict(batch, rois=pre['rois'], roi_labels=pre['roi_labels'])
        return self.roi_head(self.point_head(self.pfe(batch)), pre)
