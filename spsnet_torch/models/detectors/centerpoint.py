"""CenterPoint (``detectors/centerpoint.py``, as
``spsnet_tpu/models/detectors/centerpoint.py`` builds it): with
BACKBONE_3D the voxel trunk, MeanVFE, VoxelBackBone8x or
VoxelResBackBone8x over the host plan and HeightCompression; without it
the pillar trunk, PillarVFE over the host's pillars or DynamicPillarVFE
over the raw points, and PointPillarScatter. Then BaseBEVBackbone and
``CenterHeadIoU`` (with
CLASS_NAMES_EACH_HEAD, or a DENSE_HEAD named CenterHeadIoU) or else the
plain ``CenterHead``. With CenterHeadIoU a request ends at the head: its
'final_boxes', 'final_scores', 'final_labels' and 'final_valid' are the
detections (``detector3d.head_detections``); the configs' POST_PROCESSING
holds no NMS, and the head skips its decode in training. The plain head's
top-K boxes go through ``detector3d.post_processing``. In training with
'gt_boxes' the head assigns its heatmap targets and ``loss`` is its loss.
"""
from __future__ import annotations

from .second_net import SECONDNet


class CenterPoint(SECONDNet):

    train_decode = False

    @staticmethod
    def plain_center_head(head_cfg) -> bool:
        return head_cfg.NAME != 'CenterHeadIoU' and \
            head_cfg.get('CLASS_NAMES_EACH_HEAD', None) is None
