"""CenterPoint with the voxel trunk (``detectors/centerpoint.py``, as
``spsnet_tpu/models/detectors/centerpoint.py`` builds it when the config
has BACKBONE_3D): MeanVFE, VoxelBackBone8x or VoxelResBackBone8x over the
host plan, HeightCompression, BaseBEVBackbone and ``CenterHeadIoU`` (with
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

    def __init__(self, model_cfg, num_class: int, input_channels: int,
                 voxel_size, point_cloud_range, final_grid_zyx,
                 class_names=None):
        if model_cfg.get('BACKBONE_3D', None) is None:
            raise NotImplementedError(
                'CenterPoint over pillars (no BACKBONE_3D): ROADMAP Queue 1 '
                'item F5')
        super().__init__(model_cfg, num_class, input_channels, voxel_size,
                         point_cloud_range, final_grid_zyx, class_names)
