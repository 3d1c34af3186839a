"""PointPillars (``detectors/pointpillar.py``, as
``spsnet_tpu/models/detectors/pointpillar.py:17-67``): PillarVFE over the
host's pillars (``data.processor.voxel_batch`` of a config with no sparse
plan) or DynamicPillarVFE over the raw points, PointPillarScatter,
BaseBEVBackbone and AnchorHeadSingle (or AnchorHeadMulti, nuScenes'
cbgs_pp_multihead.yaml), on the grid ``round((range end - range start) /
voxel size)``, one pillar high. The caller runs
``detector3d.post_processing``; in training with 'gt_boxes' the head
assigns its anchor targets and ``loss`` is ``anchor_head_loss``.
"""
from __future__ import annotations

from .second_net import SECONDNet


class PointPillar(SECONDNet):
    """SECOND's stage with the pillar trunk: the config has no
    BACKBONE_3D (``second_net.pillar_trunk``)."""
