"""RoI heads of the two-stage detectors."""
from .pointrcnn_head import PointRCNNHead
from .pvrcnn_head import PVRCNNHead

__all__ = ['PointRCNNHead', 'PVRCNNHead']
