"""RoI heads of the two-stage detectors."""
from .pointrcnn_head import PointRCNNHead
from .pvrcnn_head import PVRCNNHead
from .second_head import SECONDHead

__all__ = ['PointRCNNHead', 'PVRCNNHead', 'SECONDHead']
