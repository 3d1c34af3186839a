"""RoI heads of the two-stage point detectors."""
from .pointrcnn_head import PointRCNNHead

__all__ = ['PointRCNNHead']
