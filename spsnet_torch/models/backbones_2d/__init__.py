"""2-D (BEV) backbones (``pcdet/models/backbones_2d``)."""
from .base_bev_backbone import BaseBEVBackbone

__all__ = ['BaseBEVBackbone']
