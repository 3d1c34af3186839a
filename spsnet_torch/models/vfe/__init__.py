"""Voxel feature encoders (``pcdet/models/backbones_3d/vfe``)."""
from .mean_vfe import MeanVFE

__all__ = ['MeanVFE']
