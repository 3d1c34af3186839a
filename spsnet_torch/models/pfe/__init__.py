"""Point feature extractors (``pcdet/models/backbones_3d/pfe``)."""
from .voxel_set_abstraction import VoxelSetAbstraction

__all__ = ['VoxelSetAbstraction']
