"""Map-to-BEV modules of the pillar detectors (``HeightCompression``, the
voxel detectors', lives with the sparse backbone)."""
from .pointpillar_scatter import PointPillarScatter

__all__ = ['PointPillarScatter']
