"""Map-to-BEV modules of the pillar detectors and CaDDN
(``HeightCompression``, the voxel detectors', lives with the sparse
backbone)."""
from .conv2d_collapse import Conv2DCollapse
from .pointpillar_scatter import PointPillarScatter

__all__ = ['Conv2DCollapse', 'PointPillarScatter']
