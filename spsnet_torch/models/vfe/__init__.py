"""Voxel feature encoders (``pcdet/models/backbones_3d/vfe``), by the
registry names of ``spsnet_tpu/models/vfe/__init__.py`` (``DynPillarVFE``
is the name cbgs_dyn_pp_centerpoint.yaml uses)."""
from .dynamic_pillar_vfe import DynamicPillarVFE
from .mean_vfe import MeanVFE
from .pillar_vfe import PillarVFE

PILLAR_VFES = {'PillarVFE': PillarVFE, 'DynamicPillarVFE': DynamicPillarVFE,
               'DynPillarVFE': DynamicPillarVFE}

__all__ = ['DynamicPillarVFE', 'MeanVFE', 'PillarVFE', 'PILLAR_VFES']
