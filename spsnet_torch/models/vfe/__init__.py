"""Voxel feature encoders (``pcdet/models/backbones_3d/vfe``), by the
registry names of ``spsnet_tpu/models/vfe/__init__.py`` (``DynPillarVFE``
is the name cbgs_dyn_pp_centerpoint.yaml uses); CaDDN's ``ImageVFE``
encodes camera images."""
from .dynamic_pillar_vfe import DynamicPillarVFE
from .image_vfe import ImageVFE
from .mean_vfe import MeanVFE
from .pillar_vfe import PillarVFE

PILLAR_VFES = {'PillarVFE': PillarVFE, 'DynamicPillarVFE': DynamicPillarVFE,
               'DynPillarVFE': DynamicPillarVFE}

__all__ = ['DynamicPillarVFE', 'ImageVFE', 'MeanVFE', 'PillarVFE',
           'PILLAR_VFES']
