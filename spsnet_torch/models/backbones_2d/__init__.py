"""2-D backbones (``pcdet/models/backbones_2d``), by the registry names of
``spsnet_tpu/models/backbones_2d/__init__.py``: U_Net and CP_Unet are
registered there too, though no config names them (the AL 3D backbone
builds its CP-UNets itself)."""
from .al_2d import CPUnet
from .base_bev_backbone import BaseBEVBackbone, RBFusion
from .unets import UNet

BACKBONES_2D = {'BaseBEVBackbone': BaseBEVBackbone, 'RB_Fusion': RBFusion,
                'RBFusion': RBFusion, 'U_Net': UNet, 'CP_Unet': CPUnet}


def build_backbone_2d(name, **kwargs):
    return BACKBONES_2D[name](**kwargs)


__all__ = ['BACKBONES_2D', 'BaseBEVBackbone', 'CPUnet', 'RBFusion', 'UNet',
           'build_backbone_2d']
