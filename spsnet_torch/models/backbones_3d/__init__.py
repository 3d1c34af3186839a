"""3-D backbone registry (``pcdet/models/backbones_3d/__init__.py``)."""
from .iassd_backbone import IASSDBackbone

# one class: USE_SURFACE and the stds come from the config and the batch
BACKBONES_3D = {'IASSD_Backbone': IASSDBackbone,
                'PAGNet_Backbone': IASSDBackbone}
