"""Point-head registry (``pcdet/models/dense_heads/__init__.py``)."""
from .iassd_head import IASSDHead, MLTSSDHead

POINT_HEADS = {'IASSD_Head': IASSDHead, 'MLT_SSD_Head': MLTSSDHead}
