"""IA-SSD detector (``detectors/IASSD.py``, as in
``spsnet_tpu/models/detectors/iassd.py``): backbone + point head. The
caller runs the post-processing NMS (``detector3d.class_agnostic_nms_batch``)."""
from __future__ import annotations

from torch import nn

from ..backbones_3d.iassd_backbone import IASSDBackbone
from ..dense_heads.iassd_head import IASSDHead


class IASSD(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int = 4):
        super().__init__()
        for key, name, want in (('BACKBONE_3D', model_cfg.BACKBONE_3D.NAME,
                                 'IASSD_Backbone'),
                                ('POINT_HEAD', model_cfg.POINT_HEAD.NAME,
                                 'IASSD_Head')):
            if name != want:
                raise NotImplementedError(
                    f'{key} {name}: only {want} is ported to IASSD')
        self.backbone_3d = IASSDBackbone(model_cfg.BACKBONE_3D, num_class,
                                         input_channels)
        self.point_head = IASSDHead(model_cfg.POINT_HEAD, num_class,
                                    self.backbone_3d.num_point_features)

    def forward(self, batch):
        """batch: dict with 'points' (B, N, 3 + C). Returns the batch with
        the backbone outputs, 'batch_cls_preds' (B, M, num_class) logits and
        'batch_box_preds' (B, M, 7)."""
        if self.training:
            raise NotImplementedError(
                'the IA-SSD train step is ROADMAP Queue 1 item 5; call '
                '.eval() for inference')
        return self.point_head(self.backbone_3d(batch))
