"""IA-SSD detector (``detectors/IASSD.py``, as in
``spsnet_tpu/models/detectors/iassd.py``): backbone + point head; in
training, ``loss`` gives the head loss. The caller runs the
post-processing NMS (``detector3d.class_agnostic_nms_batch``). The backbone
and the head come from their registries, so the same class is also PAGNet
and SPSNet-IA (``spsnet_tpu/models/detectors/pagnet.py``): the PAGNet
backbone and the MLT head."""
from __future__ import annotations

from torch import nn

from ..backbones_3d import BACKBONES_3D
from ..dense_heads import POINT_HEADS
from ..dense_heads.iassd_head import iassd_head_loss


class IASSD(nn.Module):

    def __init__(self, model_cfg, num_class: int, input_channels: int = 4,
                 fps_seeding=None, msg_shared: bool = False):
        super().__init__()
        for key, name, ported in (
                ('BACKBONE_3D', model_cfg.BACKBONE_3D.NAME, BACKBONES_3D),
                ('POINT_HEAD', model_cfg.POINT_HEAD.NAME, POINT_HEADS)):
            if name not in ported:
                raise NotImplementedError(
                    f'{key} {name}: the port has {sorted(ported)}')
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.backbone_3d = BACKBONES_3D[model_cfg.BACKBONE_3D.NAME](
            model_cfg.BACKBONE_3D, num_class, input_channels, fps_seeding,
            msg_shared)
        self.point_head = POINT_HEADS[model_cfg.POINT_HEAD.NAME](
            model_cfg.POINT_HEAD, num_class,
            self.backbone_3d.num_point_features)

    def forward(self, batch, sampling_generator=None):
        """batch: dict with 'points' (B, N, 3 + C), optionally 'stds'
        (B, N) (SPSNet), and in training 'gt_boxes' (B, T, 8);
        ``sampling_generator``, a CPU ``torch.Generator``, feeds the Rand
        samplers (which raise without one; no train or eval step passes
        one, as JAX's steps give no 'sampling' stream). Returns the batch
        with the backbone outputs, 'batch_cls_preds' (B, M, num_class)
        logits, 'batch_box_preds' (B, M, 7) and the head's 'head_ret'
        (with targets in training)."""
        return self.point_head(self.backbone_3d(batch, sampling_generator))

    def loss(self, batch):
        """(loss, tb dict) of a forward's output in training mode."""
        head_cfg = self.model_cfg.POINT_HEAD
        sa_list = head_cfg.LOSS_CONFIG.get(
            'SAMPLE_METHOD_LIST',
            self.model_cfg.BACKBONE_3D.SA_CONFIG.SAMPLE_METHOD_LIST)
        return iassd_head_loss(batch['head_ret'], head_cfg.LOSS_CONFIG,
                               self.num_class, self.point_head.box_coder,
                               sa_centerness_mask=self.point_head
                               .sa_centerness_mask,
                               sample_method_list=sa_list)
