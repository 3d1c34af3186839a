"""AL_3D, the dual-branch (BEV pillars + spherical range view) 2.5D
backbone (port of ``spsnet_tpu/models/backbones_3d/al_3d.py:29``;
reference ``backbones_3d/AL_3D.py``), NCHW:

- the points' first four channels are embedded (``range_embed``, a Linear
  without bias) and scatter-maxed into a spherical range image; the
  pillar BEV map arrives as 'spatial_features' (``Sparse2BEV``);
- both grids run CP-UNets (``bev_unet``; ``range_unet``, width-only
  pooling); ``fusion`` takes the range pyramid back to the BEV through
  the points;
- the per-point semantic logits 'sem_pred' (B, N, SEM_CLS) come from the
  bilinear gathers of both U-Nets' outputs through ``cls_fc1``, ReLU,
  Dropout(0.5), ``cls_fc2``, ReLU, Dropout(0.5), ``cls_out``;
- the detection features 'spatial_features' are concat(BEV ``d0``, the
  fusion) at a quarter of the BEV resolution.

The dropout masks come from the step's generator
(``batch['rngs']['dropout']``, ``runtime.trainer.step_rngs``); an
optional 'points_valid' (B, N) masks padded points out of both
projections.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones_2d import projection
from ..backbones_2d.al_2d import CPUnet, FusionBlock
from ..blocks import Dropout


class AL3D(nn.Module):

    def __init__(self, model_cfg):
        super().__init__()
        cfg = model_cfg
        n_range = int(cfg.get('NUM_RANGE_FEATURES', 16))
        n_bev = int(cfg.get('NUM_BEV_FEATURES', 64))
        n_range_seg = int(cfg.get('NUM_RANGE_SEG_FEATURES', 64))
        n_bev_seg = int(cfg.get('NUM_BEV_SEG_FEATURES', 64))
        n_fusion = int(cfg.get('NUM_FUSION_FEATURES', 128))
        self.pc_range = tuple(float(v) for v in cfg.POINT_CLOUD_RANGE)
        self.v_fov = projection.process_fov(list(cfg.PC_FOV))
        self.bev_shape = tuple(int(v) for v in cfg.BEV_SHAPE)
        self.range_shape = tuple(int(v) for v in cfg.RANGE_SHAPE)
        self.range_embed = nn.Linear(4, n_range, bias=False)
        self.range_unet = CPUnet(n_range, n_range_seg, range_view=True)
        self.bev_unet = CPUnet(n_bev, n_bev_seg)
        self.fusion = FusionBlock(n_fusion, self.bev_shape)
        self.cls_fc1 = nn.Linear(n_bev_seg + n_range_seg, 128)
        self.cls_fc2 = nn.Linear(128, 64)
        self.cls_out = nn.Linear(64, int(cfg.get('SEM_CLS', 4)))
        self.cls_drop1 = Dropout(0.5)
        self.cls_drop2 = Dropout(0.5)
        # the detection features' channels: BEV d0 and the fusion's
        self.num_bev_features = 4 * n_bev + n_fusion // 2

    def coords(self, batch):
        """The points' BEV and range (u, v, keep), each masked by
        'points_valid' where the batch has it."""
        points = batch['points']
        bev = projection.bev_coords(points, self.pc_range, self.bev_shape)
        rng = projection.range_coords(points, self.v_fov, self.range_shape)
        valid = batch.get('points_valid', None)
        if valid is not None:
            bev = (*bev[:2], bev[2] & valid)
            rng = (*rng[:2], rng[2] & valid)
        return bev, rng

    def semantic(self, encode_bev, encode_range, bev_uvk, rng_uvk,
                 dropout=None):
        """The per-point semantic logits (B, N, SEM_CLS) from both U-Nets'
        outputs gathered at the points (``dropout``: the step's generator
        in training)."""
        sem = torch.cat([projection.g2p_bilinear(encode_bev, *bev_uvk),
                         projection.g2p_bilinear(encode_range, *rng_uvk)],
                        -1)
        sem = self.cls_drop1(F.relu(self.cls_fc1(sem)), dropout)
        sem = self.cls_drop2(F.relu(self.cls_fc2(sem)), dropout)
        return self.cls_out(sem)

    def forward(self, batch):
        """'points' (B, N, 4+) and 'spatial_features' (B, C, H, W) -> adds
        'sem_pred' and replaces 'spatial_features' with the detection
        features (B, 4 C + NUM_FUSION_FEATURES / 2, H / 4, W / 4)."""
        bev_uvk, rng_uvk = self.coords(batch)
        dropout = batch.get('rngs', {}).get('dropout') if self.training \
            else None
        range_pw = self.range_embed(batch['points'][..., :4])
        ori_range = projection.p2g_max(range_pw, *rng_uvk, self.range_shape)
        encode_bev, bev_dict = self.bev_unet(batch['spatial_features'])
        encode_range, range_dict = self.range_unet(ori_range)
        rv_fusion = self.fusion(range_dict, rng_uvk, bev_uvk)
        return dict(batch, sem_pred=self.semantic(
            encode_bev, encode_range, bev_uvk, rng_uvk, dropout),
            spatial_features=torch.cat([bev_dict['d0'], rv_fusion], 1))
