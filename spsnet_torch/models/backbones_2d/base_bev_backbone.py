"""SECOND's BEV conv / deconv pyramid (``base_bev_backbone.py:6-112``, as
``spsnet_tpu/models/backbones_2d/base_bev_backbone.py:12-60``), NCHW.

Submodules as the reference's: ``blocks.{i}`` is ZeroPad2d(1), Conv2d (the
level's stride), BatchNorm, ReLU, then LAYER_NUMS[i] times Conv2d (pad 1),
BatchNorm, ReLU; ``deblocks.{i}`` ConvTranspose2d (kernel = stride), BatchNorm,
ReLU. BatchNorm at eps 1e-3 and momentum 0.01 (flax's 0.99), its running
variance moving toward the biased variance in training as flax's does
(``blocks.BatchNormNCHW``; ``nn.BatchNorm2d`` takes the unbiased). A flax
``ConvTranspose`` (``transpose_kernel=False``) with kernel = stride puts
input i at output s * i + r through kernel tap s - 1 - r, torch's through
tap r: the weight bridge flips the kernel (``utils/weights.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..blocks import BatchNormNCHW


class BaseBEVBackbone(nn.Module):

    def __init__(self, model_cfg, input_channels: int):
        super().__init__()
        layer_nums = list(model_cfg.get('LAYER_NUMS', []))
        strides = list(model_cfg.get('LAYER_STRIDES', []))
        filters = list(model_cfg.get('NUM_FILTERS', []))
        up_strides = list(model_cfg.get('UPSAMPLE_STRIDES', []))
        up_filters = list(model_cfg.get('NUM_UPSAMPLE_FILTERS', []))
        if any(s < 1 for s in up_strides):
            raise NotImplementedError(
                'BaseBEVBackbone with an UPSAMPLE_STRIDE below 1 (a strided '
                'Conv2d deblock): ROADMAP Queue 1 item F')
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        c = input_channels
        for i, n_layers in enumerate(layer_nums):
            layers = [nn.ZeroPad2d(1),
                      nn.Conv2d(c, filters[i], 3, stride=strides[i],
                                bias=False), BatchNormNCHW(filters[i]),
                      nn.ReLU()]
            for _ in range(n_layers):
                layers += [nn.Conv2d(filters[i], filters[i], 3, padding=1,
                                     bias=False), BatchNormNCHW(filters[i]),
                           nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            c = filters[i]
            if i < len(up_strides):
                s = int(up_strides[i])
                self.deblocks.append(nn.Sequential(
                    nn.ConvTranspose2d(c, up_filters[i], s, stride=s,
                                       bias=False),
                    BatchNormNCHW(up_filters[i]), nn.ReLU()))
        self.num_bev_features = sum(up_filters[:len(layer_nums)]) \
            if up_strides else c

    def forward(self, batch):
        """'spatial_features' (B, C, H, W) -> adds 'spatial_features_2d',
        the deblocks' outputs concatenated along channels."""
        x = batch['spatial_features']
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < len(self.deblocks):
                ups.append(self.deblocks[i](x))
        if ups:
            x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return dict(batch, spatial_features_2d=x)
