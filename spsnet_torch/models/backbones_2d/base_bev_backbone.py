"""SECOND's BEV conv / deconv pyramid (``base_bev_backbone.py:6-112``, as
``spsnet_tpu/models/backbones_2d/base_bev_backbone.py:12-60``), and the
AL family's range / BEV attention fusion ``RBFusion`` (``:63-103``), NCHW.

Submodules as the reference's: ``blocks.{i}`` is ZeroPad2d(1), Conv2d (the
level's stride), BatchNorm, ReLU, then LAYER_NUMS[i] times Conv2d (pad 1),
BatchNorm, ReLU; ``deblocks.{i}`` ConvTranspose2d (kernel = stride), BatchNorm,
ReLU, or for an UPSAMPLE_STRIDE s below 1 (nuScenes' pillar CenterPoint)
a Conv2d of kernel and stride 1 / s (``StridedDeblock``). BatchNorm at
eps 1e-3 and momentum 0.01 (flax's 0.99), its running
variance moving toward the biased variance in training as flax's does
(``blocks.BatchNormNCHW``; ``nn.BatchNorm2d`` takes the unbiased). A flax
``ConvTranspose`` (``transpose_kernel=False``) with kernel = stride puts
input i at output s * i + r through kernel tap s - 1 - r, torch's through
tap r: the weight bridge flips the kernel (``utils/weights.py``), but not
a ``StridedDeblock``'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNormNCHW, Dropout


class StridedDeblock(nn.Conv2d):
    """The deblock of an UPSAMPLE_STRIDE below 1: a bias-free Conv2d of
    kernel and stride k = round(1 / s), padded as flax's 'SAME' padding
    pads it (``spsnet_tpu/models/backbones_2d/base_bev_backbone.py:46-50``):
    none where k divides the map's side, else k - side % k split with the
    larger half after."""

    def __init__(self, in_channels: int, out_channels: int, k: int):
        super().__init__(in_channels, out_channels, k, stride=k, bias=False)

    def forward(self, x):
        k = self.stride[0]
        pad = [(-side) % k for side in x.shape[-2:]]
        if any(pad):
            x = F.pad(x, (pad[1] // 2, pad[1] - pad[1] // 2,
                          pad[0] // 2, pad[0] - pad[0] // 2))
        return super().forward(x)


class BaseBEVBackbone(nn.Module):

    def __init__(self, model_cfg, input_channels: int):
        super().__init__()
        layer_nums = list(model_cfg.get('LAYER_NUMS', []))
        strides = list(model_cfg.get('LAYER_STRIDES', []))
        filters = list(model_cfg.get('NUM_FILTERS', []))
        up_strides = list(model_cfg.get('UPSAMPLE_STRIDES', []))
        up_filters = list(model_cfg.get('NUM_UPSAMPLE_FILTERS', []))
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
                s = up_strides[i]
                up = nn.ConvTranspose2d(c, up_filters[i], int(s), stride=int(
                    s), bias=False) if s >= 1 else StridedDeblock(
                        c, up_filters[i], int(round(1 / s)))
                self.deblocks.append(nn.Sequential(
                    up, BatchNormNCHW(up_filters[i]), nn.ReLU()))
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


class RBFusion(nn.Module):
    """Range / BEV attention fusion (``RB_Fusion``,
    ``base_bev_backbone.py:114-177``): the [BEV | range] map
    'spatial_features' (B, BEV_DIM + RANGE_DIM, H, W) gated by a channel
    attention (each half's global mean and max through ``channel_fc1``,
    ReLU, ``Dropout(0.2)`` and ``channel_fc2``) and a spatial attention
    (``space_conv``, 3 x 3, over each half's channel mean and max), plus
    the map itself, as 'spatial_features_2d'. The maxima are ``amax``
    (their gradient split among ties, as JAX's); the dropout mask comes
    from the step's generator (``batch['rngs']['dropout']``)."""

    def __init__(self, model_cfg, input_channels: int = 0):
        super().__init__()
        self.bev_dim = int(model_cfg.BEV_DIM)
        range_dim = int(model_cfg.RANGE_DIM)
        c = self.bev_dim + range_dim
        self.channel_fc1 = nn.Linear(2 * c, self.bev_dim, bias=False)
        self.dropout = Dropout(0.2)
        self.channel_fc2 = nn.Linear(self.bev_dim, c)
        self.space_conv = nn.Conv2d(4, 1, 3, padding=1)
        self.num_bev_features = c

    def forward(self, batch):
        x = batch['spatial_features']
        bev, rng = x[:, :self.bev_dim], x[:, self.bev_dim:]
        channel = torch.cat([bev.mean(dim=(2, 3)), rng.mean(dim=(2, 3)),
                             bev.amax(dim=(2, 3)), rng.amax(dim=(2, 3))], 1)
        channel = self.dropout(F.relu(self.channel_fc1(channel)),
                               batch.get('rngs', {}).get('dropout'))
        channel = torch.sigmoid(self.channel_fc2(channel))[..., None, None]
        space = torch.stack([bev.mean(dim=1), rng.mean(dim=1),
                             bev.amax(dim=1), rng.amax(dim=1)], 1)
        space = torch.sigmoid(self.space_conv(space))
        return dict(batch, spatial_features_2d=space * (channel * x) + x)
