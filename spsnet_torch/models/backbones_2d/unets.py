"""The generic image U-Net of the ``U_Net`` BACKBONE_2D slot (port of
``spsnet_tpu/models/backbones_2d/unets.py``; reference
``backbones_2d/unets.py:46-122``), NCHW: a five-level encoder-decoder of
``ConvBlock`` (two Conv 3 x 3 + BatchNorm + ReLU), 2 x 2 max pools,
``UpConv`` (nearest 2x upsample + Conv 3 x 3 + BatchNorm + ReLU) and a
final 1 x 1 conv to ``out_ch``. The filter pyramid is always [16, 32, 64,
128, 256] (the reference overrides its ``in_ch``); the first conv takes
``in_ch`` channels. BatchNorm at eps 1e-5 and momentum 0.1 (flax 0.9).
Registered, as in the reference, but named by no config; its forward
takes and returns maps, not the batch dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNormNCHW

FILTERS = (16, 32, 64, 128, 256)


class ConvBlock(nn.Module):
    """``conv0``, ``bn0``, ``conv1``, ``bn1`` (``unets.py:7-26``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn0 = BatchNormNCHW(out_ch, eps=1e-5, momentum=0.1)
        self.conv1 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.bn1 = BatchNormNCHW(out_ch, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


class UpConv(nn.Module):
    """Nearest 2x upsample, ``conv``, ``bn``, ReLU (``unets.py:28-44``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn = BatchNormNCHW(out_ch, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode='nearest')
        return F.relu(self.bn(self.conv(x)))


class UNet(nn.Module):
    """``U_Net``: (B, in_ch, H, W) -> (B, out_ch, H, W), H and W
    multiples of 16."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1):
        super().__init__()
        widths = (in_ch,) + FILTERS
        for i, f in enumerate(FILTERS):
            self.add_module(f'enc{i + 1}', ConvBlock(widths[i], f))
        for i in range(len(FILTERS) - 1, 0, -1):
            self.add_module(f'up{i + 1}', UpConv(FILTERS[i], FILTERS[i - 1]))
            self.add_module(f'dec{i + 1}',
                            ConvBlock(2 * FILTERS[i - 1], FILTERS[i - 1]))
        self.out_conv = nn.Conv2d(FILTERS[0], out_ch, 1)

    def forward(self, x):
        skips = []
        for i in range(len(FILTERS)):
            if i > 0:
                x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f'enc{i + 1}')(x)
            skips.append(x)
        for i in range(len(FILTERS) - 1, 0, -1):
            x = getattr(self, f'up{i + 1}')(x)
            x = getattr(self, f'dec{i + 1}')(torch.cat([skips[i - 1], x], 1))
        return self.out_conv(x)
