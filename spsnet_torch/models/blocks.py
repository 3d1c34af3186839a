"""Pointwise MLP stacks, channel-last.

The reference's ``Conv2d(1x1)+BatchNorm2d+ReLU`` stacks
(``pointnet2_modules.py:199-246``) are pointwise MLPs; here they are
``nn.Linear`` + BatchNorm over the last axis + ReLU on (..., C) tensors.
Each stack is an ``nn.Sequential`` laid out like the reference's, so the
parameter names match its state dict (Linear at 3k, BatchNorm at 3k+1, ReLU
at 3k+2, the biased output Linear last).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class BatchNormLast(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor, statistics over all
    leading dims (``BatchNorm2d`` on (B, C, M, S)). eps 1e-5 and momentum
    0.1 match flax's momentum 0.9 (``spsnet_tpu/models/blocks.py:52-54``)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1])).reshape(shape)


class SharedMLP(nn.Sequential):
    """Pointwise Linear(no bias) + BN + ReLU per width in ``channels``."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        layers = []
        for c in channels:
            layers += [nn.Linear(in_channels, c, bias=False), BatchNormLast(c),
                       nn.ReLU()]
            in_channels = c
        super().__init__(*layers)
        self.out_channels = in_channels


class MLPHead(nn.Sequential):
    """``SharedMLP`` hidden stack, then a biased output Linear
    (``point_head_template.py:36-47``)."""

    def __init__(self, in_channels: int, hidden: Sequence[int],
                 out_channels: int):
        mlp = SharedMLP(in_channels, hidden)
        super().__init__(*mlp, nn.Linear(mlp.out_channels, out_channels))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for the MLP stacks of ``module``.

    A Linear followed by BatchNorm gets He-normal weights (std
    sqrt(2 / fan_in)), which keeps activations at unit scale through ReLU; an
    output Linear gets std sqrt(1 / fan_in) and a N(0, 0.1) bias. BatchNorm
    keeps its identity statistics. Draws happen on the CPU in module order,
    so a seed gives the same weights on every device.
    """
    linears = [m for m in module.modules() if isinstance(m, nn.Linear)]
    hidden = set()
    for seq in module.modules():
        if isinstance(seq, nn.Sequential):
            for a, b in zip(seq, list(seq)[1:]):
                if isinstance(a, nn.Linear) and isinstance(b, BatchNormLast):
                    hidden.add(id(a))
    for lin in linears:
        gain = 2.0 if id(lin) in hidden else 1.0
        std = math.sqrt(gain / lin.in_features)
        w = torch.randn(lin.weight.shape, generator=generator) * std
        lin.weight.copy_(w)
        if lin.bias is not None:
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=generator) * 0.1)
