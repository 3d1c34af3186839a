"""Pointwise MLP stacks, channel-last.

The reference's ``Conv2d(1x1)+BatchNorm2d+ReLU`` stacks
(``pointnet2_modules.py:199-246``) are pointwise MLPs; here they are
``nn.Linear`` + BatchNorm over the last axis + ReLU on (..., C) tensors.
Each stack is an ``nn.Sequential`` laid out like the reference's, so the
parameter names match its state dict (Linear at 3k, BatchNorm at 3k+1, ReLU
at 3k+2, the biased output Linear last; without BatchNorm, a biased Linear
at 2k and ReLU at 2k+1).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.common import to_device


class BatchNormLast(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor, statistics over all
    leading dims (``BatchNorm2d`` on (B, C, M, S)). eps 1e-5 and momentum
    0.1 match flax's momentum 0.9 (``spsnet_tpu/models/blocks.py:52-54``);
    the sparse convolutions take eps 1e-3 and momentum 0.01 (flax 0.99).

    In training the batch is normalised with its biased variance, as in
    both frameworks, and the running variance moves toward the biased
    variance too, as flax's does (torch's own update takes the unbiased
    one, n/(n-1) larger)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        if not self.training:
            return super().forward(x).reshape(shape)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=0, unbiased=False)
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
            self.num_batches_tracked += 1
        return y.reshape(shape)


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask comes from an explicit CPU generator (the
    step's 'dropout' stream, ``runtime.trainer.step_rngs``), as flax's
    Dropout draws from the 'dropout' rng: each element is kept with
    probability 1 - p and scaled by 1 / (1 - p). The identity in eval mode
    and at p = 0, where it draws nothing."""

    def forward(self, x, generator=None):
        if not self.training or self.p == 0:
            return x
        if generator is None:
            raise ValueError('Dropout in training needs the step generator '
                             "(batch['rngs']['dropout'])")
        keep_prob = 1.0 - self.p
        keep = to_device(torch.rand(x.shape, generator=generator) < keep_prob,
                         x.device)
        return torch.where(keep, x / keep_prob, 0.0)


class SharedMLP(nn.Sequential):
    """Pointwise Linear(no bias) + BN + ReLU per width in ``channels``; with
    ``use_bn=False``, biased Linear + ReLU (``spsnet_tpu/models/blocks.py:
    30-60``). ``dropout_idx`` puts a ``Dropout(dropout)`` after the ReLU of
    those layers, as the reference's RoI heads do
    (``roi_head_template.py:36-44``); it is the identity in eval mode."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 use_bn: bool = True, dropout: float = 0.0,
                 dropout_idx: Sequence[int] = ()):
        layers = []
        for k, c in enumerate(channels):
            layers.append(nn.Linear(in_channels, c, bias=not use_bn))
            if use_bn:
                layers.append(BatchNormLast(c))
            layers.append(nn.ReLU())
            if k in tuple(dropout_idx):
                layers.append(Dropout(dropout))
            in_channels = c
        super().__init__(*layers)
        self.out_channels = in_channels


class MLPHead(nn.Sequential):
    """``SharedMLP`` hidden stack, then a biased output Linear
    (``point_head_template.py:36-47``)."""

    def __init__(self, in_channels: int, hidden: Sequence[int],
                 out_channels: int, dropout: float = 0.0,
                 dropout_idx: Sequence[int] = ()):
        mlp = SharedMLP(in_channels, hidden, dropout=dropout,
                        dropout_idx=dropout_idx)
        super().__init__(*mlp, nn.Linear(mlp.out_channels, out_channels))

    def forward(self, x, generator=None):
        """``generator`` draws the masks of the Dropout layers."""
        for layer in self:
            x = layer(x, generator) if isinstance(layer, Dropout) \
                else layer(x)
        return x


def _fan_in(layer) -> float:
    """Inputs summed into one output of a Linear, a convolution or a
    transposed convolution (whose kernel taps a stride apart meet no
    output together)."""
    if isinstance(layer, nn.Linear):
        return layer.in_features
    taps = math.prod(layer.kernel_size)
    if isinstance(layer, nn.ConvTranspose2d):
        return layer.in_channels * taps / math.prod(layer.stride)
    return layer.in_channels * taps / layer.groups


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for the Linear and convolution layers of
    ``module``.

    A layer followed by BatchNorm or ReLU gets He-normal weights (std
    sqrt(2 / fan_in)), which keeps activations at unit scale through ReLU; an
    output layer gets std sqrt(1 / fan_in); every bias is N(0, 0.1).
    BatchNorm keeps its identity statistics. Draws happen on the CPU in
    module order, so a seed gives the same weights on every device.
    """
    kinds = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)
    layers = [m for m in module.modules() if isinstance(m, kinds)]
    hidden = set()
    for seq in module.modules():
        if isinstance(seq, nn.Sequential):
            for a, b in zip(seq, list(seq)[1:]):
                if isinstance(a, kinds) and isinstance(
                        b, (BatchNormLast, nn.BatchNorm2d, nn.ReLU)):
                    hidden.add(id(a))
    for layer in layers:
        gain = 2.0 if id(layer) in hidden else 1.0
        std = math.sqrt(gain / _fan_in(layer))
        w = torch.randn(layer.weight.shape, generator=generator) * std
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.copy_(torch.randn(layer.bias.shape,
                                         generator=generator) * 0.1)
