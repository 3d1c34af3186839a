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

from ..parallel import draw_rows, step_world, sum_over_ranks
from ..utils.common import to_device


def _global_stats(x, dims):
    """(var, mean), biased, of ``x`` over ``dims`` and over the active
    data-parallel step's ranks (``parallel.step_group``), keepdim; None
    outside such a step. Two passes of a differentiable all-reduce: the
    sums and the count give the mean, then the squared deviations from it
    the variance. The sums cross the ranks in float64, so the count is
    exact and the ranks' order costs no precision."""
    if step_world() == 1:
        return None
    s = x.sum(dim=dims, keepdim=True)
    stats = torch.cat([s.double().flatten(),
                       s.new_full((1,), x.numel() // s.numel(),
                                  dtype=torch.float64)])
    stats = sum_over_ranks(stats)
    n = stats[-1]
    mean = (stats[:-1] / n).to(x.dtype).reshape(s.shape)
    d = x - mean
    var = sum_over_ranks((d * d).sum(dim=dims).double()) / n
    return var.to(x.dtype).reshape(s.shape), mean


def _flax_batch_norm(bn, x, dims):
    """Training-mode BatchNorm of ``x`` over ``dims`` with the batch's
    biased variance, as in both frameworks; the running variance moves
    toward the biased variance too, as flax's does (torch's own update takes
    the unbiased one, n/(n-1) larger).

    On the CPU the batch is normalised with ``torch.var_mean``'s
    statistics: ``F.batch_norm`` there sums an (N, C) batch's statistics
    in fp32 row after row. For the 442 368 rows of PV-RCNN training's
    RoI-grid pool (channel means up to 9x their spread) its output is 6.3e-6
    relative off float64, an H100's ``F.batch_norm`` 3.4e-7 and this form
    1.4e-7 (``chip_smoke.py`` phase 36).

    Inside a data-parallel step of more than one rank the statistics are
    the joined batch's (``_global_stats``), as under the JAX package's one
    program over the mesh (``spsnet_tpu/models/blocks.py:33-38``), on
    every device; the running statistics then move alike on every rank."""
    stats = _global_stats(x, dims)
    if stats is not None:
        var, mean = stats
        y = (x - mean) * torch.rsqrt(var + bn.eps) * \
            bn.weight.reshape(mean.shape) + bn.bias.reshape(mean.shape)
        var, mean = var.detach().flatten(), mean.detach().flatten()
    elif x.device.type == 'cpu':
        var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + bn.eps) * \
            bn.weight.reshape(mean.shape) + bn.bias.reshape(mean.shape)
        var, mean = var.detach().flatten(), mean.detach().flatten()
    else:
        y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                         bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var)
        bn.num_batches_tracked += 1
    return y


class BatchNormLast(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor, statistics over all
    leading dims (``BatchNorm2d`` on (B, C, M, S)). eps 1e-5 and momentum
    0.1 match flax's momentum 0.9 (``spsnet_tpu/models/blocks.py:52-54``);
    the sparse convolutions take eps 1e-3 and momentum 0.01 (flax 0.99).
    Training follows flax's running-variance rule (``_flax_batch_norm``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        if not self.training:
            return super().forward(x).reshape(shape)
        return _flax_batch_norm(self, x, 0).reshape(shape)


class BatchNormNCHW(nn.BatchNorm2d):
    """``BatchNormLast``'s counterpart on (B, C, H, W) maps (the BEV
    backbone), with ``BatchNorm2d``'s state-dict names: statistics over B,
    H and W, and in training flax's running-variance rule."""

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x, (0, 2, 3))


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask comes from an explicit CPU generator (the
    step's 'dropout' stream, ``runtime.trainer.step_rngs``), as flax's
    Dropout draws from the 'dropout' rng: each element is kept with
    probability 1 - p and scaled by 1 / (1 - p). The identity in eval mode
    and at p = 0, where it draws nothing. In a data-parallel step the mask
    is the joined batch's rows of this rank (``parallel.draw_rows``): the
    leading axis of ``x`` is frame-major."""

    def forward(self, x, generator=None):
        if not self.training or self.p == 0:
            return x
        if generator is None:
            raise ValueError('Dropout in training needs the step generator '
                             "(batch['rngs']['dropout'])")
        keep_prob = 1.0 - self.p
        keep = to_device(draw_rows(
            lambda shape, g: torch.rand(shape, generator=g), x.shape,
            generator) < keep_prob, x.device)
        return torch.where(keep, x / keep_prob, 0.0)


class _Stack(nn.Sequential):
    """A Sequential whose Dropout layers draw their masks from the
    ``generator`` passed to ``forward``."""

    def forward(self, x, generator=None):
        for layer in self:
            x = layer(x, generator) if isinstance(layer, Dropout) \
                else layer(x)
        return x


class SharedMLP(_Stack):
    """Pointwise Linear(no bias) + BN + ReLU per width in ``channels``; with
    ``use_bn=False``, biased Linear + ReLU (``spsnet_tpu/models/blocks.py:
    30-60``). ``dropout_idx`` puts a ``Dropout(dropout)`` after the ReLU of
    those layers, as the reference's RoI heads do
    (``roi_head_template.py:36-44``); it is the identity in eval mode.
    ``bn_eps`` and ``bn_momentum``: the BatchNorm's (torch's momentum, 1
    minus flax's)."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 use_bn: bool = True, dropout: float = 0.0,
                 dropout_idx: Sequence[int] = (), bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        layers = []
        for k, c in enumerate(channels):
            layers.append(nn.Linear(in_channels, c, bias=not use_bn))
            if use_bn:
                layers.append(BatchNormLast(c, bn_eps, bn_momentum))
            layers.append(nn.ReLU())
            if k in tuple(dropout_idx):
                layers.append(Dropout(dropout))
            in_channels = c
        super().__init__(*layers)
        self.out_channels = in_channels


class MLPHead(_Stack):
    """``SharedMLP`` hidden stack, then a biased output Linear
    (``point_head_template.py:36-47``)."""

    def __init__(self, in_channels: int, hidden: Sequence[int],
                 out_channels: int, dropout: float = 0.0,
                 dropout_idx: Sequence[int] = ()):
        mlp = SharedMLP(in_channels, hidden, dropout=dropout,
                        dropout_idx=dropout_idx)
        super().__init__(*mlp, nn.Linear(mlp.out_channels, out_channels))


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
    module order, so a seed gives the same weights on every device. Then
    each submodule with a ``draw_init(generator)`` method draws its own
    weights (the VectorPool's per-cell kernels), in module order, and each
    with a ``fixed_init`` method sets its fixed starting values
    (CenterPoint's heatmap bias).
    """
    kinds = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d)
    layers = [m for m in module.modules() if isinstance(m, kinds)]
    hidden = set()
    for seq in module.modules():
        if isinstance(seq, nn.Sequential):
            for a, b in zip(seq, list(seq)[1:]):
                if isinstance(a, kinds) and isinstance(
                        b, (BatchNormLast, nn.BatchNorm2d,
                            nn.BatchNorm3d, nn.ReLU)):
                    hidden.add(id(a))
    for layer in layers:
        gain = 2.0 if id(layer) in hidden else 1.0
        std = math.sqrt(gain / _fan_in(layer))
        w = torch.randn(layer.weight.shape, generator=generator) * std
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.copy_(torch.randn(layer.bias.shape,
                                         generator=generator) * 0.1)
    for m in module.modules():
        if hasattr(m, 'draw_init'):
            m.draw_init(generator)
    for m in module.modules():
        if hasattr(m, 'fixed_init'):
            m.fixed_init()
