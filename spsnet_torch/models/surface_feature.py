"""DGCNN-style surface features: SPSNet's DenseEdgeConv stack, channel-last.

Port of ``spsnet_tpu/models/surface_feature.py`` (reference
``pcdet/ops/pointnet2/pointnet2_batch/surface_feature.py``): four edge-conv
units (24 channels, 3 FC layers each, growth 12, 16 neighbours from a
radius-0.8 ball query) -> a 60-d descriptor per point. As in the JAX
package, the graph is built once per forward in xyz space (the reference's
``static_graph_forward``) and shared by the four units. Submodule names
follow the reference state dict: ``transforms.{i}.linear``,
``convs.{i}.{layer_first,layers.{j},layer_last}.linear``.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import ops


class FCLayer(nn.Module):
    """Linear, then ReLU unless ``relu`` is False."""

    def __init__(self, in_channels: int, out_channels: int,
                 relu: bool = True):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)
        self.relu = relu

    def forward(self, x):
        x = self.linear(x)
        return torch.relu(x) if self.relu else x


class DenseEdgeConv(nn.Module):
    """Densely connected edge convolution over given neighbourhoods: each
    FC layer's output is concatenated in front of its input, and the result
    is max-pooled over the neighbours."""

    def __init__(self, in_channels: int, num_fc_layers: int = 3,
                 growth_rate: int = 12, relative_feat_only: bool = False):
        super().__init__()
        self.relative_feat_only = relative_feat_only
        edge = in_channels if relative_feat_only else 3 * in_channels
        self.layer_first = FCLayer(edge, growth_rate)
        self.layers = nn.ModuleList(
            FCLayer(in_channels + i * growth_rate, growth_rate)
            for i in range(1, num_fc_layers - 1))
        self.layer_last = FCLayer(
            in_channels + (num_fc_layers - 1) * growth_rate, growth_rate,
            relu=False)
        self.out_channels = in_channels + num_fc_layers * growth_rate

    def forward(self, x, idx):
        """x: (B, N, d) features; idx: (B, N, K) neighbour indices ->
        (B, N, out_channels)."""
        knn = ops.group_points(x, idx)                   # (B, N, K, d)
        x_tiled = x[:, :, None, :].expand_as(knn)
        if self.relative_feat_only:
            edge = knn - x_tiled
        else:
            edge = torch.cat([x_tiled, knn, knn - x_tiled], dim=-1)
        y = torch.cat([self.layer_first(edge), x_tiled], dim=-1)
        for layer in self.layers:
            y = torch.cat([layer(y), y], dim=-1)
        y = torch.cat([self.layer_last(y), y], dim=-1)
        return y.amax(dim=-2)


class FeatureExtraction(nn.Module):
    """The 4-unit DenseEdgeConv stack -> a 60-d surface descriptor per
    point."""

    def __init__(self, conv_channels: int = 24, num_convs: int = 4,
                 conv_num_fc_layers: int = 3, conv_growth_rate: int = 12,
                 conv_knn: int = 16, conv_radius: float = 0.8):
        super().__init__()
        self.knn, self.radius = conv_knn, conv_radius
        self.transforms = nn.ModuleList()
        self.convs = nn.ModuleList()
        width = 3
        for i in range(num_convs):
            self.transforms.append(FCLayer(width, conv_channels, relu=i > 0))
            conv = DenseEdgeConv(conv_channels, conv_num_fc_layers,
                                 conv_growth_rate,
                                 relative_feat_only=(i == 0))
            self.convs.append(conv)
            width = conv.out_channels
        self.out_channels = width

    def graph(self, pos):
        """(B, N, 3) -> (B, N, knn) int64: the ball-query graph all units
        share (one query per forward)."""
        return ops.ball_query(self.radius, self.knn, pos.contiguous(),
                              pos.contiguous())

    def forward(self, pos):
        """pos: (B, N, 3) -> (B, N, out_channels)."""
        idx = self.graph(pos)
        x = pos
        for transform, conv in zip(self.transforms, self.convs):
            x = conv(transform(x), idx)
        return x
