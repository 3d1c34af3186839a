"""Set-abstraction layer with sampling + multi-scale grouping, and the vote
layer, channel-last.

Port of ``spsnet_tpu/models/sa_module.py`` (``PointnetSAModuleMSG_WithSampling``
and ``Vote_layer``, ``pointnet2_modules.py:128-516``). Submodule names follow
the reference state dict: ``mlps.{s}``, ``aggregation_layer``,
``confidence_layers``, ``mlp_modules``, ``ctr_reg``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import ops
from . import samplers
from .blocks import MLPHead, SharedMLP


def _sampler_kind(stype: str) -> str:
    """The JAX package's dispatch order (``sa_module.py:71-119``), cut to
    the samplers ported so far."""
    if 'cls' in stype or 'ctr' in stype:
        return 'ctr'
    if any(k in stype for k in ('sss', 'ss', 'S-FPS', 'SFS')):
        raise NotImplementedError(
            f'sampler {stype} (ROADMAP Queue 1 item 6)')
    if 'D-FPS' in stype or 'DFS' in stype:
        return 'dfps'
    raise NotImplementedError(
        f'sampler {stype}: F-FPS, FS, Rand, ds-FPS and ry-FPS are ROADMAP '
        'Queue 1 item 8')


class SAModuleMSGWithSampling(nn.Module):
    """Sampler dispatch -> MSG grouping -> shared MLPs -> aggregation ->
    confidence. ``mlps`` entries exclude the input width (``in_channels``);
    the relative xyz is prepended (use_xyz)."""

    def __init__(self, in_channels: int, npoint_list: Sequence[int],
                 sample_range_list: Sequence[int],
                 sample_type_list: Sequence[str], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 num_class: int, dilated_group: bool = False,
                 pool_method: str = 'max_pool',
                 aggregation_mlp: Optional[Sequence[int]] = None,
                 confidence_mlp: Optional[Sequence[int]] = None):
        super().__init__()
        if dilated_group:
            raise NotImplementedError(
                'DILATED_GROUP (ROADMAP Queue 1 item 8)')
        if pool_method not in ('max_pool', 'avg_pool'):
            raise NotImplementedError(pool_method)
        self.npoint_list = list(npoint_list)
        self.sample_range_list = list(sample_range_list)
        self.sampler_kinds = [_sampler_kind(s) for s in sample_type_list]
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.pool_method = pool_method

        self.out_channels = in_channels
        self.mlps = nn.ModuleList(SharedMLP(in_channels + 3, m) for m in mlps)
        self.aggregation_layer = None
        if self.radii:
            self.out_channels = sum(m[-1] for m in mlps)
            if aggregation_mlp:
                self.aggregation_layer = SharedMLP(self.out_channels,
                                                   aggregation_mlp)
                self.out_channels = aggregation_mlp[-1]
        self.confidence_layers = (
            MLPHead(self.out_channels, confidence_mlp, num_class)
            if confidence_mlp else None)

    def _sample(self, xyz, cls_features, input_fps_ordered: bool):
        """Run the configured sampler chain -> (B, M) int64 indices."""
        B = xyz.shape[0]
        sampled, last_end = [], 0
        for kind, srange, npoint in zip(self.sampler_kinds,
                                        self.sample_range_list,
                                        self.npoint_list):
            if npoint <= 0:
                continue
            end = None if srange == -1 else srange
            xyz_t = xyz[:, last_end:end]
            cls_t = cls_features[:, last_end:end] \
                if cls_features is not None else None
            at_head = last_end == 0
            if srange != -1:
                last_end += srange
            n_t = xyz_t.shape[1]
            if n_t <= npoint:
                idx = torch.arange(n_t, device=xyz.device).expand(B, n_t)
            elif kind == 'ctr':
                idx = samplers.sample_ctr_aware(cls_t, npoint)
            elif input_fps_ordered and at_head:
                # prefix nesting: xyz_t is (a head slice of) an exact D-FPS
                # chain in selection order, and FPS of a chain's head is
                # that head (each pick of FPS(chain) is the global argmax
                # over the original cloud, which is the next chain entry).
                # Valid only because the FPS here is exact.
                idx = torch.arange(npoint, device=xyz.device).expand(B, npoint)
            else:
                idx = samplers.sample_dfps(xyz_t, npoint)
            sampled.append(idx)
        return torch.cat(sampled, dim=-1)

    def forward(self, xyz, features=None, cls_features=None, ctr_xyz=None,
                input_fps_ordered: bool = False):
        """
        Args:
            xyz: (B, N, 3); features: (B, N, C) or None;
            cls_features: (B, N, num_class) from the previous confidence MLP;
            ctr_xyz: (B, M, 3) centers to group around instead of sampling.
        Returns:
            new_xyz (B, M, 3), new_features (B, M, C'), cls_preds or None,
            sampled_idx (B, M) or None.
        """
        sampled_idx = None
        if ctr_xyz is None:
            sampled_idx = self._sample(xyz, cls_features, input_fps_ordered)
            new_xyz = ops.gather_points(xyz, sampled_idx)
        else:
            new_xyz = ctr_xyz

        if self.radii:
            multi_idx = ops.ball_query_multi(self.radii, self.nsamples,
                                             xyz.contiguous(),
                                             new_xyz.contiguous())
            scale_feats = []
            for r, s, mlp, idx in zip(self.radii, self.nsamples, self.mlps,
                                      multi_idx):
                grouped, _ = ops.query_and_group(r, s, xyz, new_xyz,
                                                 features, idx=idx)
                scale_feats.append(ops.masked_pool(mlp(grouped), None,
                                                   self.pool_method))
            new_features = torch.cat(scale_feats, dim=-1)
            if self.aggregation_layer is not None:
                new_features = self.aggregation_layer(new_features)
        else:
            new_features = ops.gather_points(features, sampled_idx)

        cls_preds = (self.confidence_layers(new_features)
                     if self.confidence_layers is not None else None)
        return new_xyz, new_features, cls_preds, sampled_idx


class VoteLayer(nn.Module):
    """Light voting with offset limits (``pointnet2_modules.py:462-516``);
    returns the pre-vote features unchanged, as the JAX package does."""

    def __init__(self, in_channels: int, mlp_list: Sequence[int],
                 max_translate_range: Optional[Sequence[float]] = None):
        super().__init__()
        self.out_channels = in_channels  # features pass through
        self.mlp_modules = SharedMLP(in_channels, mlp_list) if mlp_list \
            else None
        self.ctr_reg = nn.Linear(
            mlp_list[-1] if mlp_list else in_channels, 3)
        self.max_translate_range = (
            None if max_translate_range is None
            else [float(v) for v in max_translate_range])

    def forward(self, xyz, features):
        x = self.mlp_modules(features) if self.mlp_modules is not None \
            else features
        ctr_offsets = self.ctr_reg(x)
        limited = ctr_offsets
        if self.max_translate_range is not None:
            limit = xyz.new_tensor(self.max_translate_range)
            limited = torch.clamp(ctr_offsets, -limit, limit)
        return xyz + limited, features, xyz, ctr_offsets
