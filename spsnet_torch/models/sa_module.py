"""Set-abstraction layers with sampling + multi-scale grouping, the vote
layer and the feature-propagation layer, channel-last.

Port of ``spsnet_tpu/models/sa_module.py`` (``PointnetSAModuleMSG_WithSampling``
and ``Vote_layer``, ``pointnet2_modules.py:128-516``; the plain D-FPS
``PointnetSAModuleMSG`` and ``PointnetFPModule``, ``:86-126,539-587``).
Submodule names follow the reference state dict: ``mlps.{s}``,
``aggregation_layer``, ``confidence_layers``, ``mlp_modules``, ``ctr_reg``,
``mlp``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import ops
from ..ops.interpolate import (three_interpolate, three_interpolate_weights,
                               three_nn)
from . import samplers
from .blocks import MLPHead, SharedMLP


def _sampler_kind(stype: str) -> str:
    """The JAX package's dispatch (``spsnet_tpu/models/sa_module.py:
    80-131``): the same tests in the same order."""
    if 'cls' in stype or 'ctr' in stype:
        return 'ctr'
    if 'sss' in stype or 'ss' in stype:
        return 'sss'
    if 'S-FPS' in stype or 'SFS' in stype:
        return 'sfps'
    if 'D-FPS' in stype or 'DFS' in stype:
        return 'dfps'
    if 'F-FPS' in stype or 'FFS' in stype:
        return 'ffps'
    if stype == 'FS':
        return 'fs'
    if 'Rand' in stype:
        return 'rand'
    if stype in ('ds_FPS', 'ds-FPS'):
        return 'ds_fps'
    if stype in ('ry_FPS', 'ry-FPS'):
        return 'ry_fps'
    raise NotImplementedError(stype)


class SAModuleMSGWithSampling(nn.Module):
    """Sampler dispatch -> MSG grouping -> shared MLPs -> aggregation ->
    confidence. ``mlps`` entries exclude the input width (``in_channels``);
    the relative xyz is prepended (use_xyz). ``ss_radius`` and
    ``ss_nsample`` give S-FPS's swap ball, ``sfps_min_unique`` its
    degeneracy guard (``samplers.sample_sfps``). With ``dilated_group``
    scale i groups the annulus [radii[i - 1], radii[i]) (scale 0 the ball
    of radii[0]), all scales through one annulus query; ``msg_shared``
    (off by default) groups a max-pool layer of two or more scales, not
    dilated, from one query and one gather (``ops.msg_shared_group``)."""

    def __init__(self, in_channels: int, npoint_list: Sequence[int],
                 sample_range_list: Sequence[int],
                 sample_type_list: Sequence[str], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 num_class: int, dilated_group: bool = False,
                 pool_method: str = 'max_pool',
                 aggregation_mlp: Optional[Sequence[int]] = None,
                 confidence_mlp: Optional[Sequence[int]] = None,
                 fps_seeding: Optional[ops.FpsSeeding] = None,
                 ss_radius: Optional[float] = None,
                 ss_nsample: Optional[int] = None,
                 sfps_min_unique: int = 3500, msg_shared: bool = False):
        super().__init__()
        if pool_method not in ('max_pool', 'avg_pool'):
            raise NotImplementedError(pool_method)
        self.npoint_list = list(npoint_list)
        self.sample_range_list = list(sample_range_list)
        self.sampler_kinds = [_sampler_kind(s) for s in sample_type_list]
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.dilated_group = dilated_group
        # JAX's msg_shared_enabled (spsnet_tpu/ops/grouping.py:337-344) and
        # its max-pool test (sa_module.py:158-160)
        self.msg_shared = (msg_shared and pool_method == 'max_pool'
                           and not dilated_group and len(self.radii) >= 2)
        self.pool_method = pool_method
        self.fps_seeding = fps_seeding
        self.ss_radius, self.ss_nsample = ss_radius, ss_nsample
        self.sfps_min_unique = sfps_min_unique

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

    def _sample(self, xyz, cls_features, input_fps_ordered: bool,
                stds=None, features=None, sampling_generator=None):
        """Run the configured sampler chain -> ((B, M) int64 indices, the
        per-point stds carried along the picks, or None). A range's picks
        index its own slice, and are gathered from the whole input, as in
        both the JAX package and the reference."""
        B = xyz.shape[0]
        sampled, last_end = [], 0
        for kind, srange, npoint in zip(self.sampler_kinds,
                                        self.sample_range_list,
                                        self.npoint_list):
            if npoint <= 0:
                continue
            end = None if srange == -1 else srange
            xyz_t = xyz[:, last_end:end]
            feat_t = features[:, last_end:end] \
                if features is not None else None
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
            elif kind == 'sss':
                if stds is None:
                    raise ValueError('the sss_aware sampler needs stds')
                idx, stds = samplers.sample_sss_aware(cls_t, stds, npoint)
            elif kind == 'sfps':
                if stds is None:
                    raise ValueError('the S-FPS sampler needs stds')
                idx, stds = samplers.sample_sfps(
                    xyz_t, stds, npoint, self.ss_radius, self.ss_nsample,
                    self.sfps_min_unique)
            elif kind in ('ffps', 'fs'):
                if feat_t is None:
                    raise ValueError(f'the {kind} sampler needs features')
                idx = (samplers.sample_ffps if kind == 'ffps'
                       else samplers.sample_fs)(xyz_t, feat_t, npoint)
            elif kind == 'rand':
                if sampling_generator is None:
                    raise ValueError('the Rand sampler needs a '
                                     'sampling_generator (a CPU '
                                     'torch.Generator)')
                idx = samplers.sample_rand(sampling_generator, B, n_t,
                                           npoint, xyz.device)
            elif kind == 'ds_fps':
                idx = samplers.sample_ds_fps(xyz_t, npoint)
            elif kind == 'ry_fps':
                idx = samplers.sample_ry_fps(xyz_t, npoint)
            elif input_fps_ordered and at_head and not ops.fps_seeding_active(
                    self.fps_seeding, npoint, allow_seed=True):
                # prefix nesting: xyz_t is (a head slice of) an exact D-FPS
                # chain in selection order, and FPS of a chain's head is
                # that head (each pick of FPS(chain) is the global argmax
                # over the original cloud, which is the next chain entry).
                # Valid only because the FPS here is exact, not seeded.
                idx = torch.arange(npoint, device=xyz.device).expand(B, npoint)
                stds = None if stds is None else stds[:, :npoint]
            else:
                idx, stds = samplers.sample_dfps(xyz_t, npoint, stds=stds,
                                                 seeding=self.fps_seeding)
            sampled.append(idx)
        return torch.cat(sampled, dim=-1), stds

    def forward(self, xyz, features=None, cls_features=None, ctr_xyz=None,
                stds=None, input_fps_ordered: bool = False,
                sampling_generator=None):
        """
        Args:
            xyz: (B, N, 3); features: (B, N, C) or None;
            cls_features: (B, N, num_class) from the previous confidence MLP;
            ctr_xyz: (B, M, 3) centers to group around instead of sampling;
            stds: (B, N) per-point stability (SPSNet) or None, carried
                along the picks;
            sampling_generator: a CPU ``torch.Generator`` for the Rand
                sampler (which raises without one).
        Returns:
            new_xyz (B, M, 3), new_features (B, M, C'), cls_preds or None,
            sampled_idx (B, M) or None, stds (B, M), (B, N) or None.
        """
        sampled_idx = None
        if ctr_xyz is None:
            sampled_idx, stds = self._sample(xyz, cls_features,
                                             input_fps_ordered, stds,
                                             features, sampling_generator)
            new_xyz = ops.gather_points(xyz, sampled_idx)
        else:
            new_xyz = ctr_xyz

        if self.radii:
            xyz_c, ctr_c = xyz.contiguous(), new_xyz.contiguous()
            if self.msg_shared:
                grouped, valids = ops.msg_shared_group(
                    self.radii, self.nsamples, xyz_c, ctr_c, features)
                scale_feats = [ops.masked_pool(mlp(grouped), valid,
                                               self.pool_method)
                               for mlp, valid in zip(self.mlps, valids)]
            else:
                lows = ([0.0, *self.radii[:-1]] if self.dilated_group
                        else None)
                multi_idx = ops.ball_query_multi(self.radii, self.nsamples,
                                                 xyz_c, ctr_c, min_radii=lows)
                scale_feats = []
                for r, s, mlp, idx in zip(self.radii, self.nsamples,
                                          self.mlps, multi_idx):
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
        return new_xyz, new_features, cls_preds, sampled_idx, stds


class VoteLayer(nn.Module):
    """Light voting with offset limits (``pointnet2_modules.py:462-516``);
    returns the pre-vote features unchanged, as the JAX package does. With
    ``surface_channels`` (PAGNet), the MLP reads ``[surface, features]``
    concatenated in that order."""

    def __init__(self, in_channels: int, mlp_list: Sequence[int],
                 max_translate_range: Optional[Sequence[float]] = None,
                 surface_channels: int = 0):
        super().__init__()
        self.out_channels = in_channels  # features pass through
        width = in_channels + surface_channels
        self.mlp_modules = SharedMLP(width, mlp_list) if mlp_list else None
        self.ctr_reg = nn.Linear(mlp_list[-1] if mlp_list else width, 3)
        self.max_translate_range = (
            None if max_translate_range is None
            else [float(v) for v in max_translate_range])

    def forward(self, xyz, features, surface_features=None):
        x = features if surface_features is None else \
            torch.cat([surface_features, features], dim=-1)
        if self.mlp_modules is not None:
            x = self.mlp_modules(x)
        ctr_offsets = self.ctr_reg(x)
        limited = ctr_offsets
        if self.max_translate_range is not None:
            limit = xyz.new_tensor(self.max_translate_range)
            limited = torch.clamp(ctr_offsets, -limit, limit)
        return xyz + limited, features, xyz, ctr_offsets


class SAModule(nn.Module):
    """Plain single- or multi-scale SA layer (PointNet++ MSG, as
    ``spsnet_tpu/models/sa_module.py:241-276``): exact D-FPS to ``npoint``
    centers (no prefix-nesting shortcut), one fused ball query for all
    radii, a shared MLP per radius over ``[relative xyz, features]`` and a
    pool over the samples. ``npoint=None`` groups all points around no
    center (absolute xyz) and returns ``new_xyz`` None."""

    def __init__(self, in_channels: int, npoint: Optional[int],
                 radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint = npoint
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.mlps = nn.ModuleList(SharedMLP(in_channels + 3, m) for m in mlps)
        self.out_channels = sum(m[-1] for m in mlps)

    def forward(self, xyz, features=None):
        """(B, N, 3) points, (B, N, C) features or None -> new_xyz (B, M, 3)
        (None when grouping all), features (B, M, C'), sampled indices
        (B, M) or None."""
        new_xyz = sampled_idx = None
        if self.npoint is not None:
            xyz = xyz.contiguous()
            sampled_idx = ops.farthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, sampled_idx).contiguous()
            multi_idx = ops.ball_query_multi(self.radii, self.nsamples, xyz,
                                             new_xyz)
        scale_feats = []
        for s, mlp in enumerate(self.mlps):
            if self.npoint is None:
                grouped = ops.group_all(xyz, features)
            else:
                grouped, _ = ops.query_and_group(
                    self.radii[s], self.nsamples[s], xyz, new_xyz, features,
                    idx=multi_idx[s])
            scale_feats.append(mlp(grouped).amax(dim=2))
        return new_xyz, torch.cat(scale_feats, dim=-1), sampled_idx


class FPModule(nn.Module):
    """Feature propagation (``spsnet_tpu/models/sa_module.py:279-295``):
    the 3-NN inverse-distance interpolation of the known features onto the
    unknown points, concatenated before the unknown points' own features,
    then a shared MLP."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)
        self.out_channels = self.mlp.out_channels

    def forward(self, unknown, known, unknown_feats, known_feats):
        """(B, N, 3), (B, M, 3) or None, (B, N, C1) or None, (B, M, C2) ->
        (B, N, C'). With ``known`` None, ``known_feats`` (B, 1, C2) is
        broadcast to every unknown point."""
        if known is not None:
            d2, idx = three_nn(unknown, known)
            interp = three_interpolate(known_feats, idx,
                                       three_interpolate_weights(d2))
        else:
            interp = known_feats.expand(-1, unknown.shape[1], -1)
        x = interp if unknown_feats is None else \
            torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(x)
