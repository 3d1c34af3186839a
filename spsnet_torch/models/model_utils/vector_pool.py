"""VectorPool aggregation (PV-RCNN++), dense and channel-last.

Port of ``spsnet_tpu/models/model_utils/vector_pool.py`` (reference
``pointnet2_stack/pointnet2_modules.py`` ``VectorPoolAggregationModule``
:247 and ``VectorPoolAggregationModuleMSG`` :423). Around each query point
a grid of G = gx * gy * gz cells spans the cube of half-extent R; each cell
is summarised by

- ``local_interpolation``: the inverse-distance-weighted features of the 3
  nearest supports of the cell centre (``ops.three_nn``: K6 on the card),
  gated at R * NEIGHBOR_DISTANCE_MULTIPLIER, and the 9 numbers (cell centre
  - neighbour) of the gated neighbours; or
- ``voxel_avg_pool`` / ``voxel_random_choice``: the first NEIGHBOR_NSAMPLE
  supports of a cube (NEIGHBOR_TYPE 0: Chebyshev distance <= R,
  ``cube_query``) or ball (1: ``ops.ball_query``, K2 on the card) query
  binned into the cells; a cell holds the mean, or the first hit in index
  order, of its neighbours' offsets and features.

The features are first reduced to NUM_REDUCED_CHANNELS by summing channel
groups. Each cell's vector has its own projection (``grouped_kernel``,
(G, C_in, co)), then BatchNorm and ReLU over the G * co channels and the
POST_MLPS; the MSG module concatenates its groups with the query's xyz and
runs MSG_POST_MLPS. BatchNorm follows flax (momentum 0.99, eps 1e-3) and
counts every query row, the masked ones too; ``new_valid`` zeroes the
masked queries' outputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ... import ops
from ...ops.grouping import first_k_hits
from ...ops.interpolate import three_interpolate, three_nn
from ...utils.common import true_div
from ..blocks import BatchNormLast, SharedMLP

# flax BatchNorm(momentum=0.99, epsilon=1e-3) in torch's terms
BN_EPS, BN_MOMENTUM = 1e-3, 0.01
# centers by distance block of ``cube_query``: (B, chunk, N) entries
_CUBE_BLOCK = 1 << 25
# the interpolation's gate: R times this (the reference's default, which
# no config sets)
NEIGHBOR_DISTANCE_MULTIPLIER = 2.0


def _f32(x: float) -> float:
    """``x`` rounded to fp32, the value an fp32 op compares against."""
    return float(np.float32(x))


def grid_offsets(num_voxels, radius: float) -> np.ndarray:
    """(G, 3) float32 cell-centre offsets, the first axis slowest
    (``get_dense_voxels_by_center``)."""
    gx, gy, gz = [int(g) for g in num_voxels]
    R = float(radius)
    ax = [(-R + R / g) + np.arange(g) * (2 * R / g) for g in (gx, gy, gz)]
    mesh = np.stack(np.meshgrid(*ax, indexing='ij'), axis=-1)
    return mesh.reshape(-1, 3).astype(np.float32)


def cube_query(radius: float, nsample: int, xyz, new_xyz):
    """(B, N, 3) supports, (B, M, 3) centres -> (B, M, nsample) int64: the
    first ``nsample`` supports in index order whose Chebyshev distance to
    the centre is at most ``radius``, padded with the first hit (0 with
    none, the CUDA rule). In blocks of centres."""
    B, N, _ = xyz.shape
    r = _f32(radius)
    chunk = max(1, _CUBE_BLOCK // max(1, B * N))
    idx = []
    for c0 in range(0, new_xyz.shape[1], chunk):
        ctr = new_xyz[:, c0:c0 + chunk]
        hit = None
        for a in range(3):
            h = (ctr[..., a:a + 1] - xyz[..., a][:, None, :]).abs() <= r
            hit = h if hit is None else hit & h
        idx.append(first_k_hits(hit, nsample))
    return torch.cat(idx, dim=1)


def bin_neighbours(local, radius: float, grid_dims, ball: bool):
    """(..., K, 3) offsets of the neighbours from their query -> ((..., K)
    int64 flat cell, the first axis slowest; (..., K) bool: in the ball of
    ``radius`` (``ball``) or its cube). ``grid_dims``: the (3,) float32
    cells an axis."""
    x, y, z = local[..., 0], local[..., 1], local[..., 2]
    if ball:
        hit = (x * x + y * y) + z * z < _f32(radius * radius)
    else:
        r = _f32(radius)
        hit = (x.abs() <= r) & (y.abs() <= r) & (z.abs() <= r)
    cell = torch.floor(true_div(local + radius, 2 * radius) * grid_dims)
    cell = torch.minimum(cell.clamp(min=0), grid_dims - 1)
    gy, gz = grid_dims[1], grid_dims[2]
    flat = cell[..., 0] * (gy * gz) + cell[..., 1] * gz + cell[..., 2]
    return flat.to(torch.int64), hit


class VectorPoolAggregation(nn.Module):
    """One VectorPool group: ``grouped_kernel`` (G, C_in, co), ``agg_bn``
    over G * co channels and ``post_mlps`` (Linear, BatchNorm, ReLU per
    POST_MLPS width); C_in is NUM_REDUCED_CHANNELS + 9 (interpolation) or
    + 3 (the voxel branches)."""

    def __init__(self, num_local_voxel, max_neighbor_distance: float,
                 post_mlps, num_reduced_channels: int,
                 num_channels_of_local_aggregation: int = 32,
                 local_aggregation_type: str = 'local_interpolation',
                 neighbor_nsample: int = -1, neighbor_type: int = 0):
        super().__init__()
        if local_aggregation_type not in ('local_interpolation',
                                          'voxel_avg_pool',
                                          'voxel_random_choice'):
            raise ValueError(f'LOCAL_AGGREGATION_TYPE '
                             f'{local_aggregation_type!r}')
        if neighbor_type not in (0, 1):
            raise ValueError(f'NEIGHBOR_TYPE {neighbor_type}')
        self.num_local_voxel = tuple(int(g) for g in num_local_voxel)
        self.radius = float(max_neighbor_distance)
        self.reduced = int(num_reduced_channels)
        self.aggregation = local_aggregation_type
        self.nsample = int(neighbor_nsample) if neighbor_nsample > 0 else 32
        self.neighbor_type = int(neighbor_type)
        self.gate = _f32((self.radius * NEIGHBOR_DISTANCE_MULTIPLIER) ** 2)
        G = math.prod(self.num_local_voxel)
        c_in = self.reduced + (9 if self.aggregation ==
                               'local_interpolation' else 3)
        co = int(num_channels_of_local_aggregation)
        self.grouped_kernel = nn.Parameter(torch.empty(G, c_in, co))
        self.agg_bn = BatchNormLast(G * co, BN_EPS, BN_MOMENTUM)
        self.post_mlps = SharedMLP(G * co, [int(c) for c in post_mlps],
                                   bn_eps=BN_EPS, bn_momentum=BN_MOMENTUM)
        self.out_channels = self.post_mlps.out_channels
        self.register_buffer('offsets', torch.from_numpy(grid_offsets(
            self.num_local_voxel, self.radius)), persistent=False)
        self.register_buffer('grid_dims', torch.tensor(
            self.num_local_voxel, dtype=torch.float32), persistent=False)

    @torch.no_grad()
    def draw_init(self, generator):
        """He-normal per-cell kernels (std sqrt(2 / C_in)): a ReLU follows
        their BatchNorm."""
        w = torch.randn(self.grouped_kernel.shape, generator=generator)
        self.grouped_kernel.copy_(w * math.sqrt(2.0 /
                                                self.grouped_kernel.shape[1]))

    def reduce(self, feats):
        """(B, N, C) -> (B, N, NUM_REDUCED_CHANNELS): the sum of the C / r
        channel groups, group after group."""
        r = self.reduced
        if feats.shape[-1] % r:
            raise ValueError(f'{feats.shape[-1]} channels are no multiple of '
                             f'NUM_REDUCED_CHANNELS {r}')
        out = feats[..., :r]
        for g in range(1, feats.shape[-1] // r):
            out = out + feats[..., g * r:(g + 1) * r]
        return out

    def interp_cells(self, xyz, feats, new_xyz):
        """(B, M, G, r + 9): each cell centre's three-NN features and
        offsets, gated."""
        B, M, _ = new_xyz.shape
        G = self.offsets.shape[0]
        centers = (new_xyz[:, :, None, :] + self.offsets).reshape(B, M * G, 3)
        d2, idx = three_nn(centers, xyz)
        gate = d2 <= self.gate
        recip = torch.where(gate, 1.0 / (d2 + 1e-8), 0.0)
        norm = ((recip[..., 0] + recip[..., 1]) + recip[..., 2]).clamp(
            min=1e-8)
        w = recip / norm[..., None]
        interp = three_interpolate(feats, idx, w)
        nbr_xyz = ops.group_points(xyz, idx)               # (B, MG, 3, 3)
        local = (centers[:, :, None, :] - nbr_xyz) * gate[..., None]
        enc = torch.cat([interp, local.reshape(B, M * G, 9)], dim=-1)
        enc = torch.where(gate.any(dim=-1, keepdim=True), enc, 0.0)
        return enc.reshape(B, M, G, -1)

    def voxel_cells(self, xyz, feats, new_xyz):
        """(B, M, G, 3 + r): the neighbours binned into the cells, each
        cell's mean (``voxel_avg_pool``) or first (``voxel_random_choice``)
        offset and features."""
        R, K = self.radius, self.nsample
        if self.neighbor_type == 1:
            idx = ops.ball_query(R, K, xyz, new_xyz)
        else:
            idx = cube_query(R, K, xyz, new_xyz)
        local = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
        flat, hit = bin_neighbours(local, R, self.grid_dims,
                                   self.neighbor_type == 1)  # (B, M, K)
        nbr_feats = ops.group_points(feats, idx)            # (B, M, K, r)
        G = math.prod(self.num_local_voxel)
        onehot = torch.nn.functional.one_hot(flat, G).to(local.dtype) * \
            hit[..., None]                                  # (B, M, K, G)
        if self.aggregation == 'voxel_avg_pool':
            cnt = onehot.sum(dim=2)                         # (B, M, G)
            fsum = torch.einsum('bmkg,bmkc->bmgc', onehot, nbr_feats)
            xsum = torch.einsum('bmkg,bmkc->bmgc', onehot, local)
            denom = cnt.clamp(min=1.0)[..., None]
            cells = torch.cat([xsum / denom, fsum / denom], dim=-1)
            return cells * (cnt[..., None] > 0)
        first = onehot.argmax(dim=2)                        # (B, M, G)
        has = onehot.amax(dim=2) > 0
        both = torch.cat([local, nbr_feats], dim=-1)        # (B, M, K, 3+r)
        take = both.gather(2, first[..., None].expand(-1, -1, -1,
                                                      both.shape[-1]))
        return take * has[..., None]

    def forward(self, xyz, feats, new_xyz, new_valid=None):
        """(B, N, 3) supports (invalid ones moved far away by the caller),
        (B, N, C) their features, (B, M, 3) queries, (B, M) bool ``new_valid``
        or None -> (B, M, POST_MLPS[-1])."""
        feats = self.reduce(feats)
        if self.aggregation == 'local_interpolation':
            cells = self.interp_cells(xyz, feats, new_xyz)
        else:
            cells = self.voxel_cells(xyz, feats, new_xyz)
        B, M, G, c_in = cells.shape
        h = torch.bmm(cells.permute(2, 0, 1, 3).reshape(G, B * M, c_in),
                      self.grouped_kernel)                  # (G, BM, co)
        h = h.permute(1, 0, 2).reshape(B, M, -1)
        h = self.post_mlps(torch.relu(self.agg_bn(h)))
        if new_valid is not None:
            h = torch.where(new_valid[..., None], h, 0.0)
        return h


class VectorPoolAggregationMSG(nn.Module):
    """The VectorPool groups of a source (``layers.{k}`` for GROUP_CFG_k)
    and ``msg_post_mlps`` over their concatenation with the query xyz;
    ``input_channels``: the source's feature channels (the default of
    NUM_REDUCED_CHANNELS)."""

    def __init__(self, model_cfg, input_channels: int):
        super().__init__()
        cfg = model_cfg
        self.layers = nn.ModuleList()
        for k in range(int(cfg.NUM_GROUPS)):
            g = cfg[f'GROUP_CFG_{k}']
            self.layers.append(VectorPoolAggregation(
                g.NUM_LOCAL_VOXEL, float(g.MAX_NEIGHBOR_DISTANCE),
                list(g.POST_MLPS),
                int(cfg.get('NUM_REDUCED_CHANNELS', input_channels)),
                int(cfg.NUM_CHANNELS_OF_LOCAL_AGGREGATION),
                str(cfg.LOCAL_AGGREGATION_TYPE),
                int(g.get('NEIGHBOR_NSAMPLE', -1)),
                int(g.get('NEIGHBOR_TYPE', 0))))
        c = sum(layer.out_channels for layer in self.layers) + 3
        self.msg_post_mlps = SharedMLP(c, [int(v) for v in cfg.MSG_POST_MLPS],
                                       bn_eps=BN_EPS, bn_momentum=BN_MOMENTUM)
        self.out_channels = self.msg_post_mlps.out_channels

    def forward(self, xyz, feats, new_xyz, new_valid=None):
        """As ``VectorPoolAggregation.forward``, -> (B, M,
        MSG_POST_MLPS[-1])."""
        outs = [layer(xyz, feats, new_xyz, new_valid) for layer in self.layers]
        h = self.msg_post_mlps(torch.cat(outs + [new_xyz], dim=-1))
        if new_valid is not None:
            h = torch.where(new_valid[..., None], h, 0.0)
        return h
