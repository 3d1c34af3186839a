"""Point <-> grid projections of the AL / MLT-SSD range-view family (port
of ``spsnet_tpu/models/backbones_2d/projection.py``; reference
``backbones_2d/map_to_bev/projection.py``), on fixed-shape (B, N, ...)
points and NCHW grids:

- a point outside the range (``keep`` False) goes to a dump cell past the
  grid instead of being compacted away;
- the scatter-max writes into a zero grid and keeps the grid's own 0
  (``include_self``), so an empty cell is 0 and a negative feature loses
  to it, as in the reference (whose scatter output is zero-padded);
- the bilinear gather pads the grid by one zero row and column, so a point
  whose upper cell falls off the edge blends with zeros;
- a point outside the range gathers zeros.

Every division is by a tensor (``utils.common.true_div``): a CUDA kernel
takes a host scalar divisor as a product with its reciprocal, and the
card and the CPU must floor the same coordinates. The ties of the max
split its gradient evenly among the tied points and the grid's own 0, as
JAX's scatter-max does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...utils.common import true_div

_EPS = 0.1


def bev_coords(points, pc_range, bev_shape):
    """Continuous BEV (u, v) and the in-range mask (``init_bev_coord``).

    Args:
        points: (B, N, 3+).
        pc_range: [x_min, y_min, z_min, x_max, y_max, z_max].
        bev_shape: (h, w).
    Returns:
        u, v: (B, N) float32; keep: (B, N) bool.
    """
    h, w = int(bev_shape[0]), int(bev_shape[1])
    x_min, y_min, _, x_max, y_max, _ = [float(v) for v in pc_range]
    x, y = points[..., 0], points[..., 1]
    keep = (x > x_min) & (x < x_max) & (y > y_min) & (y < y_max)
    u = true_div(x - x_min, x_max - x_min) * w
    v = true_div(y - y_min, y_max - y_min) * h
    return u.clamp(0.0, w - _EPS), v.clamp(0.0, h - _EPS), keep


def range_coords(points, v_fov, range_shape):
    """Spherical range-image (u, v) and the vertical field-of-view mask
    (``init_range_coord``).

    Args:
        points: (B, N, 3+).
        v_fov: (v_down, v_up) in radians (``process_fov``).
        range_shape: (h, w).
    Returns:
        u, v: (B, N) float32; keep: (B, N) bool.
    """
    h, w = int(range_shape[0]), int(range_shape[1])
    v_down, v_up = float(v_fov[0]), float(v_fov[1])
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r_sqr = x * x + y * y + z * z
    theta = torch.asin(z / torch.sqrt(r_sqr + 1e-8))
    phi = torch.atan2(y, x)
    keep = (theta > v_down) & (theta < v_up)
    u = 0.5 * (1.0 - true_div(phi, math.pi)) * w
    v = (1.0 - true_div(theta - v_down, v_up - v_down)) * h
    return u.clamp(0.0, w - _EPS), v.clamp(0.0, h - _EPS), keep


def p2g_max(feats, u, v, keep, grid_shape):
    """Scatter-max of point features onto a grid (``Projection._scatter``).

    Args:
        feats: (B, N, C); u, v: (B, N); keep: (B, N) bool; grid_shape (h, w).
    Returns:
        (B, C, H, W), empty cells 0.
    """
    H, W = int(grid_shape[0]), int(grid_shape[1])
    B, N, C = feats.shape
    # the flat cell v * W + u, the dump cell H * W where keep is False
    idx = torch.where(keep, v.long() * W + u.long(), H * W)
    idx = idx[:, None].expand(B, C, N)
    grid = feats.new_zeros(B, C, H * W + 1).scatter_reduce(
        2, idx, feats.transpose(1, 2), 'amax', include_self=True)
    return grid[..., :H * W].reshape(B, C, H, W)


def g2p_bilinear(grid, u, v, keep):
    """Bilinear gather of grid features at the points
    (``Projection._gather``).

    Args:
        grid: (B, C, H, W); u, v: (B, N); keep: (B, N) bool.
    Returns:
        (B, N, C); zero where ``keep`` is False.
    """
    B, C, H, W = grid.shape
    flat = F.pad(grid, (0, 1, 0, 1)).reshape(B, C, (H + 1) * (W + 1))
    u0, v0 = torch.floor(u), torch.floor(v)
    iu0, iv0 = u0.long(), v0.long()
    fu, fv = u - u0, v - v0

    def at(iy, ix):
        idx = (iy * (W + 1) + ix)[:, None].expand(B, C, -1)
        return flat.gather(2, idx).transpose(1, 2)

    out = (at(iv0, iu0) * ((1 - fv) * (1 - fu))[..., None]
           + at(iv0, iu0 + 1) * ((1 - fv) * fu)[..., None]
           + at(iv0 + 1, iu0) * (fv * (1 - fu))[..., None]
           + at(iv0 + 1, iu0 + 1) * (fv * fu)[..., None])
    return torch.where(keep[..., None], out, 0.0)


def process_fov(fov_degrees):
    """Degrees -> radians of the (v_down, v_up) pair
    (``AL_3D.process_fov``)."""
    return tuple(float(d) / 180.0 * math.pi for d in fov_degrees[:2])
