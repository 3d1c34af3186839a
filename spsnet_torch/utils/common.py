"""Shared geometry helpers (``spsnet_tpu/utils/common.py``; reference
``pcdet/utils/common_utils.py:35-57``): boxes are ``[x, y, z, dx, dy, dz,
heading]`` with (x, y, z) the box center and heading a rotation about +z
(x toward y)."""
from __future__ import annotations

import torch


def rotate_points_along_z(points, angle):
    """Rotate (B, N, 3 + C) points about +z by (B,) ``angle`` radians;
    extra channels pass through. Row-vector convention ``p @ R`` with
    ``R = [[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]``."""
    cosa, sina = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(angle), torch.ones_like(angle)
    rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros,
                       zeros, zeros, ones], dim=1).reshape(-1, 3, 3)
    xyz = torch.bmm(points[..., 0:3], rot)
    return torch.cat([xyz, points[..., 3:]], dim=-1)
