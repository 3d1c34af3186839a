"""Shared geometry helpers (``spsnet_tpu/utils/common.py``; reference
``pcdet/utils/common_utils.py:35-57``): boxes are ``[x, y, z, dx, dy, dz,
heading]`` with (x, y, z) the box center and heading a rotation about +z
(x toward y)."""
from __future__ import annotations

import hashlib
import math

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


def true_div(a, b: float):
    """``a / b`` with ``b`` a tensor on ``a``'s device: a CUDA kernel takes a
    host scalar divisor as a product with its reciprocal, which rounds
    otherwise than the true quotient of the CPU and the JAX package (the
    card and the CPU must agree bit for bit where a quotient is floored or
    compared)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def limit_period(val, offset: float = 0.5, period: float = 2 * math.pi):
    """``val`` wrapped into ``[-offset * period, (1 - offset) * period)``
    (``spsnet_tpu/utils/common.py:39-41``)."""
    return val - torch.floor(val / period + offset) * period


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, step)``: the port's counterpart
    of ``fold_in(PRNGKey(seed), step)``. The CPU generator keeps only the
    low 32 bits of a seed, so the pair is hashed to 32 bits (a seed built
    as ``seed * 2**32 + step`` would draw the same numbers for every
    ``seed``). Drawn on the CPU, the numbers are the same on every device."""
    key = hashlib.blake2b(f'{int(seed)}:{int(step)}'.encode(),
                          digest_size=4).digest()
    return torch.Generator().manual_seed(int.from_bytes(key, 'little'))


def to_device(t, device):
    """``t`` (on the CPU) on ``device``; to a CUDA device through pinned
    memory with ``non_blocking``, so that the copy waits for no stream."""
    if torch.device(device).type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
