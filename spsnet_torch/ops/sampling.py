"""Farthest point sampling: a CUDA kernel and its plain PyTorch version.

Semantics (``pcdet/ops/pointnet2/pointnet2_batch/src/sampling_gpu.cu:93-209``,
as in ``spsnet_tpu/ops/sampling.py``): the first pick is index 0, each step
lowers the running min squared distance by the distance to the last pick and
picks the argmax, the lowest index winning ties. Under a ``valid_mask`` the
first pick is the first valid point and invalid points hold distance -1, so
they are never picked while a valid point remains.

``farthest_point_sample`` runs the plain version for a CPU tensor and the
kernel (``csrc/fps.cu``) for a CUDA tensor; there is no other path.
"""
from __future__ import annotations

import torch

from . import _build


def calc_square_dist(a, b):
    """Squared pairwise distances, (B, N, C) x (B, M, C) -> (B, N, M), in the
    |a|^2 + |b|^2 - 2ab form (``pointnet2_modules.py:19-43``)."""
    a_sq = (a * a).sum(-1, keepdim=True)
    b_sq = (b * b).sum(-1, keepdim=True)
    return a_sq + b_sq.transpose(1, 2) - 2.0 * torch.bmm(a, b.transpose(1, 2))


def sq_dist_to(xyz, pt):
    """(B, N, 3) x (B, 1, 3) -> (B, N): ``(dx*dx + dy*dy) + dz*dz``, each
    product and sum rounded separately, in the kernels' order."""
    d = xyz - pt
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _check(xyz, npoint, valid_mask):
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f'xyz must be (B, N, 3) float32, got '
                         f'{tuple(xyz.shape)} {xyz.dtype}')
    if not 1 <= npoint <= xyz.shape[1]:
        raise ValueError(f'npoint must be in [1, N={xyz.shape[1]}], got {npoint}')
    if valid_mask is not None and (valid_mask.shape != xyz.shape[:2]
                                   or valid_mask.dtype != torch.bool
                                   or valid_mask.device != xyz.device):
        raise ValueError('valid_mask must be a (B, N) bool tensor on the '
                         'device of xyz')


def farthest_point_sample_plain(xyz, npoint: int, valid_mask=None):
    """Plain PyTorch FPS: (B, N, 3) -> (B, npoint) int64."""
    _check(xyz, npoint, valid_mask)
    B, N, _ = xyz.shape
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    if valid_mask is None:
        last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    else:
        dist = torch.where(valid_mask, dist, -1.0)
        # argmax of a bool row = its first True (0 when none)
        last = valid_mask.to(torch.uint8).argmax(dim=1)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    out[:, 0] = last
    rows = torch.arange(B, device=xyz.device)
    for j in range(1, npoint):
        d2 = sq_dist_to(xyz, xyz[rows, last][:, None, :])
        if valid_mask is not None:
            d2 = torch.where(valid_mask, d2, -1.0)
        dist = torch.minimum(dist, d2)
        last = dist.argmax(dim=1)  # first maximal index
        out[:, j] = last
    return out


def farthest_point_sample_kernel(xyz, npoint: int, valid_mask=None):
    """FPS through the CUDA kernel ``csrc/fps.cu``: (B, N, 3) -> (B, npoint)
    int64 on the device of ``xyz``."""
    _check(xyz, npoint, valid_mask)
    if xyz.device.type != 'cuda':
        raise ValueError(f'the FPS kernel needs a CUDA tensor, got {xyz.device}')
    if not xyz.is_contiguous() or (valid_mask is not None
                                   and not valid_mask.is_contiguous()):
        raise ValueError('the FPS kernel needs contiguous inputs')
    lib = _build.library('fps')
    B, N, _ = xyz.shape
    max_n = lib.spsnet_fps_max_n()
    if N > max_n:
        raise ValueError(f'the FPS kernel takes N <= {max_n}, got {N}')
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.spsnet_fps(
            xyz.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(),
            out.data_ptr(), B, N, npoint, _build.stream_ptr(xyz.device))
    _build.check(err, 'fps')
    _build.LAUNCHES['fps'] += 1
    return out


def farthest_point_sample(xyz, npoint: int, valid_mask=None):
    """Exact FPS, (B, N, 3) float32 -> (B, npoint) int64: the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if xyz.device.type == 'cpu':
        return farthest_point_sample_plain(xyz, npoint, valid_mask)
    return farthest_point_sample_kernel(xyz, npoint, valid_mask)
