"""3-NN search and inverse-distance-weighted interpolation, channel-last.

Port of ``spsnet_tpu/ops/interpolate.py`` (the rebuild of
``interpolate_gpu.cu:16-177``). ``three_nn`` returns squared distances in
the |a|^2 + |b|^2 - 2ab form of ``calc_square_dist``, ascending, the lowest
index first among equal distances (the ``jax.lax.top_k`` order). Every sum
here is written out term by term, each product and sum its own rounded
elementwise op, so a CUDA tensor and a CPU tensor give the same bits; the
distance matrix is built in blocks of unknown points, which changes no
value. ``three_nn`` runs that plain version for a CPU tensor and the CUDA
kernel ``csrc/three_nn.cu`` (K6), which computes the same bits, for a CUDA
tensor; the JAX package computes it outside any Pallas kernel, in XLA, so
K6 ports no TPU kernel. The interpolation is plain PyTorch on every device.
"""
from __future__ import annotations

import torch

from . import _build

# (B, chunk, M) fp32 distance blocks of at most 2**27 entries (512 MB):
# FP layer 0 of PointRCNN, (8, 16384, 4096), takes 4 blocks
_BLOCK_ENTRIES = 1 << 27


def _sq_norm(p):
    """(..., 3) -> (...): ``(x*x + y*y) + z*z``."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + \
        p[..., 2] * p[..., 2]


def _three_nn_block(unknown, known, known_sq):
    u = unknown
    cross = (u[..., 0:1] * known[:, None, :, 0]
             + u[..., 1:2] * known[:, None, :, 1]) \
        + u[..., 2:3] * known[:, None, :, 2]
    d2 = (_sq_norm(u)[..., None] + known_sq[:, None, :]) - 2.0 * cross
    dists, idx = [], []
    for k in range(3):
        i = d2.argmin(dim=-1, keepdim=True)  # first minimal index
        dists.append(d2.gather(-1, i))
        idx.append(i)
        if k < 2:
            d2.scatter_(-1, i, torch.inf)
    return torch.cat(dists, dim=-1), torch.cat(idx, dim=-1)


def _check(unknown, known):
    if unknown.dim() != 3 or known.dim() != 3 or unknown.shape[-1] != 3 or \
            known.shape[-1] != 3 or unknown.shape[0] != known.shape[0] or \
            unknown.dtype != torch.float32 or known.dtype != torch.float32 \
            or unknown.device != known.device:
        raise ValueError(f'three_nn takes (B, N, 3) and (B, M, 3) float32 on '
                         f'one device, got {tuple(unknown.shape)} '
                         f'{unknown.dtype} {unknown.device} and '
                         f'{tuple(known.shape)} {known.dtype} {known.device}')
    if known.shape[1] < 3:
        raise ValueError(f'three_nn needs at least 3 known points, got '
                         f'{known.shape[1]}')


def three_nn_plain(unknown, known):
    """Plain PyTorch ``three_nn``, in blocks of unknown points."""
    _check(unknown, known)
    B, N, _ = unknown.shape
    M = known.shape[1]
    known_sq = _sq_norm(known)
    chunk = max(1, _BLOCK_ENTRIES // max(1, B * M))
    parts = [_three_nn_block(unknown[:, n0:n0 + chunk], known, known_sq)
             for n0 in range(0, N, chunk)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


def three_nn_kernel(unknown, known):
    """``three_nn`` through the CUDA kernel ``csrc/three_nn.cu``: one
    thread a query, the known points staged through shared memory."""
    _check(unknown, known)
    for t in (unknown, known):
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError('the three_nn kernel needs contiguous CUDA '
                             f'tensors, got {t.device}')
    B, N, _ = unknown.shape
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((B, N, 3), dtype=torch.int64, device=unknown.device)
    lib = _build.library('three_nn')
    with torch.cuda.device(unknown.device):
        err = lib.spsnet_three_nn(unknown.data_ptr(), known.data_ptr(),
                                  dist.data_ptr(), idx.data_ptr(), B, N,
                                  known.shape[1],
                                  _build.stream_ptr(unknown.device))
    _build.check(err, 'three_nn')
    _build.LAUNCHES['three_nn'] += 1
    return dist, idx


def three_nn(unknown, known):
    """The 3 nearest ``known`` points of each ``unknown`` point: the plain
    version for a CPU tensor, the kernel for a CUDA tensor.

    Args:
        unknown: (B, N, 3); known: (B, M, 3) with M >= 3, float32.
    Returns:
        dist2: (B, N, 3) squared distances, ascending;
        idx: (B, N, 3) int64 indices into M, the lowest first among equal
        distances.
    """
    if unknown.device.type == 'cpu':
        return three_nn_plain(unknown, known)
    return three_nn_kernel(unknown.contiguous(), known.contiguous())


def three_interpolate(features, idx, weight):
    """(B, M, C) features, (B, N, 3) indices and weights -> (B, N, C):
    ``(f0*w0 + f1*w1) + f2*w2`` of the three neighbours."""
    B, N, _ = idx.shape
    C = features.shape[-1]
    g = features.gather(1, idx.reshape(B, N * 3, 1).expand(-1, -1, C))
    g = g.reshape(B, N, 3, C)
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) + \
        g[:, :, 2] * w[:, :, 2]


def three_interpolate_weights(dist2, eps: float = 1e-8):
    """Normalised inverse-distance weights (``pointnet2_modules.py:
    561-565``): ``r / (r0 + r1 + r2)`` with ``r = 1 / (d2 + eps)``."""
    recip = 1.0 / (dist2 + eps)
    norm = (recip[..., 0] + recip[..., 1]) + recip[..., 2]
    return recip / norm[..., None]
