"""Farthest point sampling, exact and seeded: CUDA kernels and their plain
PyTorch versions.

Semantics (``pcdet/ops/pointnet2/pointnet2_batch/src/sampling_gpu.cu:93-209``,
as in ``spsnet_tpu/ops/sampling.py``): the first pick is index 0, each step
lowers the running min squared distance by the distance to the last pick and
picks the argmax, the lowest index winning ties. Under a ``valid_mask`` the
first pick is the first valid point and invalid points hold distance -1, so
they are never picked while a valid point remains.

Seeded FPS (``spsnet_tpu/ops/pallas/fps.py:387-606``) pre-selects ``k0``
seeds, starts the running min from their min squared distance (``seed_min_d2``)
and runs only ``npoint - k0`` exact steps from the last seed. It is an
approximation of FPS and off unless a ``FpsSeeding`` is passed.

``farthest_point_sample_batched`` and ``farthest_point_sample_hier_argmax``
are the counterparts of the JAX package's experimental FPS entries (K5a-c),
which compute exact FPS through other TPU layouts. Both ideas (every row in
one step loop, a hierarchical argmax) are inside the exact FPS kernel
already (one cluster a row, all rows at once; ``redux.sync`` reductions), so
on the card both entries launch it. The JAX entries take no mask and pad N
to 128 lanes; the kernel handles any N.

Chunked FPS (``spsnet_tpu/ops/pallas/fps.py:610-639``) splits each row's
index space into S equal slices and runs exact FPS of npoint / S picks in
each: on a shuffled cloud, a spatially stratified approximation of FPS.
It is off unless an ``FpsChunks`` is passed; on the card it is a reshape
around the exact kernel.

F-FPS (``farthest_point_sample_with_dist``, as
``spsnet_tpu/ops/sampling.py:200-225``) runs the same step loop over a
precomputed (B, N, N) squared-distance matrix: the first pick is index 0,
each step lowers the running min (from 1e10) by the last pick's row and
picks the argmax, NaN above every number and the lowest index winning
ties. JAX computes it in XLA; its kernel here, ``csrc/fps_dist.cu``, is
not a port of a Pallas kernel. The kernel ranks the running minima by an
unsigned key (``fps_dist_key`` is its CPU twin) and shares a row across
a thread-block cluster, as the exact FPS kernel does.

Each op runs its plain version for a CPU tensor and its kernel for a CUDA
tensor (``csrc/fps.cu``, ``csrc/seed_min.cu``, ``csrc/fps_dist.cu``);
there is no other path.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

# seeds per distance block of the plain seed_min_d2: (4, 16384, 256) fp32
# planes are 64 MB each
_SEED_CHUNK = 256
SEED_GRID = (32, 32, 8)


def calc_square_dist(a, b):
    """Squared pairwise distances, (B, N, C) x (B, M, C) -> (B, N, M), in the
    |a|^2 + |b|^2 - 2ab form (``pointnet2_modules.py:19-43``)."""
    a_sq = (a * a).sum(-1, keepdim=True)
    b_sq = (b * b).sum(-1, keepdim=True)
    return a_sq + b_sq.transpose(1, 2) - 2.0 * torch.bmm(a, b.transpose(1, 2))


def _check_dist(dist_mat, npoint):
    if dist_mat.dim() != 3 or dist_mat.shape[1] != dist_mat.shape[2] or \
            dist_mat.dtype != torch.float32:
        raise ValueError(f'dist_mat must be (B, N, N) float32, got '
                         f'{tuple(dist_mat.shape)} {dist_mat.dtype}')
    if not 1 <= npoint <= dist_mat.shape[1]:
        raise ValueError(f'npoint must be in [1, N={dist_mat.shape[1]}], '
                         f'got {npoint}')


def farthest_point_sample_with_dist_plain(dist_mat, npoint: int):
    """Plain F-FPS over a (B, N, N) float32 squared-distance matrix ->
    (B, npoint) int64: ``torch.minimum`` (NaN on either side gives NaN)
    and ``argmax`` (NaN first, then the first maximal index), as JAX's
    ``jnp.minimum`` and ``jnp.argmax``."""
    _check_dist(dist_mat, npoint)
    B, N, _ = dist_mat.shape
    dist = torch.full((B, N), 1e10, dtype=torch.float32,
                      device=dist_mat.device)
    last = torch.zeros(B, dtype=torch.int64, device=dist_mat.device)
    out = torch.zeros((B, npoint), dtype=torch.int64, device=dist_mat.device)
    rows = torch.arange(B, device=dist_mat.device)
    for j in range(1, npoint):
        dist = torch.minimum(dist, dist_mat[rows, last])
        last = dist.argmax(dim=1)
        out[:, j] = last
    return out


def fps_dist_key(values):
    """The order key by which ``csrc/fps_dist.cu`` ranks float32 running
    minima, as int64 in [0, 2**32): a negative float's bits flipped, a
    non-negative one's with the sign bit set, -0.0 as +0.0 and every NaN
    0xffffffff, so that the keys order as ``argmax`` ranks the floats (NaN
    first, -0.0 tied with +0.0)."""
    u = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    key = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(torch.isnan(values), 0xFFFFFFFF, key)


def farthest_point_sample_with_dist_kernel(dist_mat, npoint: int):
    """F-FPS through the CUDA kernel ``csrc/fps_dist.cu`` (a cluster of CTAs
    a row, the running minima in registers): (B, N, N) float32 ->
    (B, npoint) int64 on the device of ``dist_mat``."""
    _check_dist(dist_mat, npoint)
    _require_cuda('F-FPS', dist_mat)
    lib = _build.library('fps_dist')
    B, N, _ = dist_mat.shape
    max_n = lib.spsnet_fps_dist_max_n()
    if N > max_n:
        raise ValueError(f'the F-FPS kernel takes N <= {max_n}, got {N}')
    out = torch.empty((B, npoint), dtype=torch.int64, device=dist_mat.device)
    with torch.cuda.device(dist_mat.device):
        err = lib.spsnet_fps_dist(dist_mat.data_ptr(), out.data_ptr(), B, N,
                                  npoint, _build.stream_ptr(dist_mat.device))
    _build.check(err, 'fps_dist')
    _build.LAUNCHES['fps_dist'] += 1
    return out


def farthest_point_sample_with_dist(dist_mat, npoint: int):
    """F-FPS over a precomputed (B, N, N) squared-distance matrix ->
    (B, npoint) int64: the plain version for a CPU tensor, the kernel for
    a CUDA tensor."""
    if dist_mat.device.type == 'cpu':
        return farthest_point_sample_with_dist_plain(dist_mat, npoint)
    return farthest_point_sample_with_dist_kernel(dist_mat, npoint)


def sq_dist_to(xyz, pt):
    """(B, N, 3) x (B, 1, 3) -> (B, N): ``(dx*dx + dy*dy) + dz*dz``, each
    product and sum rounded separately, in the kernels' order."""
    d = xyz - pt
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


@dataclass(frozen=True)
class FpsSeeding:
    """Seeded D-FPS at the call sites that opt in (the SA-module D-FPS).

    ``mode``: ``head`` seeds with the first ``k0`` points (the cloud is
    shuffled upstream, so a uniform subsample), ``grid`` with
    ``grid_seed_indices`` (one point per occupied voxel first), and
    ``grid_only`` takes all ``npoint`` picks from ``grid_seed_indices`` and
    runs no FPS step (``fraction`` must then be 1.0). ``fraction`` in (0, 1)
    sets ``k0`` (``seed_k0``).
    """
    fraction: float = 0.75
    mode: str = 'grid'

    def __post_init__(self):
        if self.mode not in ('head', 'grid', 'grid_only'):
            raise ValueError(f'FpsSeeding mode must be head, grid or '
                             f'grid_only, got {self.mode!r}')
        if self.mode == 'grid_only':
            if self.fraction != 1.0:
                raise ValueError('grid_only takes every pick from the grid: '
                                 'fraction must be 1.0')
        elif not 0.0 < self.fraction < 1.0:
            raise ValueError(f'FpsSeeding fraction must be in (0, 1), got '
                             f'{self.fraction}')


@dataclass(frozen=True)
class FpsChunks:
    """Chunked FPS at the call sites that opt in (the SA-module D-FPS, in
    the place of an ``FpsSeeding``): ``chunks`` equal slices of each row's
    index space, exact FPS of npoint / chunks picks in each
    (``farthest_point_sample_chunked``), where ``chunks`` divides N and
    npoint and no mask is given; exact FPS elsewhere. No config turns it
    on, and no quality gate covers it."""
    chunks: int = 4

    def __post_init__(self):
        if self.chunks < 2:
            raise ValueError(f'FpsChunks needs chunks >= 2, got '
                             f'{self.chunks}')


def seed_k0(seeding: FpsSeeding | None, npoint: int) -> int:
    """Seeds of a seeded FPS of ``npoint`` picks, 0 when seeding does not
    engage (``spsnet_tpu/ops/sampling.py:69-88``): ``int(f * npoint)``
    rounded down to a multiple of 128, engaged only when ``0 < k0 < npoint``
    (npoint <= 170 disengages at f = 0.75); ``grid_only`` engages with
    ``k0 = npoint`` when npoint is a multiple of 128."""
    if not isinstance(seeding, FpsSeeding):
        return 0
    if seeding.mode == 'grid_only':
        return npoint if npoint % 128 == 0 else 0
    k0 = int(seeding.fraction * npoint) // 128 * 128
    return k0 if 0 < k0 < npoint else 0


def fps_seeding_active(seeding: FpsSeeding | None, npoint: int, *,
                       allow_seed: bool) -> bool:
    """Whether a D-FPS of ``npoint`` picks at a call site with opt-in
    ``allow_seed`` runs seeded or chunked, so that its picks are no exact
    FPS chain. The single source of the engagement rule for the prefix-
    nesting gates of the SA layer and the backbone (any ``FpsChunks``
    turns the shortcut off, as in ``spsnet_tpu/models/sa_module.py:97-100``)."""
    return allow_seed and (isinstance(seeding, FpsChunks)
                           or seed_k0(seeding, npoint) > 0)


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


def _require_cuda(what, *tensors):
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'the {what} kernel needs CUDA tensors, got '
                             f'{t.device}')
        if not t.is_contiguous():
            raise ValueError(f'the {what} kernel needs contiguous inputs')


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


# cudaErrorLaunchOutOfResources: the FPS launch returns it when
# cudaOccupancyMaxActiveClusters is 0 for its cluster
_NO_CLUSTER = 701


def fps_launch_shape(B: int, N: int) -> tuple:
    """(cluster size, CTA threads) of the cluster FPS launch over (B, N),
    by the fixed rule of ``csrc/fps.cu``. Raises on an N the kernel cannot
    take."""
    lib = _build.library('fps')
    max_n = lib.spsnet_fps_max_n()
    if N > max_n:
        raise ValueError(f'the FPS kernel takes N <= {max_n}, got {N}')
    return lib.spsnet_fps_cluster_size(B, N), lib.spsnet_fps_threads()


def _fps_launched(err, what, B, N):
    if err == _NO_CLUSTER:
        c, t = fps_launch_shape(B, N)
        raise RuntimeError(f'{what}: the card cannot schedule a cluster of {c} '
                           f'CTAs of {t} threads '
                           '(cudaOccupancyMaxActiveClusters is 0)')
    _build.check(err, what)
    _build.LAUNCHES[what] += 1


def farthest_point_sample_kernel(xyz, npoint: int, valid_mask=None):
    """FPS through the CUDA kernel ``csrc/fps.cu``: (B, N, 3) -> (B, npoint)
    int64 on the device of ``xyz``. Each row runs on a cluster of CTAs
    (``fps_launch_shape``)."""
    _check(xyz, npoint, valid_mask)
    _require_cuda('FPS', xyz, *([] if valid_mask is None else [valid_mask]))
    lib = _build.library('fps')
    B, N, _ = xyz.shape
    fps_launch_shape(B, N)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.spsnet_fps(
            xyz.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(),
            out.data_ptr(), B, N, npoint, _build.stream_ptr(xyz.device))
    _fps_launched(err, 'fps', B, N)
    return out


def farthest_point_sample_batched(xyz, npoint: int):
    """Exact FPS with every batch row in one step loop: the counterpart of
    the JAX package's ``farthest_point_sample_pallas_batched`` (K5a,
    ``spsnet_tpu/ops/pallas/fps.py:138``) and
    ``farthest_point_sample_pallas_batched2d`` (K5c, ``fps.py:761``), which
    compute this function through two TPU layouts. (B, N, 3) float32 ->
    (B, npoint) int64: exact ``farthest_point_sample``."""
    return farthest_point_sample(xyz, npoint)


def farthest_point_sample_hier_argmax(xyz, npoint: int):
    """Exact FPS with a hierarchical argmax: the counterpart of the JAX
    package's ``_fps_pallas_allbatch_v2`` (K5b,
    ``spsnet_tpu/ops/pallas/fps.py:316``). (B, N, 3) float32 -> (B, npoint)
    int64: exact ``farthest_point_sample``."""
    return farthest_point_sample(xyz, npoint)


def farthest_point_sample_chunked(xyz, npoint: int, chunks: int):
    """Chunked FPS, (B, N, 3) float32 -> (B, npoint) int64: each row's
    ``chunks`` index slices of N / chunks points take npoint / chunks
    exact FPS picks each (the slice's first point first), in slice order,
    with the slice offsets added. One (B * chunks, N / chunks) exact FPS:
    the plain version for a CPU tensor, one kernel launch for a CUDA
    tensor."""
    _check(xyz, npoint, None)
    B, N, _ = xyz.shape
    if chunks < 1 or N % chunks or npoint % chunks:
        raise ValueError(f'chunks={chunks} must divide N={N} and '
                         f'npoint={npoint}')
    nc, mc = N // chunks, npoint // chunks
    idx = farthest_point_sample(xyz.contiguous().reshape(B * chunks, nc, 3),
                                mc)
    offs = torch.arange(chunks, device=xyz.device) * nc
    return (idx.reshape(B, chunks, mc) + offs[None, :, None]).reshape(
        B, npoint)


def _check_seeds(xyz, seeds):
    if seeds.dim() != 3 or seeds.shape[0] != xyz.shape[0] or \
            seeds.shape[-1] != 3 or seeds.dtype != torch.float32 or \
            seeds.shape[1] < 1 or seeds.device != xyz.device:
        raise ValueError(f'seeds must be (B, k0 >= 1, 3) float32 on the '
                         f'device of xyz, got {tuple(seeds.shape)} '
                         f'{seeds.dtype}')


def seed_min_d2_plain(xyz, seeds):
    """(B, N, 3) points, (B, k0, 3) seeds -> (B, N) min squared distance to
    the seeds, each ``(dx*dx + dy*dy) + dz*dz`` with d = point - seed, in
    blocks of seeds (never (B, N, k0) at once)."""
    _check(xyz, 1, None)
    _check_seeds(xyz, seeds)
    out = None
    for c0 in range(0, seeds.shape[1], _SEED_CHUNK):
        s = seeds[:, c0:c0 + _SEED_CHUNK]
        d = [xyz[..., i][:, :, None] - s[..., i][:, None, :] for i in range(3)]
        m = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).amin(dim=-1)
        out = m if out is None else torch.minimum(out, m)
    return out


def seed_min_launch_shape(B: int, N: int, k0: int) -> tuple:
    """(CTAs a cluster S, points a thread, CTAs of the grid, threads a CTA)
    of the ``seed_min`` launch over (B, N, k0), by the fixed rule of
    ``csrc/seed_min.cu``."""
    shape = (ctypes.c_int * 4)()
    _build.library('seed_min').spsnet_seed_min_shape(B, N, k0, shape)
    return tuple(shape)


def seed_min_d2_kernel(xyz, seeds):
    """``seed_min_d2`` through the CUDA kernel ``csrc/seed_min.cu``: each
    tile of points on a cluster of CTAs that split the seeds
    (``seed_min_launch_shape``)."""
    _check(xyz, 1, None)
    _check_seeds(xyz, seeds)
    _require_cuda('seed_min', xyz, seeds)
    lib = _build.library('seed_min')
    B, N, _ = xyz.shape
    k0 = seeds.shape[1]
    out = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.spsnet_seed_min(xyz.data_ptr(), seeds.data_ptr(),
                                  out.data_ptr(), B, N, k0,
                                  _build.stream_ptr(xyz.device))
    if err == _NO_CLUSTER:
        s = seed_min_launch_shape(B, N, k0)[0]
        raise RuntimeError(f'seed_min: the card cannot schedule a cluster of '
                           f'{s} CTAs (cudaOccupancyMaxActiveClusters is 0)')
    _build.check(err, 'seed_min')
    _build.LAUNCHES['seed_min'] += 1
    return out


def seed_min_d2(xyz, seeds):
    """Min squared distance of each point to the seeds, (B, N) float32: the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if xyz.device.type == 'cpu':
        return seed_min_d2_plain(xyz, seeds)
    return seed_min_d2_kernel(xyz, seeds)


def _check_seeded(xyz, npoint, d0, seed_idx):
    _check(xyz, npoint, None)
    B, N, _ = xyz.shape
    if d0.shape != (B, N) or d0.dtype != torch.float32 or \
            d0.device != xyz.device:
        raise ValueError('d0 must be a (B, N) float32 tensor on the device '
                         'of xyz')
    if seed_idx.dim() != 2 or seed_idx.shape[0] != B or \
            seed_idx.dtype != torch.int64 or seed_idx.device != xyz.device \
            or not 1 <= seed_idx.shape[1] < npoint:
        raise ValueError(f'seed_idx must be (B, k0) int64 on the device of '
                         f'xyz with 1 <= k0 < npoint={npoint}, got '
                         f'{tuple(seed_idx.shape)} {seed_idx.dtype}')


def farthest_point_sample_seeded_plain(xyz, npoint: int, d0, seed_idx):
    """Plain seeded FPS completion: the seeds verbatim, then ``npoint - k0``
    exact FPS steps whose running min starts from ``d0`` and whose chain
    starts from the last seed. -> (B, npoint) int64."""
    _check_seeded(xyz, npoint, d0, seed_idx)
    B, k0 = seed_idx.shape
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    out[:, :k0] = seed_idx
    rows = torch.arange(B, device=xyz.device)
    dist, last = d0, seed_idx[:, -1]
    for j in range(k0, npoint):
        d2 = sq_dist_to(xyz, xyz[rows, last][:, None, :])
        dist = torch.minimum(dist, d2)
        last = dist.argmax(dim=1)  # first maximal index
        out[:, j] = last
    return out


def farthest_point_sample_seeded_kernel(xyz, npoint: int, d0, seed_idx):
    """Seeded FPS completion through the CUDA kernel in ``csrc/fps.cu``, on
    the exact kernel's cluster launch."""
    _check_seeded(xyz, npoint, d0, seed_idx)
    _require_cuda('seeded FPS', xyz, d0, seed_idx)
    lib = _build.library('fps')
    B, N, _ = xyz.shape
    fps_launch_shape(B, N)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.spsnet_fps_seeded(
            xyz.data_ptr(), d0.data_ptr(), seed_idx.data_ptr(),
            out.data_ptr(), B, N, npoint, seed_idx.shape[1],
            _build.stream_ptr(xyz.device))
    _fps_launched(err, 'fps_seeded', B, N)
    return out


def farthest_point_sample_seeded(xyz, npoint: int, k0: int, seed_idx=None):
    """Seeded FPS (``fps.py:514-572``): (B, N, 3) -> (B, npoint) int64, the
    ``k0`` seeds first (``seed_idx``, or ``arange(k0)`` when None), then the
    completion picks in selection order."""
    _check(xyz, npoint, None)
    B = xyz.shape[0]
    if not 0 < k0 < npoint:
        raise ValueError(f'need 0 < k0 < npoint, got k0={k0}, '
                         f'npoint={npoint}')
    if seed_idx is None:
        seed_idx = torch.arange(k0, device=xyz.device).expand(B, k0)
    if seed_idx.shape != (B, k0):
        raise ValueError(f'seed_idx must be (B, k0) = ({B}, {k0}), got '
                         f'{tuple(seed_idx.shape)}')
    seed_idx = seed_idx.to(torch.int64).contiguous()
    seeds = xyz.gather(1, seed_idx[..., None].expand(-1, -1, 3)).contiguous()
    d0 = seed_min_d2(xyz, seeds)
    if xyz.device.type == 'cpu':
        return farthest_point_sample_seeded_plain(xyz, npoint, d0, seed_idx)
    return farthest_point_sample_seeded_kernel(xyz, npoint, d0, seed_idx)


def grid_seed_indices(xyz, k0: int, grid=SEED_GRID):
    """(B, N, 3) -> (B, k0) int64 voxel-stratified seeds (``fps.py:576-606``):
    quantise each scene onto ``grid`` cells of its bounding box, take one
    point per occupied cell (the lowest index), in index order, then the
    lowest-index other points. All indices are distinct: the sort key
    ``cell * N + index`` has no ties."""
    B, N, _ = xyz.shape
    if not 1 <= k0 <= N:
        raise ValueError(f'k0 must be in [1, N={N}], got {k0}')
    gf = torch.tensor(grid, dtype=torch.float32, device=xyz.device)
    gi = torch.tensor(grid, dtype=torch.int32, device=xyz.device)
    mn = xyz.amin(dim=1, keepdim=True)
    mx = xyz.amax(dim=1, keepdim=True)
    cell = torch.clamp((mx - mn) / gf, min=1e-6)
    q = torch.minimum(torch.clamp(((xyz - mn) / cell).to(torch.int32), min=0),
                      gi - 1).to(torch.int64)
    vid = (q[..., 2] * grid[1] + q[..., 1]) * grid[0] + q[..., 0]
    comp = torch.sort(vid * N + torch.arange(N, device=xyz.device)).values
    svid, sidx = comp // N, comp % N
    first = torch.ones_like(svid, dtype=torch.bool)
    first[:, 1:] = svid[:, 1:] != svid[:, :-1]
    key = torch.where(first, sidx, sidx + N)  # cell representatives first
    return torch.topk(key, k0, dim=1, largest=False, sorted=True).values % N


def farthest_point_sample(xyz, npoint: int, valid_mask=None,
                          seeding: FpsSeeding | FpsChunks | None = None):
    """D-FPS, (B, N, 3) float32 -> (B, npoint) int64: exact unless
    ``seeding`` engages for this ``npoint`` (``seed_k0``); then grid or head
    seeds, their min distances (``seed_min_d2``) and the seeded completion.
    An ``FpsChunks`` takes the chunked FPS where its chunks divide N and
    npoint and no mask is given. Plain versions for a CPU tensor, CUDA
    kernels for a CUDA tensor."""
    if isinstance(seeding, FpsChunks):
        s = seeding.chunks
        if valid_mask is None and xyz.shape[1] % s == 0 and npoint % s == 0:
            return farthest_point_sample_chunked(xyz, npoint, s)
        seeding = None
    k0 = seed_k0(seeding, npoint)
    if k0 == 0:
        if xyz.device.type == 'cpu':
            return farthest_point_sample_plain(xyz, npoint, valid_mask)
        return farthest_point_sample_kernel(xyz, npoint, valid_mask)
    if valid_mask is not None:
        raise ValueError('seeded FPS takes no valid_mask')
    _check(xyz, npoint, None)
    if k0 == npoint:  # grid_only
        return grid_seed_indices(xyz, npoint)
    seed_idx = grid_seed_indices(xyz, k0) if seeding.mode == 'grid' else None
    return farthest_point_sample_seeded(xyz, npoint, k0, seed_idx)
