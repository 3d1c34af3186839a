"""Host-side planning for sparse convolution (a copy of
``spsnet_tpu/data/processor/sparse_plan.py``, which the port may not
import; ``tests/test_torch_pvrcnn.py`` holds its tables to the original's).

The reference's voxel backbones run spconv CUDA kernels
(``backbones_3d/spconv_backbone.py``). Here sparse convolution is a gather
of neighbours and one matmul, with the irregular part (active sites and
neighbour tables) planned once per frame on the host in vectorized numpy;
the device then runs dense ops over fixed-size padded voxel lists.

For each geometry level ℓ the plan holds:
- ``coords_ℓ``: (Vmax, 3) zyx int32, zero-padded, + ``valid_ℓ`` mask;
- for each conv in the level: a neighbor table (Vmax_out, K) int32 indexing
  the INPUT level's voxel list, with ``Vmax_in`` as the "missing" sentinel
  (device pads features with a zero row).

Layer geometry matches spconv: submanifold convs keep the active set;
strided sparse convs produce the union of output sites touched by any input.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

KERNEL3 = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing='ij'),
                   axis=-1).reshape(-1, 3)          # (27, 3) zyx offsets


def _keys(coords, grid):
    return (coords[:, 0].astype(np.int64) * grid[1] + coords[:, 1]) \
        * grid[2] + coords[:, 2]


def _lookup(table_keys_sorted, sort_idx, query_keys):
    """Vectorized hash-join: query -> index into the ORIGINAL coord list,
    -1 when absent."""
    pos = np.searchsorted(table_keys_sorted, query_keys)
    pos = np.clip(pos, 0, len(table_keys_sorted) - 1)
    hit = table_keys_sorted[pos] == query_keys
    idx = np.where(hit, sort_idx[pos], -1)
    return idx


def subm_table(coords, valid, grid, kernel=KERNEL3):
    """Submanifold conv neighbor table: (V, K) indices into the same level."""
    V = coords.shape[0]
    act = coords[valid]
    keys = _keys(act, grid)
    order = np.argsort(keys)
    keys_sorted = keys[order]
    orig_idx = np.flatnonzero(valid)[order]

    nbr = np.full((V, len(kernel)), V, dtype=np.int32)   # V = sentinel
    q = act[:, None, :] + kernel[None, :, :]             # (Va, K, 3)
    in_grid = ((q >= 0) & (q < np.asarray(grid))).all(-1)
    qk = _keys(q.reshape(-1, 3), grid)
    found = _lookup(keys_sorted, orig_idx, qk).reshape(len(act), len(kernel))
    found = np.where(in_grid & (found >= 0), found, V)
    nbr[np.flatnonzero(valid)] = found
    return nbr.astype(np.int32)


def spconv_down(coords, valid, grid, stride, padding, kernel_size,
                max_out):
    """Strided sparse conv: returns (out_coords (Vmax_out, 3), out_valid,
    table (Vmax_out, K) into the input level, new grid)."""
    stride = np.asarray(stride)
    padding = np.asarray(padding)
    ks = np.asarray(kernel_size)
    kernel = np.stack(np.meshgrid(*[np.arange(k) for k in ks],
                                  indexing='ij'), axis=-1).reshape(-1, 3)
    act = coords[valid]
    new_grid = ((np.asarray(grid) + 2 * padding - (ks - 1) - 1) // stride) + 1

    # candidate output sites per (input, kernel offset):
    # out = (in + pad - k) / stride where divisible and in range
    cand = act[:, None, :] + padding[None, None, :] - kernel[None, :, :]
    div_ok = (cand % stride[None, None, :] == 0).all(-1)
    out = cand // stride[None, None, :]
    in_rng = ((out >= 0) & (out < new_grid)).all(-1)
    ok = div_ok & in_rng
    out_flat = out[ok]
    out_keys = _keys(out_flat, new_grid)
    uniq_keys = np.unique(out_keys)
    n_out = min(len(uniq_keys), max_out)
    uniq_keys = uniq_keys[:n_out]

    out_coords = np.zeros((max_out, 3), dtype=np.int32)
    oz = uniq_keys // (new_grid[1] * new_grid[2])
    rem = uniq_keys % (new_grid[1] * new_grid[2])
    out_coords[:n_out] = np.stack([oz, rem // new_grid[2],
                                   rem % new_grid[2]], axis=-1)
    out_valid = np.arange(max_out) < n_out

    # input lookup structures
    V_in = coords.shape[0]
    act_keys = _keys(act, grid)
    order = np.argsort(act_keys)
    keys_sorted = act_keys[order]
    orig_idx = np.flatnonzero(valid)[order]

    # for each output site + kernel offset: input coord = out*stride - pad + k
    q = out_coords[:n_out, None, :] * stride[None, None, :] \
        - padding[None, None, :] + kernel[None, :, :]
    in_grid_ok = ((q >= 0) & (q < np.asarray(grid))).all(-1)
    qk = _keys(q.reshape(-1, 3), grid)
    found = _lookup(keys_sorted, orig_idx, qk).reshape(n_out, len(kernel))
    found = np.where(in_grid_ok & (found >= 0), found, V_in)

    table = np.full((max_out, len(kernel)), V_in, dtype=np.int32)
    table[:n_out] = found
    return out_coords, out_valid, table.astype(np.int32), tuple(
        int(x) for x in new_grid)


def spconv_up_table(fine_coords, fine_valid, fine_grid, coarse_coords,
                    coarse_valid, coarse_grid, stride, padding, kernel_size):
    """Inverse (transposed) sparse conv neighbor table for UNet decoders:
    for each FINE active site, the coarse voxels whose forward receptive
    field covered it — i.e. coarse = (fine + pad - k) / stride when integral.

    Returns (V_fine, K) indices into the coarse level (sentinel = V_coarse).
    """
    stride = np.asarray(stride)
    padding = np.asarray(padding)
    ks = np.asarray(kernel_size)
    kernel = np.stack(np.meshgrid(*[np.arange(k) for k in ks],
                                  indexing='ij'), axis=-1).reshape(-1, 3)
    V_fine = fine_coords.shape[0]
    V_coarse = coarse_coords.shape[0]
    act = fine_coords[fine_valid]
    c_act = coarse_coords[coarse_valid]
    c_keys = _keys(c_act, coarse_grid)
    order = np.argsort(c_keys)
    keys_sorted = c_keys[order]
    orig_idx = np.flatnonzero(coarse_valid)[order]

    cand = act[:, None, :] + padding[None, None, :] - kernel[None, :, :]
    div_ok = (cand % stride[None, None, :] == 0).all(-1)
    q = cand // stride[None, None, :]
    in_rng = ((q >= 0) & (q < np.asarray(coarse_grid))).all(-1)
    qk = _keys(np.clip(q, 0, None).reshape(-1, 3), coarse_grid)
    found = _lookup(keys_sorted, orig_idx, qk).reshape(len(act), len(kernel))
    found = np.where(div_ok & in_rng & (found >= 0), found, V_coarse)

    table = np.full((V_fine, len(kernel)), V_coarse, dtype=np.int32)
    table[np.flatnonzero(fine_valid)] = found
    return table.astype(np.int32)


# VoxelBackBone8x geometry (``spconv_backbone.py:69-180``): channel plan
# [16, 16, 32, 64, 64] + conv_out 128; strided convs at conv2/3/4 + the
# (3,1,1)-kernel z-compression conv_out.
BACKBONE8X_PLAN = [
    # (name, type, stride, padding, kernel)
    ('subm1', 'subm', None, None, (3, 3, 3)),
    ('down2', 'down', (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ('subm2', 'subm', None, None, (3, 3, 3)),
    ('down3', 'down', (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ('subm3', 'subm', None, None, (3, 3, 3)),
    ('down4', 'down', (2, 2, 2), (0, 1, 1), (3, 3, 3)),
    ('subm4', 'subm', None, None, (3, 3, 3)),
    ('out', 'down', (2, 1, 1), (0, 0, 0), (3, 1, 1)),
]


def plan_final_grid(grid_zyx, plan=BACKBONE8X_PLAN):
    """Final (nz, ny, nx) after the plan's strided convs — the shape
    HeightCompression scatters to. Pure function of the voxel grid, so the
    detectors can derive it from DATA_CONFIG without a frame."""
    grid = np.asarray(grid_zyx, dtype=np.int64)
    for _, kind, stride, padding, ks in plan:
        if kind == 'down':
            grid = ((grid + 2 * np.asarray(padding)
                     - (np.asarray(ks) - 1) - 1) // np.asarray(stride)) + 1
    return tuple(int(v) for v in grid)


def build_sparse_plan(voxel_coords, voxel_valid, grid_zyx,
                      max_voxels_per_level=None, plan=BACKBONE8X_PLAN,
                      with_up_tables=False):
    """Per-frame plan for the VoxelBackBone8x geometry.

    Args:
        voxel_coords: (V, 3) zyx int; voxel_valid: (V,) bool;
        grid_zyx: (3,) ints (nz, ny, nx).
        with_up_tables: also emit inverse-conv tables for UNet decoders
            (``up{N}_table``: fine level gathering from the coarse level).
    Returns: dict of numpy arrays (tables/coords/valids per layer).
    """
    if max_voxels_per_level is None:
        max_voxels_per_level = voxel_coords.shape[0]
    out: Dict[str, np.ndarray] = {}
    coords, valid, grid = voxel_coords, voxel_valid, tuple(grid_zyx)
    levels = [(coords, valid, grid)]
    down_geoms = []
    for name, kind, stride, padding, ks in plan:
        if kind == 'subm':
            out[f'{name}_table'] = subm_table(coords, valid, grid)
        else:
            fine = (coords, valid, grid)
            coords, valid, table, grid = spconv_down(
                coords, valid, grid, stride, padding, ks,
                max_out=max_voxels_per_level)
            out[f'{name}_table'] = table
            out[f'{name}_coords'] = coords
            out[f'{name}_valid'] = valid
            levels.append((coords, valid, grid))
            down_geoms.append((name, fine, (coords, valid, grid),
                               stride, padding, ks))
    if with_up_tables:
        for name, fine, coarse, stride, padding, ks in down_geoms:
            out[f'{name}_up_table'] = spconv_up_table(
                fine[0], fine[1], fine[2], coarse[0], coarse[1], coarse[2],
                stride, padding, ks)
    out['final_grid'] = np.asarray(grid, dtype=np.int32)
    return out
