"""Host voxelization and the sparse-conv plan of the voxel detectors.

Plain numpy copies of two steps of the JAX package's ``DataProcessor``
(``spsnet_tpu/data/processor/data_processor.py:233-283``
``transform_points_to_voxels`` and ``:315-335`` ``build_sparse_conv_plan``),
which the port may not import (its module imports JAX); the rest of the
processor queue waits for ROADMAP item G. ``voxel_batch`` runs both over a
batch of scans as a config's test-mode ``DATA_PROCESSOR`` sets them and
collates the result: what the voxel detectors' forward reads.
"""
from __future__ import annotations

import numpy as np

from .sparse_plan import build_sparse_plan


def transform_points_to_voxels(points, point_cloud_range, voxel_size,
                               max_voxels: int, max_points: int):
    """Fixed-shape voxelization of one (N, C) scan: hash-bucket the points
    in range by voxel, stable-sort them by key, keep the first
    ``max_points`` of each of the first ``max_voxels`` voxels (in key
    order). Returns 'voxels' (max_voxels, max_points, C) float32 zero
    padded, 'voxel_coords' (max_voxels, 3) int64 zyx, 'voxel_num_points'
    (max_voxels,) int32 and 'voxel_valid' (max_voxels,) bool."""
    pcr = np.asarray(point_cloud_range, dtype=np.float32)
    vs = np.asarray(voxel_size, dtype=np.float32)
    grid = np.round((pcr[3:6] - pcr[0:3]) / vs).astype(np.int64)

    coords = np.floor((points[:, :3] - pcr[:3]) / vs).astype(np.int64)
    in_range = ((coords >= 0) & (coords < grid)).all(axis=1)
    points_v = points[in_range]
    coords = coords[in_range]
    keys = (coords[:, 2] * grid[1] + coords[:, 1]) * grid[0] + coords[:, 0]
    order = np.argsort(keys, kind='stable')
    keys_s, points_s, coords_s = keys[order], points_v[order], coords[order]
    uniq, starts, counts = np.unique(keys_s, return_index=True,
                                     return_counts=True)
    n_voxels = min(len(uniq), max_voxels)

    voxels = np.zeros((max_voxels, max_points, points.shape[1]),
                      dtype=np.float32)
    voxel_coords = np.zeros((max_voxels, 3), dtype=np.int64)
    voxel_num_points = np.zeros((max_voxels,), dtype=np.int32)
    # each point's voxel and its slot in the voxel
    vid = np.searchsorted(uniq, keys_s)
    slot = np.arange(len(keys_s)) - starts[vid]
    ok = (vid < n_voxels) & (slot < max_points)
    voxels[vid[ok], slot[ok]] = points_s[ok]
    voxel_coords[:n_voxels] = coords_s[starts[:n_voxels]][:, [2, 1, 0]]
    voxel_num_points[:n_voxels] = np.minimum(counts[:n_voxels], max_points)
    return {'voxels': voxels, 'voxel_coords': voxel_coords,
            'voxel_num_points': voxel_num_points,
            'voxel_valid': np.arange(max_voxels) < n_voxels}


def sparse_grid_zyx(point_cloud_range, voxel_size):
    """The sparse backbone's (nz + 1, ny, nx): the voxel grid with z padded
    by one empty slice, as the reference's ``sparse_shape = grid[::-1] +
    [1, 0, 0]`` (``spconv_backbone.py:76``)."""
    pcr = np.asarray(point_cloud_range, dtype=np.float32)
    vs = np.asarray(voxel_size)
    grid_xyz = np.round((pcr[3:6] - pcr[0:3]) / vs).astype(np.int64)
    grid_zyx = grid_xyz[::-1].copy()
    grid_zyx[0] += 1
    return grid_zyx


def build_sparse_conv_plan(voxel_coords, voxel_valid, point_cloud_range,
                           voxel_size, max_voxels_per_level=None):
    """``VoxelBackBone8x``'s neighbour tables, coordinates and valid masks
    of one frame (``sparse_plan.build_sparse_plan`` over
    ``sparse_grid_zyx``), each level padded to ``max_voxels_per_level``
    rows (the frame's voxel count by default)."""
    plan = build_sparse_plan(
        voxel_coords, voxel_valid,
        sparse_grid_zyx(point_cloud_range, voxel_size),
        max_voxels_per_level=int(max_voxels_per_level
                                 or voxel_coords.shape[0]))
    plan.pop('final_grid')
    return plan


def _by_mode(value, mode):
    return int(value[mode]) if hasattr(value, 'keys') else int(value)


def voxel_batch(points, data_cfg, mode: str = 'test'):
    """(B, N, C) scans -> the collated numpy batch of a voxel detector:
    'points' and, stacked over the frames, the voxels of
    ``transform_points_to_voxels`` and the plan of
    ``build_sparse_conv_plan`` at the settings of ``data_cfg``'s
    ``DATA_PROCESSOR`` (``mode`` picks 'train' or 'test' limits). Range
    masking and shuffling are not applied: points outside the range get no
    voxel and stay in 'points' (the synthetic scans lie inside it)."""
    steps = {p['NAME']: p for p in data_cfg.DATA_PROCESSOR}
    vox = steps['transform_points_to_voxels']
    pcr = data_cfg.POINT_CLOUD_RANGE
    plan_cfg = steps['build_sparse_conv_plan']
    frames = []
    for scan in points:
        frame = transform_points_to_voxels(
            scan, pcr, vox['VOXEL_SIZE'],
            _by_mode(vox['MAX_NUMBER_OF_VOXELS'], mode),
            int(vox['MAX_POINTS_PER_VOXEL']))
        frame.update(build_sparse_conv_plan(
            frame['voxel_coords'], frame['voxel_valid'], pcr,
            vox['VOXEL_SIZE'], plan_cfg.get('MAX_VOXELS_PER_LEVEL', None)))
        frames.append(frame)
    batch = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    batch['points'] = np.asarray(points, dtype=np.float32)
    return batch
