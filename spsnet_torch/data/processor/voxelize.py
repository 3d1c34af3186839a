"""Host steps of the voxel and pillar detectors' data processor.

Plain numpy copies of four steps of the JAX package's ``DataProcessor``
(``spsnet_tpu/data/processor/data_processor.py:150-189``
``sample_points``, ``:191-202`` ``transform_points_to_voxels_placeholder``,
``:233-283`` ``transform_points_to_voxels`` and ``:315-335``
``build_sparse_conv_plan``), which the port may not import (its module
imports JAX); the rest of the processor queue (range masking, shuffling)
waits for ROADMAP item G. ``voxel_batch`` runs the steps a config's
``DATA_PROCESSOR`` names over a batch of scans and collates the result:
what the voxel and pillar detectors' forward reads.
"""
from __future__ import annotations

import numpy as np

from .sparse_plan import build_sparse_plan


def sample_points(points, num_points: int, rng: np.random.RandomState):
    """The near/far fixed-N rule of one (N, C) scan (JAX's
    ``sample_points``): with more than ``num_points`` points, keep every
    point at 40 m or farther (its norm over x, y, z) and draw the rest from
    the near ones without replacement, or draw all of them when the far
    ones alone reach ``num_points``; with fewer, keep every point and
    draw the missing ones with replacement; then shuffle. The draws come
    from ``rng`` in JAX's order, so ``RandomState(s)`` here draws what
    JAX draws after ``np.random.seed(s)``. ``num_points`` -1 keeps the
    scan."""
    if num_points == -1:
        return points
    if num_points < len(points):
        near_mask = np.linalg.norm(points[:, 0:3], axis=1) < 40.0
        far_idxs = np.where(~near_mask)[0]
        near_idxs = np.where(near_mask)[0]
        if num_points > len(far_idxs):
            near_choice = rng.choice(near_idxs, num_points - len(far_idxs),
                                     replace=False)
            choice = np.concatenate((near_choice, far_idxs)) \
                if len(far_idxs) > 0 else near_choice
        else:
            choice = rng.choice(np.arange(len(points), dtype=np.int64),
                                num_points, replace=False)
        rng.shuffle(choice)
    else:
        choice = np.arange(0, len(points), dtype=np.int64)
        if num_points > len(points):
            extra = rng.choice(choice, num_points - len(points),
                               replace=True) if len(points) > 0 \
                else np.zeros(num_points, dtype=np.int64)
            choice = np.concatenate((choice, extra))
        rng.shuffle(choice)
    return points[choice] if len(points) > 0 \
        else np.zeros((num_points, points.shape[1]), dtype=points.dtype)


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


def transform_points_to_voxels_placeholder(point_cloud_range, voxel_size):
    """The grid bookkeeping of JAX's placeholder step, which voxelizes
    nothing (the dynamic pillar VFE does it on the device): the (nx, ny,
    nz) grid of ``voxel_size`` over the range, int64."""
    pcr = np.asarray(point_cloud_range, dtype=np.float32)
    return np.round((pcr[3:6] - pcr[0:3]) /
                    np.asarray(voxel_size)).astype(np.int64)


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


def voxel_batch(points, data_cfg, mode: str = 'test', gt_boxes=None,
                rng: np.random.RandomState | None = None):
    """(B, N, C) scans -> the collated numpy batch of a voxel or pillar
    detector, by the steps of ``data_cfg``'s ``DATA_PROCESSOR`` (``mode``
    picks 'train' or 'test' limits): ``sample_points`` where the config
    names it (its draws from ``rng``, which it then needs), then, stacked
    over the frames, the voxels of ``transform_points_to_voxels`` ('voxels',
    'voxel_coords', 'voxel_num_points', 'voxel_valid') and, where the
    config names ``build_sparse_conv_plan`` (the sparse backbones), the
    plan's tables. With ``transform_points_to_voxels_placeholder`` (the
    dynamic pillar VFE voxelizes on the device) the batch holds the
    points alone. 'points' holds the (sampled) scans. Range masking and
    shuffling are not applied: points outside the range get no voxel and
    stay in 'points' (the synthetic scans lie inside it). With
    ``gt_boxes``, one (T_b, W) array a frame, W = 8 ([x, y, z, dx, dy,
    dz, heading, class]) or 10 (nuScenes: the velocity (vx, vy) before the
    class) for all frames, the batch also holds 'gt_boxes' (B, max T_b,
    W) float32, shorter frames padded with zero rows."""
    steps = {p['NAME']: p for p in data_cfg.DATA_PROCESSOR}
    pcr = data_cfg.POINT_CLOUD_RANGE
    if 'sample_points' in steps:
        if rng is None:
            raise ValueError('the config samples points: pass rng, a '
                             'numpy RandomState')
        num = _by_mode(steps['sample_points']['NUM_POINTS'], mode)
        points = np.stack([sample_points(np.asarray(scan), num, rng)
                           for scan in points])
    batch = {}
    vox = steps.get('transform_points_to_voxels', None)
    if vox is not None:
        plan_cfg = steps.get('build_sparse_conv_plan', None)
        frames = []
        for scan in points:
            frame = transform_points_to_voxels(
                scan, pcr, vox['VOXEL_SIZE'],
                _by_mode(vox['MAX_NUMBER_OF_VOXELS'], mode),
                int(vox['MAX_POINTS_PER_VOXEL']))
            if plan_cfg is not None:
                frame.update(build_sparse_conv_plan(
                    frame['voxel_coords'], frame['voxel_valid'], pcr,
                    vox['VOXEL_SIZE'],
                    plan_cfg.get('MAX_VOXELS_PER_LEVEL', None)))
            frames.append(frame)
        batch = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    batch['points'] = np.asarray(points, dtype=np.float32)
    if gt_boxes is not None:
        if len(gt_boxes) != len(points):
            raise ValueError(f'{len(gt_boxes)} gt box arrays for '
                             f'{len(points)} frames')
        widths = {np.shape(g)[-1] for g in gt_boxes}
        if len(widths) != 1 or not widths <= {8, 10}:
            raise ValueError(f'gt box widths {sorted(widths)}: the frames '
                             'share one width, 8 or 10')
        t = max(len(g) for g in gt_boxes)
        gt = np.zeros((len(points), t, widths.pop()), dtype=np.float32)
        for b, g in enumerate(gt_boxes):
            gt[b, :len(g)] = g
        batch['gt_boxes'] = gt
    return batch
