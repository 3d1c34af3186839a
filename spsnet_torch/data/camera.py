"""Synthetic KITTI-shaped camera frames for CaDDN, made from a numpy seed.

A frame is the JAX package's camera batch entry (``spsnet_tpu/models/vfe/
image_vfe.py``, ``spsnet_tpu/models/detectors/caddn.py``): a (H, W, 3)
float32 image, the (4, 4) lidar-to-camera and (3, 4) camera-to-image
matrices, the full-resolution (H, W) depth map of a lidar scan (zero
where no point lands), the (T, 4) 2D boxes of the gt and the (T, 8) gt
boxes. The scan and its gt are ``utils.synthetic.synthetic_scene``'s over
the detector's range; the calibration is the KITTI fixture of the JAX
package's ``tests/test_kitti_end2end.py`` (P2 ``700 0 600 45 / 0 700 180 0
/ 0 0 1 0.005``, Tr_velo_to_cam ``0 -1 0 0 / 0 0 -1 0 / 1 0 0 0``, R0
identity), composed as ``spsnet_tpu/data/kitti/kitti_utils.py:126-133``
composes it.
"""
from __future__ import annotations

import numpy as np

from ..utils.synthetic import synthetic_scene

IMAGE_SHAPE = (375, 1242)
CADDN_RANGE = (2.0, -30.08, -3.0, 46.8, 30.08, 1.0)
P2 = np.array([[700, 0, 600, 45], [0, 700, 180, 0], [0, 0, 1, 0.005]],
              np.float32)
TR_VELO_TO_CAM = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]],
                          np.float32)
R0_RECT = np.eye(3, dtype=np.float32)


def calib_matrices(p2=P2, v2c=TR_VELO_TO_CAM, r0=R0_RECT):
    """(trans_lidar_to_cam (4, 4), trans_cam_to_img (3, 4)) float32: R0
    and Tr_velo_to_cam made homogeneous and multiplied, and P2."""
    bottom = np.array([[0, 0, 0, 1]], np.float32)
    V2C = np.vstack((v2c, bottom))
    R0 = np.vstack((np.hstack((r0, np.zeros((3, 1), np.float32))), bottom))
    return (R0 @ V2C).astype(np.float32), np.asarray(p2, np.float32)


def project(points, l2c, c2i):
    """(N, 3) lidar points -> (N, 2) pixel coordinates (u, v) and (N,)
    depths in the camera (z_img - P[2, 3], as the frustum grid takes
    them); float64."""
    hom = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    cam = hom @ np.asarray(l2c, np.float64).T
    img = np.concatenate([cam[:, :3], np.ones((len(points), 1))],
                         axis=1) @ np.asarray(c2i, np.float64).T
    with np.errstate(divide='ignore', invalid='ignore'):
        uv = img[:, :2] / img[:, 2:3]
    return uv, img[:, 2] - c2i[2, 3]


def depth_map(points, l2c, c2i, image_shape):
    """(H, W) float32 depth of the points in front of the camera at pixel
    (floor v, floor u), the nearest where several land, 0 where none."""
    H, W = image_shape
    uv, depth = project(points, l2c, c2i)
    u, v = np.floor(uv[:, 0]), np.floor(uv[:, 1])
    ok = (depth > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    out = np.full(H * W, np.inf)
    np.minimum.at(out, (v[ok] * W + u[ok]).astype(np.int64), depth[ok])
    out[np.isinf(out)] = 0
    return out.reshape(H, W).astype(np.float32)


def box_corners(boxes):
    """(T, 7+) boxes [x, y, z, dx, dy, dz, heading] -> (T, 8, 3) corners."""
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float64) / 2
    local = signs[None] * boxes[:, None, 3:6]
    c, s = np.cos(boxes[:, 6:7]), np.sin(boxes[:, 6:7])
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return np.stack([x, y, local[..., 2]], -1) + boxes[:, None, :3]


def boxes2d(gt_boxes, l2c, c2i, image_shape):
    """(T, 4) float32 [x1, y1, x2, y2]: the bounds of each gt box's
    projected corners clipped to the image; zero for a padding row (class
    0), a box with a corner behind the camera or one outside the image."""
    H, W = image_shape
    out = np.zeros((len(gt_boxes), 4), np.float32)
    if not len(gt_boxes):
        return out
    corners = box_corners(np.asarray(gt_boxes, np.float64))
    uv, depth = project(corners.reshape(-1, 3), l2c, c2i)
    uv, depth = uv.reshape(-1, 8, 2), depth.reshape(-1, 8)
    lo = np.clip(uv.min(1), 0, [W, H])
    hi = np.clip(uv.max(1), 0, [W, H])
    ok = (gt_boxes[:, 7] > 0) & (depth > 0).all(1) & (hi > lo).all(1)
    out[ok] = np.concatenate([lo, hi], 1)[ok]
    return out


def synthetic_camera_frame(rng, image_shape=IMAGE_SHAPE,
                           pc_range=CADDN_RANGE, p2=P2, n_points=16384,
                           n_boxes=12):
    """One camera frame (a dict of float32 arrays, see the module's
    docstring): a uniform-noise image, the depth map of a synthetic scan
    over ``pc_range``, its ``n_boxes`` clusters as gt of classes 1, 2, 3 in
    turn and their 2D boxes."""
    points, gt = synthetic_scene(rng, n_points, pc_range,
                                 n_clusters=n_boxes)
    gt[:, 7] = 1 + np.arange(n_boxes) % 3
    l2c, c2i = calib_matrices(p2)
    image = rng.uniform(0, 1, tuple(image_shape) + (3,)).astype(np.float32)
    return {'images': image, 'trans_lidar_to_cam': l2c,
            'trans_cam_to_img': c2i,
            'depth_maps': depth_map(points[:, :3], l2c, c2i, image_shape),
            'gt_boxes2d': boxes2d(gt, l2c, c2i, image_shape),
            'gt_boxes': gt}


def synthetic_camera_batch(seed, batch_size, **kwargs):
    """``batch_size`` frames of ``synthetic_camera_frame`` from one seed,
    stacked: {'images': (B, H, W, 3), ...}."""
    rng = np.random.default_rng(seed)
    frames = [synthetic_camera_frame(rng, **kwargs)
              for _ in range(batch_size)]
    return {k: np.stack([f[k] for f in frames]) for k in frames[0]}
