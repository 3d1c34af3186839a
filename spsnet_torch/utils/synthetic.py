"""Structured synthetic LiDAR scans for tests and the chip smoke run.

A KITTI-like scan inside the standard crop range: a ground plane with
range-attenuated density, object-sized clusters and sparse walls, made
deterministically from a seed with numpy alone. The same seed gives the same
scan as the JAX package's generator, so both packages see one input.
"""
from __future__ import annotations

import numpy as np

KITTI_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)


def synthetic_scan(rng, n_points=16384, pc_range=KITTI_RANGE,
                   ground_frac=0.62, cluster_frac=0.30, n_clusters=24):
    """(n_points, 4) float32 scan ``[x, y, z, intensity]``."""
    x0, y0, z0, x1, y1, z1 = pc_range
    n_ground = int(n_points * ground_frac)
    n_cluster = int(n_points * cluster_frac)
    n_wall = n_points - n_ground - n_cluster

    # ground: azimuth uniform over the frustum, range with 1/r density
    r_min, r_max = 2.0, float(x1)
    u = rng.uniform(0, 1, n_ground)
    r = r_min * (r_max / r_min) ** u
    az = rng.uniform(np.arctan2(y0, x1), np.arctan2(y1, x1), n_ground)
    gx = np.clip(r * np.cos(az), x0 + 1e-3, x1 - 1e-3)
    gy = np.clip(r * np.sin(az), y0 + 1e-3, y1 - 1e-3)
    gz = -1.65 + rng.normal(0, 0.03, n_ground)
    ground = np.stack([gx, gy, gz], axis=1)

    # object clusters standing on the ground plane
    ctr_r = rng.uniform(5.0, 0.85 * r_max, n_clusters)
    ctr_az = rng.uniform(np.arctan2(y0, x1) * 0.9,
                         np.arctan2(y1, x1) * 0.9, n_clusters)
    cx = ctr_r * np.cos(ctr_az)
    cy = ctr_r * np.sin(ctr_az)
    sizes = rng.uniform([1.6, 0.5, 0.5], [4.2, 1.8, 1.7], (n_clusters, 3))
    counts = rng.multinomial(n_cluster, np.ones(n_clusters) / n_clusters)
    pieces = []
    for i in range(n_clusters):
        local = rng.normal(0, 0.25, (counts[i], 3)) * sizes[i]
        pieces.append(local + [cx[i], cy[i], -1.65 + sizes[i, 2] / 2])
    clusters = np.concatenate(pieces) if pieces else np.zeros((0, 3))

    # sparse walls at the side extremes
    wx = rng.uniform(x0, x1, n_wall)
    wy = np.where(rng.uniform(size=n_wall) < 0.5,
                  rng.uniform(y0, y0 * 0.8, n_wall),
                  rng.uniform(y1 * 0.8, y1, n_wall))
    wz = rng.uniform(-1.5, z1, n_wall)
    walls = np.stack([wx, wy, wz], axis=1)

    xyz = np.concatenate([ground, clusters, walls]).astype(np.float32)
    np.clip(xyz[:, 0], x0, x1 - 1e-3, out=xyz[:, 0])
    np.clip(xyz[:, 1], y0, y1 - 1e-3, out=xyz[:, 1])
    np.clip(xyz[:, 2], z0, z1 - 1e-3, out=xyz[:, 2])
    rng.shuffle(xyz)
    intensity = rng.uniform(0, 1, (n_points, 1)).astype(np.float32)
    return np.concatenate([xyz, intensity], axis=1)


def synthetic_scan_batch(seed, batch_size, n_points=16384,
                         pc_range=KITTI_RANGE):
    """(batch_size, n_points, 4) float32 scans from one seed."""
    rng = np.random.default_rng(seed)
    return np.stack([synthetic_scan(rng, n_points, pc_range)
                     for _ in range(batch_size)])
