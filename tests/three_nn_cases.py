"""Inputs where the three-NN kernel's scan rules (the padded suffix, the
culled sub-tiles of 32 rows) could go wrong first, made with numpy from a
fixed seed: (unknown (B, n, 3), known (B, m, 3)) float32 arrays.

- suffix0 .. suffix3, suffix_m3: the last 0, 1, 2, 3 or m - 3 rows padded
  at 1e6 (a sparse level's padding), the scan keeping the run's first
  three;
- all_equal: every row the same point;
- run_in_middle: a run of equal rows that is not at the end;
- voxel_order: voxel centres in z-major key order with the rest padded, as
  a sparse level's rows lie, so that the sub-tiles' boxes are compact and
  the culling acts;
- queries_at_1e6: a third of the queries at 1e6 plus cell offsets (the
  cell centres of invalid keypoints);
- nan_inf: rows and queries with NaN, +inf and -inf coordinates;
- zeros_tiny: +0 and -0 coordinates and coordinates near 1e-20;
- m_off_32: m no multiple of 32.
"""
import numpy as np

CASES = ('suffix0', 'suffix1', 'suffix2', 'suffix3', 'suffix_m3',
         'all_equal', 'run_in_middle', 'voxel_order', 'queries_at_1e6',
         'nan_inf', 'zeros_tiny', 'm_off_32')
FAR = 1e6


def voxel_centres(rng, b, occupied, m, voxel=0.4, extent=(12.0, 12.0, 2.0)):
    """(b, m, 3): the centres of ``occupied`` distinct voxels of a cloud,
    in z-major key order, the other rows at FAR."""
    out = np.full((b, m, 3), FAR, np.float32)
    dims = np.ceil(np.asarray(extent) / voxel).astype(np.int64)
    for k in range(b):
        keys = rng.choice(int(np.prod(dims)), occupied, replace=False)
        keys.sort()
        z, rem = np.divmod(keys, dims[0] * dims[1])
        y, x = np.divmod(rem, dims[0])
        out[k, :occupied] = (np.stack([x, y, z], -1) * voxel + voxel / 2
                             - np.asarray(extent) / 2 * [1, 1, 0])
    return out


def three_nn_case(case, b=2, n=300, m=1000, seed=0):
    rng = np.random.default_rng(seed + CASES.index(case))
    known = (rng.normal(size=(b, m, 3)) * 5).astype(np.float32)
    unknown = None
    if case == 'm_off_32':
        known = known[:, :m - m % 32 - 15]
    elif case.startswith('suffix'):
        pad = m - 3 if case == 'suffix_m3' else int(case[-1])
        if pad:
            known[:, -pad:] = FAR
    elif case == 'all_equal':
        known[:] = known[:, :1]
    elif case == 'run_in_middle':
        known[:, m // 3:2 * m // 3] = known[:, m // 3:m // 3 + 1]
    elif case in ('voxel_order', 'queries_at_1e6'):
        known = voxel_centres(rng, b, m // 3, m)
        unknown = known[:, :n] + rng.normal(size=(b, n, 3)).astype(
            np.float32) * 0.5
        if case == 'queries_at_1e6':
            unknown[:, ::3] = FAR + rng.uniform(-1.2, 1.2, (b, -(-n // 3),
                                                            3))
    elif case == 'nan_inf':
        for row, col, v in ((5, 0, np.nan), (17, 1, np.inf),
                            (40, 2, -np.inf), (41, 0, np.nan),
                            (m - 1, 2, np.inf)):
            known[:, row, col] = v
        known[:, 60] = np.nan
    elif case == 'zeros_tiny':
        known[:, ::4] = 0.0
        known[:, 1::4] = -0.0
        known[:, 2::4] *= 1e-20
    if unknown is None:
        unknown = known[:, :n] + rng.normal(size=(b, n, 3)).astype(
            np.float32) * 0.3
    if case == 'nan_inf':
        unknown[:, 3] = np.nan
        unknown[:, 8, 1] = np.inf
    if case == 'zeros_tiny':
        unknown[:, ::2] *= 1e-20
        unknown[:, 1] = 0.0
        unknown[:, 3] = -0.0
    return (np.ascontiguousarray(unknown, np.float32),
            np.ascontiguousarray(known, np.float32))
