"""Box geometry (``spsnet_tpu/utils/box_utils.py:24-99``; reference
``pcdet/utils/box_utils.py``): corners, enlargement and the point-in-box
test in each box's canonical frame."""
from __future__ import annotations

import torch

from .common import rotate_points_along_z

# bottom face 0-3 (z = -dz/2), top face 4-7 (z = +dz/2), as the reference
_CORNER_TEMPLATE = (
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
)


def boxes_to_corners_3d(boxes3d):
    """(N, 7) [x, y, z, dx, dy, dz, heading] -> (N, 8, 3) corners."""
    template = boxes3d.new_tensor(_CORNER_TEMPLATE) / 2.0
    corners = boxes3d[:, None, 3:6] * template[None, :, :]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def enlarge_box3d(boxes3d, extra_width=(0.0, 0.0, 0.0)):
    """Add ``extra_width`` to (dx, dy, dz); other fields pass through."""
    out = boxes3d.clone()
    out[..., 3:6] = boxes3d[..., 3:6] + boxes3d.new_tensor(extra_width)
    return out


def enlarge_box3d_for_class(boxes3d, extra_width):
    """Per-class enlargement of (..., 8) boxes whose last column is the
    1-based class (0 = padding, left as it is): ``extra_width`` is
    (num_class, 3), or (3,) for every class. The reference calls this
    function (``IASSD_head.py:261``) without defining it; this is the JAX
    package's reading of it."""
    extra = boxes3d.new_tensor(extra_width)
    if extra.dim() == 1:
        extra = extra[None].expand(16, 3)
    cls_idx = (boxes3d[..., -1].to(torch.int32) - 1).clamp(
        0, extra.shape[0] - 1).long()
    grow = torch.where(boxes3d[..., -1:] > 0, extra[cls_idx], 0.0)
    out = boxes3d.clone()
    out[..., 3:6] = boxes3d[..., 3:6] + grow
    return out


def in_canonical_box(local_xyz, dims, margin=1e-5):
    """Point-in-box test in the box's canonical frame
    (``roiaware_pool3d_kernel.cu:23-37``): ``|z| <= dz/2`` and
    ``|x| < dx/2 + margin``, ``|y| < dy/2 + margin``."""
    zs = local_xyz[..., 2].abs() <= dims[..., 2] / 2.0
    xs = local_xyz[..., 0].abs() < dims[..., 0] / 2.0 + margin
    ys = local_xyz[..., 1].abs() < dims[..., 1] / 2.0 + margin
    return zs & xs & ys


def points_to_box_local(points, boxes):
    """(..., N, 3) points in the canonical frame of each of (..., T, 7)
    boxes -> (..., N, T, 3)."""
    shift = points[..., :, None, :] - boxes[..., None, :, 0:3]
    rz = boxes[..., None, :, 6]
    cosa, sina = torch.cos(-rz), torch.sin(-rz)
    lx = shift[..., 0] * cosa - shift[..., 1] * sina
    ly = shift[..., 0] * sina + shift[..., 1] * cosa
    return torch.stack([lx, ly, shift[..., 2]], dim=-1)
