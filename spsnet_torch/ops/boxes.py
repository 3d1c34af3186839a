"""Rotated BEV and 3D IoU, greedy NMS and points in boxes, batched over
frames.

Port of ``spsnet_tpu/ops/boxes.py`` (the rebuild of ``iou3d_nms_kernel.cu``'s
``boxes_overlap_bev``, ``boxes_iou3d`` and ``nms_gpu`` and of
``roiaware_pool3d_kernel.cu``'s ``points_in_boxes``): the exact overlap of
two rotated rectangles from their sorted intersection vertices (RoI
targets), the sort-free one by Liang-Barsky clipping of each quad's edges
against the other's half-planes (NMS), and the canonical greedy suppression
over score-sorted boxes. Plain PyTorch on every device; every function
takes leading batch dims.
"""
from __future__ import annotations

import torch

from ..utils import box_utils

_EPS = 1e-8


def _bev_corners(boxes):
    """(..., 7) -> (..., 4, 2) BEV corners in CCW order."""
    template = boxes.new_tensor([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5],
                                 [0.5, -0.5]])
    local = template * boxes[..., None, 3:5]
    cosa = torch.cos(boxes[..., 6:7])
    sina = torch.sin(boxes[..., 6:7])
    x = local[..., 0] * cosa - local[..., 1] * sina
    y = local[..., 0] * sina + local[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes[..., None, 0:2]


def _directed_contrib(ca, cb):
    """Sum of cross(start, end) over the edges of each quad of ``ca``
    clipped to each quad of ``cb``: (..., N, 4, 2) x (..., M, 4, 2) ->
    (..., N, M)."""
    # edges of A: p -> p + d                        (..., N, 1, 4A, 1, 2)
    p = ca[..., :, None, :, None, :]
    d = (torch.roll(ca, -1, dims=-2) - ca)[..., :, None, :, None, :]
    # half-planes of B: left of e1 -> e1 + db       (..., 1, M, 1, 4B, 2)
    e1 = cb[..., None, :, None, :, :]
    db = (torch.roll(cb, -1, dims=-2) - cb)[..., None, :, None, :, :]

    rel = p - e1
    f_p = db[..., 0] * rel[..., 1] - db[..., 1] * rel[..., 0]
    df = db[..., 0] * d[..., 1] - db[..., 1] * d[..., 0]
    safe_df = torch.where(df.abs() > _EPS, df, 1.0)
    t_cross = -f_p / safe_df
    lo = torch.where(df > _EPS, t_cross, 0.0)
    hi = torch.where(df < -_EPS, t_cross, 1.0)
    dead = (df.abs() <= _EPS) & (f_p < 0)  # parallel and outside
    lo = torch.where(dead, 1.0, lo)
    hi = torch.where(dead, 0.0, hi)
    t0 = lo.amax(dim=-1).clamp(0.0, 1.0)           # (..., N, M, 4A)
    t1 = hi.amin(dim=-1).clamp(0.0, 1.0)
    ok = t1 > t0
    p_ = p[..., 0, :]
    d_ = d[..., 0, :]
    s0 = p_ + t0[..., None] * d_
    s1 = p_ + t1[..., None] * d_
    contrib = s0[..., 0] * s1[..., 1] - s1[..., 0] * s0[..., 1]
    c = torch.where(ok, contrib, 0.0)
    # summed in edge order, whatever the leading shape, on every device
    return ((c[..., 0] + c[..., 1]) + c[..., 2]) + c[..., 3]


def _pairwise_overlap_lb(corners_a, corners_b):
    """Overlap areas of CCW quads by boundary integration:
    (..., N, 4, 2) x (..., M, 4, 2) -> (..., N, M)."""
    total = _directed_contrib(corners_a, corners_b) + \
        _directed_contrib(corners_b, corners_a).transpose(-1, -2)
    return 0.5 * total.abs()


def boxes_iou_bev_fast(boxes_a, boxes_b):
    """Rotated BEV IoU, (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    overlap = _pairwise_overlap_lb(_bev_corners(boxes_a),
                                   _bev_corners(boxes_b))
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / (area_a + area_b - overlap).clamp(min=1e-6)


def _cross2(u, v):
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def _inside(points, quad):
    """(..., P, 2) points left of every CCW edge of (..., 4, 2) quads ->
    (..., P) bool, with a tolerance of 1e-4 edge lengths, so that shared
    boundaries (identical or touching boxes) count as inside."""
    d = torch.roll(quad, -1, dims=-2) - quad                 # (..., 4, 2)
    edge_len = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    rel = points[..., :, None, :] - quad[..., None, :, :]    # (.., P, 4, 2)
    cross = d[..., None, :, 0] * rel[..., 1] - d[..., None, :, 1] * rel[..., 0]
    return (cross >= -1e-4 * edge_len[..., None, :]).all(dim=-1)


def quad_overlap(ca, cb):
    """Overlap areas of CCW quads, (..., 4, 2) x (..., 4, 2) -> (...),
    broadcast over the leading dims (``spsnet_tpu/ops/boxes.py:44-104``):
    24 candidate vertices (the corners of each quad inside the other and
    the 16 edge crossings), sorted by angle around their centroid (a stable
    sort, as ``jnp.argsort``), then the shoelace sum over the valid fan,
    its terms taken about the centroid. Exact where the sort-free
    ``_pairwise_overlap_lb`` double-counts coincident edges."""
    ca, cb = torch.broadcast_tensors(ca, cb)
    in_ab, in_ba = _inside(ca, cb), _inside(cb, ca)          # (..., 4)
    a1 = ca[..., :, None, :]                                 # (.., 4, 1, 2)
    a2 = torch.roll(ca, -1, dims=-2)[..., :, None, :]
    b1 = cb[..., None, :, :]                                 # (.., 1, 4, 2)
    b2 = torch.roll(cb, -1, dims=-2)[..., None, :, :]
    d1 = _cross2(b2 - b1, a1 - b1)
    d2 = _cross2(b2 - b1, a2 - b1)
    d3 = _cross2(a2 - a1, b1 - a1)
    d4 = _cross2(a2 - a1, b2 - a1)
    hit = (d1 * d2 < 0) & (d3 * d4 < 0)                      # (.., 4, 4)
    denom = d1 - d2
    t = d1 / torch.where(denom.abs() > _EPS, denom, 1.0)
    inter = a1 + t[..., None] * (a2 - a1)                    # (.., 4, 4, 2)
    lead = ca.shape[:-2]
    cand = torch.cat([ca, cb, inter.reshape(*lead, 16, 2)], dim=-2)
    valid = torch.cat([in_ab, in_ba, hit.reshape(*lead, 16)], dim=-1)

    n_valid = valid.sum(dim=-1)
    center = torch.where(valid[..., None], cand, 0.0).sum(dim=-2) / \
        n_valid.clamp(min=1)[..., None]
    ang = torch.atan2(cand[..., 1] - center[..., None, 1],
                      cand[..., 0] - center[..., None, 0])
    key = torch.where(valid, ang, torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    pts = cand.gather(-2, order[..., None].expand(*order.shape, 2))
    sorted_valid = valid.gather(-1, order)
    # invalid tail slots collapse onto the first valid point: the extra
    # edges add no area and the fan still closes
    pts = torch.where(sorted_valid[..., None], pts, pts[..., :1, :])
    # the shoelace terms about the centroid: about the origin (as the JAX
    # package takes them) they cancel, and fp32 keeps only ~1e-3 of a car's
    # area at 70 m
    pts = pts - center[..., None, :]
    nxt = torch.roll(pts, -1, dims=-2)
    area = 0.5 * (pts[..., 0] * nxt[..., 1] - nxt[..., 0] * pts[..., 1]
                  ).sum(dim=-1).abs()
    return torch.where(n_valid >= 3, area, 0.0)


def _overlap(ca, cb, area_a, area_b):
    """``quad_overlap``, 0 where either box has no area: a quad of zero
    size has every point on its edges, so the test above would put the
    other quad inside it (the JAX package's overlap there is the other
    box's area; the reference's CUDA overlap is 0)."""
    return torch.where((area_a > 0) & (area_b > 0), quad_overlap(ca, cb),
                       0.0)


def boxes_overlap_bev(boxes_a, boxes_b):
    """Exact rotated BEV overlap areas, (..., N, 7) x (..., M, 7) ->
    (..., N, M) (``iou3d_nms_utils.py:31-45``)."""
    return _overlap(_bev_corners(boxes_a)[..., :, None, :, :],
                    _bev_corners(boxes_b)[..., None, :, :, :],
                    (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None],
                    (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :])


def boxes_iou_bev(boxes_a, boxes_b):
    """Exact rotated BEV IoU, (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / (area_a + area_b - overlap).clamp(min=1e-6)


def _iou3d(overlap_bev, boxes_a, boxes_b):
    """3D IoU of z-centred boxes from their BEV overlap; ``boxes_a`` and
    ``boxes_b`` broadcast against ``overlap_bev``'s shape."""
    top = torch.minimum(boxes_a[..., 2] + boxes_a[..., 5] / 2,
                        boxes_b[..., 2] + boxes_b[..., 5] / 2)
    bot = torch.maximum(boxes_a[..., 2] - boxes_a[..., 5] / 2,
                        boxes_b[..., 2] - boxes_b[..., 5] / 2)
    overlap_3d = overlap_bev * (top - bot).clamp(min=0)
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return overlap_3d / (vol_a + vol_b - overlap_3d).clamp(min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """3D IoU, (..., N, 7) x (..., M, 7) -> (..., N, M)
    (``iou3d_nms_utils.py:48-81``)."""
    return _iou3d(boxes_overlap_bev(boxes_a, boxes_b),
                  boxes_a[..., :, None, :], boxes_b[..., None, :, :])


def boxes_iou3d_paired(boxes_a, boxes_b):
    """3D IoU of matched pairs, (..., N, 7) x (..., N, 7) -> (..., N): the
    diagonal of ``boxes_iou3d`` at O(N)."""
    overlap = _overlap(_bev_corners(boxes_a), _bev_corners(boxes_b),
                       boxes_a[..., 3] * boxes_a[..., 4],
                       boxes_b[..., 3] * boxes_b[..., 4])
    return _iou3d(overlap, boxes_a, boxes_b)


def topk_desc(scores, k: int):
    """(values, indices) of the ``k`` largest along the last dim, in
    descending order, the lowest index first among equal values (the
    ``jax.lax.top_k`` order; ``torch.topk`` promises no tie order)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return scores.gather(-1, order), order


def _pair_iou(boxes_a, boxes_b, corners_a, corners_b):
    """IoU of P box pairs, (P, 7) boxes and their (P, 4, 2) corners ->
    (P,): each pair's value bit for bit what ``boxes_iou_bev_fast`` gives
    it (the same elementwise ops)."""
    overlap = _pairwise_overlap_lb(corners_a[:, None],
                                   corners_b[:, None])[:, 0, 0]
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    return overlap / (area_a + area_b - overlap).clamp(min=1e-6)


# pairs a block of the dense IoU: one block for IA-SSD's final NMS (8 x
# 256 x 256); larger sets take the candidate pairs
_DENSE_PAIRS = 1 << 22
# pairs a block of the candidate test, and candidate pairs an IoU call:
# fp32 intermediates of ~0.5 GB
_CANDIDATE_BLOCK = 1 << 27
_PAIR_CHUNK = 1 << 21


def dense_overlap_mask(sorted_boxes, thresh: float):
    """(B, K, 7) boxes -> (B, K, K) bool ``iou(i, j) > thresh`` for i < j,
    by ``boxes_iou_bev_fast`` over every pair in blocks of rows of at most
    ``_DENSE_PAIRS`` pairs (every value is elementwise, so the blocks keep
    the bits)."""
    B, K, _ = sorted_boxes.shape
    rows = max(1, _DENSE_PAIRS // (B * K))
    over = torch.empty((B, K, K), dtype=torch.bool,
                       device=sorted_boxes.device)
    for r0 in range(0, K, rows):
        over[:, r0:r0 + rows] = boxes_iou_bev_fast(
            sorted_boxes[:, r0:r0 + rows], sorted_boxes) > thresh
    return over.triu_(1)


def candidate_pairs(sorted_boxes):
    """The pairs (frame, i, j), i < j, of (B, K, 7) boxes whose BEV
    circumscribed circles meet, with a margin far above rounding, in chunks
    of at most ``_PAIR_CHUNK``; a box of zero length or width (no inside
    for the clipping to work with, so its IoU is no overlap measure) pairs
    with every box. One ``nonzero`` (a host sync) per block of
    ``_CANDIDATE_BLOCK`` tested pairs."""
    B, K, _ = sorted_boxes.shape
    xy = sorted_boxes[..., 0:2]
    dx, dy = sorted_boxes[..., 3], sorted_boxes[..., 4]
    radius = torch.where(dx * dy > 0, 0.5 * torch.sqrt(dx * dx + dy * dy),
                         torch.inf)
    cols = torch.arange(K, device=sorted_boxes.device)
    rows = max(1, _CANDIDATE_BLOCK // (B * K))
    for r0 in range(0, K, rows):
        d = xy[:, r0:r0 + rows, None, :] - xy[:, None, :, :]
        reach = radius[:, r0:r0 + rows, None] + radius[:, None, :]
        cand = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) <= \
            reach * reach * 1.001 + 1e-4
        cand &= cols[None, None, :] > cols[None, r0:r0 + rows, None]
        b, i, j = cand.nonzero(as_tuple=True)
        i = i + r0
        for p0 in range(0, b.shape[0], _PAIR_CHUNK):
            yield tuple(t[p0:p0 + _PAIR_CHUNK] for t in (b, i, j))


def overlap_mask(sorted_boxes, thresh: float):
    """(B, K, 7) boxes -> (B, K, K) bool ``iou(i, j) > thresh`` for i < j.

    Sets of at most ``_DENSE_PAIRS`` pairs take ``dense_overlap_mask``.
    Larger ones (PointRCNN's proposal NMS, K = 9000) compute the IoU only
    of the ``candidate_pairs``: a pair further apart cannot overlap, and
    its IoU computes to exactly 0, not above a threshold >= 0. Each
    candidate's IoU is bit for bit its dense value, so the result is
    ``dense_overlap_mask``'s (``chip_smoke.py`` holds the two to each other
    on the card and times both)."""
    B, K, _ = sorted_boxes.shape
    if B * K * K <= _DENSE_PAIRS or thresh < 0:
        return dense_overlap_mask(sorted_boxes, thresh)
    over = torch.zeros((B, K, K), dtype=torch.bool,
                       device=sorted_boxes.device)
    corners = _bev_corners(sorted_boxes)
    for pb, pi, pj in candidate_pairs(sorted_boxes):
        over[pb, pi, pj] = _pair_iou(
            sorted_boxes[pb, pi], sorted_boxes[pb, pj],
            corners[pb, pi], corners[pb, pj]) > thresh
    return over


def _greedy_suppress(over, valid):
    """Greedy NMS over boxes sorted by descending score, batched over
    frames: (B, K, K) ``overlap_mask``, (B, K) valid -> (B, K) keep mask.
    An invalid box starts suppressed, so it suppresses nothing; three
    launches a box on a CUDA tensor."""
    suppressed = ~valid
    for i in range(over.shape[-1]):
        suppressed |= over[:, i] & ~suppressed[:, i:i + 1]
    return ~suppressed


def nms_bev(boxes, scores, thresh: float, pre_maxsize: int = 4096,
            post_maxsize: int = 500, valid=None):
    """Rotated BEV greedy NMS per frame (``iou3d_nms_utils.py:84-99``).

    Args:
        boxes: (B, K, 7); scores: (B, K); valid: optional (B, K) bool.
    Returns:
        keep_idx: (B, post) int64 indices into K in score order, -1 padded,
            post = min(post_maxsize, pre_maxsize, K);
        num_kept: (B,) int64.
    """
    B, K, _ = boxes.shape
    if valid is None:
        valid = torch.ones((B, K), dtype=torch.bool, device=boxes.device)
    pre = min(pre_maxsize, K)
    top_scores, order = topk_desc(torch.where(valid, scores, -torch.inf), pre)
    # the keep list is an index set: no gradient goes through the IoUs
    sorted_boxes = boxes.detach().gather(
        1, order[..., None].expand(-1, -1, 7))
    keep = _greedy_suppress(overlap_mask(sorted_boxes, thresh),
                            top_scores > -torch.inf)

    # first `post` kept boxes in score order; column `post` collects the rest
    post = min(post_maxsize, pre)
    rank = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep & (rank < post), rank, post)
    keep_idx = torch.full((B, post + 1), -1, dtype=torch.int64,
                          device=boxes.device)
    keep_idx.scatter_(1, slot, order)
    num = keep.sum(dim=1).clamp(max=post)
    return keep_idx[:, :post], num


def points_in_boxes(points, boxes):
    """(B, N, 3) points, (B, T, 7) zero-padded boxes -> (B, N) int64: the
    first box containing each point, or -1 (``roiaware_pool3d_kernel.cu:
    313-339``: ``|z| <= dz/2``, xy with a 1e-5 margin). Padding rows
    (dx == 0) never contain a point, even one at the origin."""
    local = box_utils.points_to_box_local(points, boxes[..., :7])
    inside = box_utils.in_canonical_box(local, boxes[..., None, :, 3:6])
    inside = inside & (boxes[..., None, :, 3] > 0)
    first = inside.to(torch.uint8).argmax(dim=-1)  # first True
    return torch.where(inside.any(dim=-1), first, -1)
