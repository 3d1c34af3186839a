"""Rotated BEV IoU and greedy NMS, batched over frames.

Port of ``spsnet_tpu/ops/boxes.py:30-41,107-165,248-310`` (the rebuild of
``iou3d_nms_kernel.cu``'s ``nms_gpu``): exact rotated-rectangle overlap by
Liang-Barsky clipping of each quad's edges against the other's half-planes,
then the canonical greedy suppression over score-sorted boxes. Plain
PyTorch on every device; every function takes leading batch dims.
"""
from __future__ import annotations

import torch

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
    return torch.where(ok, contrib, 0.0).sum(dim=-1)


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


def topk_desc(scores, k: int):
    """(values, indices) of the ``k`` largest along the last dim, in
    descending order, the lowest index first among equal values (the
    ``jax.lax.top_k`` order; ``torch.topk`` promises no tie order)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return scores.gather(-1, order), order


def _greedy_suppress(iou, valid, thresh: float):
    """Greedy NMS over boxes sorted by descending score, batched over
    frames: (B, K, K) IoU, (B, K) valid -> (B, K) keep mask."""
    K = iou.shape[-1]
    over = torch.triu(iou > thresh, diagonal=1)  # overlap with a later box
    suppressed = torch.zeros_like(valid)
    for i in range(K):
        kept_i = valid[:, i] & ~suppressed[:, i]
        suppressed |= over[:, i] & kept_i[:, None]
    return valid & ~suppressed


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
    sorted_boxes = boxes.gather(1, order[..., None].expand(-1, -1, 7))
    keep = _greedy_suppress(boxes_iou_bev_fast(sorted_boxes, sorted_boxes),
                            top_scores > -torch.inf, thresh)

    # first `post` kept boxes in score order; column `post` collects the rest
    post = min(post_maxsize, pre)
    rank = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep & (rank < post), rank, post)
    keep_idx = torch.full((B, post + 1), -1, dtype=torch.int64,
                          device=boxes.device)
    keep_idx.scatter_(1, slot, order)
    num = keep.sum(dim=1).clamp(max=post)
    return keep_idx[:, :post], num
