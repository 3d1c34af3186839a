"""Point-cloud ops. ``farthest_point_sample`` (exact, seeded or chunked),
``farthest_point_sample_with_dist`` (F-FPS), ``ball_query(_multi)`` and
``ball_query_dilated`` launch hand-written CUDA kernels on CUDA tensors and
run their plain PyTorch versions on CPU tensors; the rest is plain
PyTorch."""
from .boxes import (boxes_iou3d, boxes_iou3d_paired, boxes_iou_bev,
                    boxes_iou_bev_fast, boxes_overlap_bev, nms_bev,
                    points_in_boxes)
from .grouping import (ball_query, ball_query_dilated, ball_query_multi,
                       gather_points, group_all, group_points, masked_pool,
                       msg_shared_group, query_and_group, zero_empty_balls)
from .sampling import (FpsChunks, FpsSeeding, calc_square_dist,
                       farthest_point_sample, farthest_point_sample_chunked,
                       farthest_point_sample_with_dist, fps_seeding_active)
