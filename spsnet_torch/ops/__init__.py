"""Point-cloud ops. ``farthest_point_sample`` and ``ball_query(_multi)``
launch hand-written CUDA kernels on CUDA tensors and run their plain
PyTorch versions on CPU tensors; the rest is plain PyTorch."""
from .boxes import boxes_iou_bev_fast, nms_bev
from .grouping import (ball_query, ball_query_multi, gather_points,
                       group_all, group_points, masked_pool, query_and_group)
from .sampling import calc_square_dist, farthest_point_sample
