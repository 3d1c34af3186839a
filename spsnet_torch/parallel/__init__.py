"""Data parallel training over ``torch.distributed`` (``parallel.mesh``)."""
from .mesh import (all_gather_host, draw_rows, gather_rows, global_count,
                   global_mean, global_sum, host_local_batch_size,
                   init_distributed, local_rows, new_step_group, rank,
                   step_group, step_rank, step_world, sum_over_ranks,
                   sum_terms, world, world_group)
