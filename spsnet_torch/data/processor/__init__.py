"""The processor steps the voxel detectors need: voxelization and the
sparse-conv plan."""
from .voxelize import (build_sparse_conv_plan, sparse_grid_zyx,
                       transform_points_to_voxels, voxel_batch)
