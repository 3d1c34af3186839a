"""The processor steps the voxel and pillar detectors need: point
sampling, voxelization and the sparse-conv plan."""
from .voxelize import (build_sparse_conv_plan, sample_points,
                       sparse_grid_zyx, transform_points_to_voxels,
                       transform_points_to_voxels_placeholder,
                       uses_up_tables, voxel_batch)
