"""The CenterPoint voxel configs of ``tools/cfgs`` in the port against the
JAX package on the CPU, at full model width (the two-stage ones and
SECOND: ``tests/test_torch_two_stage_configs.py``, with this file's
helpers).

Each config goes through both packages' ``build_detector_from_cfg`` (the
class names, point channels, voxel size and final grid from its
DATA_CONFIG). The only cuts are of scale and each case lists its own: the
voxel caps (MAX_NUMBER_OF_VOXELS and MAX_VOXELS_PER_LEVEL), small
synthetic scans with the dataset's point channels, a cropped point-cloud
range (a 25.6 m square for Waymo, final grid (2, 32, 32)), and the
two-stage heads' keypoint and proposal counts. Both packages get the port's
host voxels and plan (the JAX processor's bit for bit, held in
``tests/test_torch_pvrcnn.py``; Waymo's and nuScenes' test-time shuffle is
not applied, ROADMAP item G) and the same numpy-filled variables through
the weight bridge (``_cp_variables``). Index outputs must be identical;
floats within RTOL relative plus ATOL times each tensor's largest entry,
as the PV-RCNN tests hold them.
"""
import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector_from_cfg
from spsnet_torch.models.detectors.detector3d import head_detections
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_centerpoint import (_close, _cp_variables,
                                          hold_detections)
from tests.test_torch_centerpoint import \
    jax_centerpoint_builds  # noqa: F401  (the module's autouse fixture)

B = 2
# Waymo's range cropped to a 25.6 m square at its voxel size, nuScenes'
# alike: final grids (2, 32, 32)
WAYMO_CROP = (-12.8, -12.8, -2, 12.8, 12.8, 4)
NUSCENES_CROP = {0.075: (-9.6, -9.6, -5, 9.6, 9.6, 3),
                 0.1: (-12.8, -12.8, -5, 12.8, 12.8, 3)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cut(cfg, crop, n_voxels):
    """The config on ``crop`` with ``n_voxels`` voxels in both modes and a
    level."""
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
    for step in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if step.NAME == 'transform_points_to_voxels':
            step.MAX_NUMBER_OF_VOXELS = {'train': n_voxels,
                                         'test': n_voxels}
        if step.NAME == 'build_sparse_conv_plan':
            step.MAX_VOXELS_PER_LEVEL = n_voxels


def _scans(cfg, seed, n_points):
    """B synthetic scans in the config's (cropped) range with its point
    channels; channels past the fourth (elongation, timestamp) uniform."""
    pcr = tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    channels = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    scans = synthetic_scan_batch(seed, B, n_points, pc_range=pcr)
    extra = np.random.default_rng(seed).uniform(
        0, 1, (B, n_points, channels - 4)).astype(np.float32)
    return np.concatenate([scans, extra], axis=-1)


def _both(path, crop, n_voxels, seed, n_points, edit=None):
    """Both packages' models of ``path`` (cut as stated, then ``edit``)
    with the same variables, every leaf of whose tree maps onto a port key
    and back, and each one's eval forward on the port's voxel batch of B
    scans."""
    cfgs = []
    for z in (jax_zoo, zoo):
        cfg = z.load_yaml_cfg(path)
        _cut(cfg, crop, n_voxels)
        if edit is not None:
            edit(cfg.MODEL)
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    batch = voxel_batch(_scans(cfg, seed, n_points), cfg.DATA_CONFIG)
    jm = jax_build_from_cfg(jcfg)
    variables = _cp_variables(jm, batch)
    model = build_detector_from_cfg(cfg, device='cpu')
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    return cfg, jm, model, out, jout


def _hold_head(out, jout):
    """The CenterHead's maps and detections (``hold_detections``: one NMS
    segment a group), detections in every frame."""
    for g, (pd, jpd) in enumerate(zip(out['center_head_iou_ret'][
            'pred_dicts'], jout['center_head_iou_ret']['pred_dicts'])):
        for k in pd:
            _close(pd[k], np.asarray(jpd[k]).transpose(0, 3, 1, 2),
                   f'head {g} {k}')
    slots = int(out['final_valid'].shape[1]) // len(pd_groups(out))
    hold_detections(out, jout, [slots * k
                                for k in range(1, len(pd_groups(out)))])
    dets = head_detections(out)
    assert int(dets['count'].min()) > 0
    return dets


def pd_groups(out):
    return out['center_head_iou_ret']['pred_dicts']


# config, crop, voxels a level, data seed, points a scan, (groups, point
# channels, box width)
CENTERPOINTS = {
    'waymo_centerpoint': ('waymo_models/centerpoint.yaml', WAYMO_CROP, 1500,
                          50, 3000, (1, 5, 7)),
    'waymo_centerpoint_without_resnet': (
        'waymo_models/centerpoint_without_resnet.yaml', WAYMO_CROP, 1500,
        51, 3000, (1, 5, 7)),
    'nuscenes_voxel0075': (
        'nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml',
        NUSCENES_CROP[0.075], 1500, 52, 3000, (6, 5, 9)),
    'nuscenes_voxel01': (
        'nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml',
        NUSCENES_CROP[0.1], 1500, 53, 3000, (6, 5, 9)),
}


@pytest.mark.parametrize('name', sorted(CENTERPOINTS))
def test_centerpoint_config_serves_as_jax(name):
    """The config's CenterPoint at full width (VoxelResBackBone8x or
    VoxelBackBone8x, the 5-layer BEV backbone, every head group, the
    velocity maps of nuScenes): the BEV features, every group's maps and
    the detections of the upstream CenterHead decode (the top 500 (pixel,
    class) pairs a group, agnostic NMS) match JAX's. Cuts: the crop, 1500
    voxels a level, scans of 3000 points."""
    path, crop, n_voxels, seed, n_points, (groups, channels, width) = \
        CENTERPOINTS[name]
    cfg, jm, model, out, jout = _both(f'tools/cfgs/{path}', crop, n_voxels,
                                      seed, n_points)
    assert len(model.dense_head.heads_list) == groups
    assert model.backbone_3d.conv_input[0].in_features == 27 * channels
    assert type(model.backbone_3d).__name__ == cfg.MODEL.BACKBONE_3D.NAME
    _close(out['spatial_features_2d'],
           np.asarray(jout['spatial_features_2d']).transpose(0, 3, 1, 2),
           'spatial_features_2d')
    dets = _hold_head(out, jout)
    assert dets['boxes'].shape[-1] == width


def test_class_names_reach_the_center_head():
    """``build_detector_from_cfg`` hands CLASS_NAMES to CenterHeadIoU, which
    maps CLASS_NAMES_EACH_HEAD to the JAX package's class ids (nuScenes'
    six groups of ten classes)."""
    path = 'tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml'
    model = build_detector_from_cfg(zoo.load_yaml_cfg(path), device='cpu')
    want = ((0,), (1, 2), (3, 4), (5,), (6, 7), (8, 9))
    assert model.dense_head.class_ids_each_head == want
    jm = jax_build_from_cfg(jax_zoo.load_yaml_cfg(path))
    assert tuple(jm.class_names) == tuple(
        zoo.load_yaml_cfg(path).CLASS_NAMES)
