"""The voxel configs of ``tools/cfgs`` that Voxel R-CNN's and CenterPoint's
modules made buildable, and the three that built untested, in the port
against the JAX package on the CPU, at full model width.

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
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.roi_heads import roi_utils as jax_roi
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector, build_detector_from_cfg
from spsnet_torch.models.detectors.detector3d import (head_detections,
                                                      post_processing)
from spsnet_torch.models.roi_heads import roi_utils
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_centerpoint import (_close, _cp_variables,
                                          hold_detections)
from tests.test_torch_centerpoint import \
    jax_centerpoint_builds  # noqa: F401  (the module's autouse fixture)
from tests.test_torch_pointrcnn_train import (JAX_ATOL, _jax_draws,
                                              _targets_inputs)

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


def test_waymo_pv_rcnn_with_a_center_head_serves_as_jax():
    """pv_rcnn_with_centerhead_rpn.yaml at full width: the CenterHead RPN's
    detections are the proposals, the VSA's keypoints (FPS) and features,
    the RoIs and their refinement and the final NMS match JAX's. Cuts:
    WAYMO_CROP, 1500 voxels a level, scans of 3000 points, 256 keypoints,
    64 / 16 proposals before / after the RoI head's test NMS."""
    def edit(model_cfg):
        model_cfg.PFE.NUM_KEYPOINTS = 256
        nms = model_cfg.ROI_HEAD.NMS_CONFIG.TEST
        nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 64, 16
    cfg, jm, model, out, jout = _both(
        'tools/cfgs/waymo_models/pv_rcnn_with_centerhead_rpn.yaml',
        WAYMO_CROP, 1500, 54, 3000, edit)
    _hold_head(out, jout)
    np.testing.assert_array_equal(out['point_coords'].numpy(),
                                  jout['point_coords'])
    _close(out['point_features'], jout['point_features'], 'point_features')
    _close(out['rois'], jout['roi_head_ret']['rois'], 'rois')
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jout['batch_roi_labels'])
    for key in ('rcnn_cls', 'rcnn_reg'):
        _close(out['roi_head_ret'][key], jout['roi_head_ret'][key], key)
    post = cfg.MODEL.POST_PROCESSING
    dets = post_processing(out, post)
    jdets = jax_post_processing(jout, StaticConfig(post))
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    _close(dets['boxes'], jdets['boxes'], 'boxes')
    assert out['has_class_labels'] is True


# ------------------------------------------ built, untested until now

@pytest.mark.parametrize('name', ['pv_rcnn', 'second'])
def test_waymo_anchor_configs_serve_as_jax(name):
    """waymo_models/{pv_rcnn,second}.yaml at full width: 5 point channels,
    the three Waymo anchor classes on the (2, 32, 32) grid of the crop.
    The anchor head's predictions and, for SECOND, the final NMS; for
    PV-RCNN the keypoints, their features, the RoIs and refinement and the
    final NMS. Cuts: WAYMO_CROP, 1500 voxels a level, scans of 3000
    points, 256 keypoints and 64 / 16 proposals before / after the RoI
    head's test NMS."""
    def edit(model_cfg):
        if name == 'pv_rcnn':
            model_cfg.PFE.NUM_KEYPOINTS = 256
            nms = model_cfg.ROI_HEAD.NMS_CONFIG.TEST
            nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 64, 16
    cfg, jm, model, out, jout = _both(
        f'tools/cfgs/waymo_models/{name}.yaml', WAYMO_CROP, 1500, 55,
        3000, edit)
    ret, jret = out['anchor_head_ret'], jout['anchor_head_ret']
    for key in ('cls_preds', 'box_preds', 'dir_preds'):
        _close(ret[key], jret[key], key)
    assert ret['cls_preds'].shape[-1] == 3
    if name == 'pv_rcnn':
        np.testing.assert_array_equal(out['point_coords'].numpy(),
                                      jout['point_coords'])
        _close(out['point_features'], jout['point_features'],
               'point_features')
        _close(out['rois'], jout['roi_head_ret']['rois'], 'rois')
        for key in ('rcnn_cls', 'rcnn_reg'):
            _close(out['roi_head_ret'][key], jout['roi_head_ret'][key], key)
    post = cfg.MODEL.POST_PROCESSING
    dets = post_processing(out, post)
    jdets = jax_post_processing(jout, StaticConfig(post))
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    _close(dets['boxes'], jdets['boxes'], 'boxes')


def test_pointrcnn_iou_serves_as_jax():
    """kitti_models/pointrcnn_iou.yaml at full width, the flax init from a
    fixed key: both stages' detections through ``post_processing`` match
    JAX's (the RoIs' labels route, its IOU_FC left unbuilt by both
    packages). Cuts: the backbone's NPOINTS by 8 (512 / 128 / 32 / 8: its
    last layer groups 32 of the 32 points before it), scenes of 2048
    points in KITTI's range."""
    path = 'tools/cfgs/kitti_models/pointrcnn_iou.yaml'
    cfgs = [z.load_yaml_cfg(path) for z in (jax_zoo, zoo)]
    for cfg in cfgs:
        sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
        sa.NPOINTS = [n // 8 for n in sa.NPOINTS]
    jcfg, cfg = cfgs
    scans = synthetic_scan_batch(56, B, 2048)
    jm = jax_build_detector(jcfg.MODEL, num_class=3)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, p: jm.init(k, {'points': p}, train=False))(
            jax.random.PRNGKey(56), scans)))
    post = StaticConfig(jcfg.MODEL.POST_PROCESSING)
    jdets = jax.jit(lambda v, p: jax_post_processing(
        jm.apply(v, {'points': p}, train=False), post))(variables, scans)
    model = load_flax(build_detector(cfg.MODEL, 3, device='cpu'), variables)
    with torch.no_grad():
        dets = post_processing(model({'points': _t(scans)}),
                               cfg.MODEL.POST_PROCESSING)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    _close(dets['boxes'], jdets['boxes'], 'boxes')
    _close(dets['scores'], jdets['scores'], 'scores')
    assert int(dets['count'].min()) > 0


def test_pointrcnn_iou_roi_targets_match_jax():
    """pointrcnn_iou.yaml's RoI targets: CLS_SCORE_TYPE roi_iou between
    CLS_BG_THRESH 0.25 and CLS_FG_THRESH 0.7, with the JAX package's
    draws; sampled RoIs, labels and regression masks identical, the
    IoU-graded labels within JAX_ATOL / (0.7 - 0.25) (the packages' exact
    IoUs lie JAX_ATOL apart, tests/test_torch_pointrcnn_train.py) and
    some of them strictly between 0 and 1. Cut: 24 RoIs a frame
    (ROI_PER_IMAGE 128)."""
    cfg = copy.deepcopy(zoo.load_yaml_cfg(
        'tools/cfgs/kitti_models/pointrcnn_iou.yaml').MODEL.ROI_HEAD
        .TARGET_CONFIG)
    assert (cfg.CLS_SCORE_TYPE, cfg.CLS_FG_THRESH, cfg.CLS_BG_THRESH) == \
        ('roi_iou', 0.7, 0.25)
    cfg.ROI_PER_IMAGE = 24
    rois, labels, valid, gt = _targets_inputs(13)
    scores = np.random.default_rng(14).uniform(size=labels.shape).astype(
        np.float32)
    key = jax.random.PRNGKey(15)
    want = jax.jit(lambda k, *a: jax_roi.proposal_target_layer(k, *a, cfg))(
        key, rois, scores, labels.astype(np.int32), valid, gt)
    got = roi_utils.proposal_target_layer(
        _jax_draws(key, B, rois.shape[1], 24), _t(rois), _t(scores),
        _t(labels), _t(valid), _t(gt), cfg)
    for field in ('rois', 'roi_labels', 'gt_of_rois_src', 'reg_valid_mask'):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.rcnn_cls_labels.numpy(),
                               np.asarray(want.rcnn_cls_labels), rtol=0,
                               atol=JAX_ATOL / (0.7 - 0.25))
    graded = got.rcnn_cls_labels
    assert ((graded > 0) & (graded < 1)).any()
