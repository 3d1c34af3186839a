"""The two-stage voxel configs (and SECOND) of ``tools/cfgs`` beside the
CenterPoint ones in the port against the JAX package on the CPU, at full
model width: the Waymo PV-RCNN with a CenterHead RPN, Waymo's
``pv_rcnn.yaml`` and ``second.yaml`` and
``kitti_models/pointrcnn_iou.yaml``. Cuts, tolerances and the shared
helper (``_both``) as ``tests/test_torch_voxel_configs.py`` states them.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.roi_heads import roi_utils as jax_roi
from spsnet_torch import zoo
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.roi_heads import roi_utils
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import load_flax
from tests.test_torch_centerpoint import _close
from tests.test_torch_centerpoint import \
    jax_centerpoint_builds  # noqa: F401  (the module's autouse fixture)
from tests.test_torch_pointrcnn_train import (JAX_ATOL, _jax_draws,
                                              _targets_inputs)
from tests.test_torch_voxel_configs import (B, WAYMO_CROP, _both,
                                            _hold_head, _t)


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
