"""``voxel_rcnn_car.yaml`` and the Waymo
``voxel_rcnn_with_centerhead_dyn_voxel.yaml`` at full width on cropped
ranges in the port against the JAX package on the CPU (serving, and
``voxel_rcnn_car.yaml``'s train step), each case listing its cuts; the
tolerances and the tiny model's tests are ``tests/test_torch_voxelrcnn
.py``'s.
"""
import numpy as np
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector_from_cfg
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.roi_heads.pointrcnn_head import decode_in_roi_frame
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.trainer import make_train_step
from spsnet_torch.utils.synthetic import (synthetic_scan_batch,
                                          synthetic_scene_batch)
from spsnet_torch.utils.weights import load_flax
from tests.test_torch_pvrcnn import (CROP, _close, _jax_processor, _jax_vars,
                                     _run, _torch_batch)
from tests.test_torch_pvrcnn_train import _gt_near_proposals
from tests.test_torch_voxelrcnn import VOXEL_KEYS, WAYMO_CROP, _t


def _crop(cfg, crop, n_voxels, mode='test'):
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
    step = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
            if p.NAME == 'transform_points_to_voxels'][0]
    step.MAX_NUMBER_OF_VOXELS[mode] = n_voxels
    plan = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
            if p.NAME == 'build_sparse_conv_plan']
    if plan and 'MAX_VOXELS_PER_LEVEL' in plan[0]:
        plan[0].MAX_VOXELS_PER_LEVEL = n_voxels


def _full_width_serving(path, crop, scans, n_voxels, roi_nms):
    """A config at its full widths on ``crop`` with ``n_voxels`` voxels a
    level and the RoI head's test NMS at ``roi_nms`` (pre, post), through
    both packages' ``build_detector_from_cfg`` and the port's host
    voxels."""
    jcfg = jax_zoo.load_yaml_cfg(path)
    cfg = zoo.load_yaml_cfg(path)
    for c in (jcfg, cfg):
        _crop(c, crop, n_voxels)
        nms = c.MODEL.ROI_HEAD.NMS_CONFIG.TEST
        nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = roi_nms
    batch = voxel_batch(scans, cfg.DATA_CONFIG)
    proc = _jax_processor(jcfg.DATA_CONFIG, False)
    want = proc.forward({'points': scans[0].copy()})
    np.testing.assert_array_equal(batch['subm3_table'][0],
                                  want['subm3_table'])
    jm = jax_build_from_cfg(jcfg)
    variables = _jax_vars(jm, batch)
    jax_out, jax_dets = _run(jm, variables, batch)
    model = build_detector_from_cfg(cfg, device='cpu')
    load_flax(model, variables)
    with torch.no_grad():
        out = model(_torch_batch(batch))
    return model, out, cfg.MODEL.POST_PROCESSING, jax_out, jax_dets


def _hold_roi_stage(model, out, post_cfg, jax_out, jax_dets):
    """The RoIs within tolerance of JAX's and their labels identical; the
    RoI head from there on replayed on JAX's RoIs, where the RoIs'
    rounding cannot move a grid point's ball across a voxel center (on
    the port's own RoIs some x_conv4 picks of voxel_rcnn_car.yaml's case
    differ that way): the pooled refinement, the decoded
    boxes and ``post_processing``'s NMS indices, counts and labels
    identical, its boxes and scores within tolerance."""
    jret = jax_out['roi_head_ret']
    _close(out['rois'], jret['rois'], 'rois')
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jax_out['batch_roi_labels'])
    head, rois = model.roi_head, _t(jret['rois'])
    with torch.no_grad():
        shared = head.shared_fc_layer(head.roi_grid_pool(out, rois))
        replay = {'rcnn_cls': head.cls_layers(shared),
                  'rcnn_reg': head.reg_layers(shared)}
        replay['batch_box_preds'] = decode_in_roi_frame(
            head.box_coder, replay['rcnn_reg'], rois)
    for key, got in replay.items():
        _close(got, jret[key], key)
    dets = post_processing(dict(out, batch_cls_preds=replay['rcnn_cls'],
                                batch_box_preds=replay['batch_box_preds']),
                           post_cfg)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jax_dets[key],
                                      err_msg=key)
    _close(dets['boxes'], jax_dets['boxes'], 'boxes')
    _close(dets['scores'], jax_dets['scores'], 'scores')
    assert int(dets['count'].min()) > 0


def test_full_width_voxel_rcnn_car_on_a_cropped_range():
    """voxel_rcnn_car.yaml at its full widths (the 5-layer BEV backbone,
    the pool over x_conv2-4 at 6^3 grid points, 256-wide towers). Cuts:
    tests/test_torch_pvrcnn.py's cropped range (final grid (2, 32, 32)),
    1000 voxels a level, scans of 2048 points, 64 / 16 proposals before /
    after the test NMS."""
    scans = synthetic_scan_batch(9, 2, 2048, pc_range=CROP)
    model, out, post_cfg, jax_out, jax_dets = _full_width_serving(
        'tools/cfgs/kitti_models/voxel_rcnn_car.yaml', CROP, scans, 1000,
        (64, 16))
    assert out['spatial_features'].shape == (2, 256, 32, 32)
    assert out['roi_head_ret']['rcnn_reg'].shape == (2, 16, 7)
    assert model.roi_head.shared_fc_layer[0].in_features == 216 * 96
    _close(out['spatial_features_2d'],
           np.asarray(jax_out['spatial_features_2d']).transpose(0, 3, 1, 2),
           'spatial_features_2d')
    _hold_roi_stage(model, out, post_cfg, jax_out, jax_dets)


def test_full_width_waymo_voxel_rcnn_with_a_center_head():
    """voxel_rcnn_with_centerhead_dyn_voxel.yaml at its full widths: 5
    point channels, the CenterHead RPN (three classes in one group, the
    top 500 of the (pixel, class) pairs, its NMS at 0.7) whose boxes and
    one-hot scores are the proposals, ``has_class_labels`` (three score
    channels). Cuts: Waymo's range cropped to WAYMO_CROP, 1500 voxels a
    level, scans of 3000 points, 64 / 16 proposals before / after the
    RoI head's test NMS."""
    scans = synthetic_scan_batch(10, 2, 3000, pc_range=WAYMO_CROP)
    scans = np.concatenate([scans, np.full_like(scans[..., :1], 0.5)], -1)
    model, out, post_cfg, jax_out, jax_dets = _full_width_serving(
        'tools/cfgs/waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml',
        WAYMO_CROP, scans, 1500, (64, 16))
    assert out['has_class_labels'] is True
    assert model.backbone_3d.conv_input[0].in_features == 27 * 5
    for key in ('final_boxes', 'final_scores', 'final_labels',
                'final_valid'):
        np.testing.assert_allclose(
            out[key].float().numpy(), np.asarray(jax_out[key], np.float32),
            rtol=1e-4, atol=1e-4 * float(np.abs(jax_out[key]).max()),
            err_msg=key)
    _hold_roi_stage(model, out, post_cfg, jax_out, jax_dets)


def test_voxel_rcnn_car_trains_at_full_width_on_a_cropped_range():
    """voxel_rcnn_car.yaml at its full widths through
    ``build_detector_from_cfg(cfg).train()`` and ``make_train_step`` on a
    ``voxel_batch(mode='train')`` with gt boxes (DP_RATIO 0.3: a Dropout
    after the first of the two hidden layers of each tower). Cuts: the
    cropped range, 1000 voxels a level, 64 / 16 proposals before / after
    the train NMS, 16 RoIs a frame, three gt boxes near proposals. The
    loss and every gradient finite, every parameter moved."""
    cfg = zoo.voxel_rcnn_kitti_cfg()
    _crop(cfg, CROP, 1000, mode='train')
    nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 64, 16
    cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
    pts, gt = synthetic_scene_batch(22, 2, 2048, pc_range=CROP,
                                    n_clusters=6)
    gt[:, :, 7] = 1
    batch = {k: torch.from_numpy(v) for k, v in voxel_batch(
        pts, cfg.DATA_CONFIG, mode='train', gt_boxes=list(gt)).items()}
    model = build_detector_from_cfg(cfg, device='cpu').train()
    assert [type(m).__name__ for m in model.roi_head.cls_layers] == [
        'Linear', 'BatchNormLast', 'ReLU', 'Dropout', 'Linear',
        'BatchNormLast', 'ReLU', 'Linear']
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = optimization.build_optimizer(cfg.OPTIMIZATION, model.parameters(),
                                       10, 2)
    loss, tb = make_train_step(model, opt)(batch)
    assert set(tb) == VOXEL_KEYS - {'loss'}
    assert torch.isfinite(loss) and all(torch.isfinite(v)
                                        for v in tb.values())
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert not torch.equal(p.detach(), before[name]), name
