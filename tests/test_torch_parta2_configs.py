"""The three PartA2 configs of ``tools/cfgs`` at full width on cropped
ranges in the port against the JAX package on the CPU: KITTI's
``PartA2.yaml`` and ``PartA2_free.yaml`` (a PointRCNN config over UNetV2)
and Waymo's ``PartA2.yaml``, each through both packages'
``build_detector_from_cfg``, the port's host batch with the UNet's up
tables (``voxel_batch(..., up_tables=uses_up_tables(cfg.MODEL))``) and the
same numpy-filled flax variables (``tests/test_torch_pvrcnn_train.py``'s
``_variables``) through the weight bridge; and ``PartA2.yaml``'s train
step. Each case lists its cuts (scale only: the range, the voxel caps, the
proposals kept). The UNet's features, the BEV map and the proposals must
lie within RTOL relative plus ATOL times each tensor's largest entry, the
RoI labels be identical; the RoI head is then replayed on JAX's RoIs (a
voxel centre on a pool cell's face may fall on either side of it for RoIs
a rounding apart) and its outputs and ``post_processing``'s detections
held to JAX's.
"""
import copy

import numpy as np
import jax
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_torch import zoo
from spsnet_torch.data.processor import uses_up_tables, voxel_batch
from spsnet_torch.models import build_detector_from_cfg
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.roi_heads.pointrcnn_head import decode_in_roi_frame
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.trainer import make_train_step
from spsnet_torch.utils.synthetic import (synthetic_scan_batch,
                                          synthetic_scene_batch)
from spsnet_torch.utils.weights import load_flax
from tests.test_torch_parta2_train import PART_KEYS, hold_proposals
from tests.test_torch_pvrcnn import CROP, _close
from tests.test_torch_pvrcnn_train import _gt_near_proposals, _variables
from tests.test_torch_voxelrcnn import WAYMO_CROP, _t
from tests.test_torch_voxelrcnn_configs import _crop

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)


def _serve(path, crop, scans, n_voxels, roi_nms):
    """``path`` at its full widths on ``crop`` with ``n_voxels`` voxels a
    level and the RoI head's test NMS at ``roi_nms`` (pre, post): both
    packages' model from the same variables, their eval forwards and
    ``post_processing``; the port's config and batch."""
    jcfg, cfg = (z.load_yaml_cfg(path) for z in (jax_zoo, zoo))
    for c in (jcfg, cfg):
        _crop(c, crop, n_voxels)
        nms = c.MODEL.ROI_HEAD.NMS_CONFIG.TEST
        nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = roi_nms
    batch = voxel_batch(scans, cfg.DATA_CONFIG,
                        up_tables=uses_up_tables(cfg.MODEL))
    jm = jax_build_from_cfg(jcfg)
    variables = _variables(jm, batch)
    post = StaticConfig(cfg.MODEL.POST_PROCESSING)
    jout, jdets = jax.jit(lambda v, b: (lambda o: (
        o, jax_post_processing(o, post)))(jm.apply(v, b, train=False)))(
            variables, batch)
    model = load_flax(build_detector_from_cfg(cfg, device='cpu'), variables)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    return cfg, batch, model, out, jout, jdets


def _hold_roi_stage(model, out, post_cfg, jout, jdets):
    """The RoI head on JAX's RoIs (its pools, the refinement, the decoded
    boxes) within tolerance of JAX's outputs, the pooled grids' active
    cells identical, and ``post_processing``'s indices, counts and labels
    identical, boxes and scores within tolerance."""
    jret = jout['roi_head_ret']
    head, rois = model.roi_head, _t(jret['rois'])
    with torch.no_grad():
        part, rpn = head.pool(out, rois)
        rcnn_cls, rcnn_reg = head.refine(part, rpn)
        boxes = decode_in_roi_frame(head.box_coder, rcnn_reg, rois)
    assert (part.sum(-1) != 0).any()
    for got, key in ((rcnn_cls, 'rcnn_cls'), (rcnn_reg, 'rcnn_reg'),
                     (boxes, 'batch_box_preds')):
        _close(got, jret[key], key)
    dets = post_processing(dict(out, batch_cls_preds=rcnn_cls,
                                batch_box_preds=boxes), post_cfg)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(),
                                      np.asarray(jdets[key]), err_msg=key)
    _close(dets['boxes'], jdets['boxes'], 'boxes')
    _close(dets['scores'], jdets['scores'], 'scores')
    return dets


def test_full_width_parta2_on_a_cropped_range():
    """kitti_models/PartA2.yaml at its full widths (UNetV2, the 5-layer
    BEV backbone, CLS_FC [] and PART_FC [] part layers, POOL_SIZE 12 with
    64-channel RoI convolutions, SHARED_FC 256 over 128 x 12^3). Cuts:
    ``tests/test_torch_pvrcnn.py``'s cropped range (final grid (2, 32,
    32)), 1000 voxels a level, scans of 2048 points, 64 / 16 proposals
    before / after the RoI head's test NMS."""
    scans = synthetic_scan_batch(91, 2, 2048, pc_range=CROP)
    cfg, _, model, out, jout, jdets = _serve(
        'tools/cfgs/kitti_models/PartA2.yaml', CROP, scans, 1000, (64, 16))
    assert model.roi_head.shared_fc_layer[0].in_features == 128 * 12 ** 3
    assert model.roi_head.conv_rpn[0][0].weight.shape == (64, 16, 3, 3, 3)
    _close(out['point_features'], jout['point_features'], 'point_features')
    _close(out['spatial_features_2d'],
           np.asarray(jout['spatial_features_2d']).transpose(0, 3, 1, 2),
           'spatial_features_2d')
    _close(out['rois'], jout['roi_head_ret']['rois'], 'rois')
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jout['batch_roi_labels'])
    dets = _hold_roi_stage(model, out, cfg.MODEL.POST_PROCESSING, jout,
                           jdets)
    assert int(dets['count'].min()) > 0


def test_full_width_parta2_free_on_a_cropped_range():
    """kitti_models/PartA2_free.yaml at its full widths (UNetV2 without its
    encoded tensor, 128-wide part layers with the box branch, DISABLE_PART,
    the RoI head as PartA2's): the boxes of every voxel row, the padded
    rows among them (1500 rows for fewer voxels), are the proposals, held
    by ``hold_proposals``. Cuts: the cropped range, 1500 voxels a level,
    scans of 1200 points, 1024 / 16 proposals before / after the test
    NMS."""
    scans = synthetic_scan_batch(92, 2, 1200, pc_range=CROP)
    cfg, batch, model, out, jout, jdets = _serve(
        'tools/cfgs/kitti_models/PartA2_free.yaml', CROP, scans, 1500,
        (1024, 16))
    assert type(model).__name__ == 'PartA2FreeNet'
    assert not hasattr(model.backbone_3d, 'conv_out')
    assert (~batch['voxel_valid']).any(1).all()
    _close(out['point_features'], jout['point_features'], 'point_features')
    assert hold_proposals(out['rois'], jout['roi_head_ret']['rois']) == 0
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jout['batch_roi_labels'])
    dets = _hold_roi_stage(model, out, cfg.MODEL.POST_PROCESSING, jout,
                           jdets)
    assert int(dets['count'].min()) > 0


def test_full_width_waymo_parta2_on_a_cropped_range():
    """waymo_models/PartA2.yaml at its full widths with 5 point channels.
    Cuts: Waymo's range cropped to WAYMO_CROP (final grid (2, 32, 32)),
    2400 voxels a level (MAX_VOXELS_PER_LEVEL with it: every voxel of the
    scans), scans of 2400 points lifted 1.65 m (the synthetic ground onto Waymo's z = 0, where
    its anchors stand), 64 / 16 proposals before / after the RoI head's
    test NMS."""
    scans = synthetic_scan_batch(93, 2, 2400, pc_range=WAYMO_CROP)
    scans[..., 2] += 1.65
    scans = np.concatenate([scans, np.full_like(scans[..., :1], 0.5)], -1)
    cfg, _, model, out, jout, jdets = _serve(
        'tools/cfgs/waymo_models/PartA2.yaml', WAYMO_CROP, scans, 2400,
        (64, 16))
    assert model.backbone_3d.conv_input[0].in_features == 27 * 5
    _close(out['point_features'], jout['point_features'], 'point_features')
    _close(out['rois'], jout['roi_head_ret']['rois'], 'rois')
    _hold_roi_stage(model, out, cfg.MODEL.POST_PROCESSING, jout, jdets)


def test_parta2_trains_at_full_width_on_a_cropped_range():
    """kitti_models/PartA2.yaml at its full widths through
    ``build_detector_from_cfg(cfg).train()`` and ``make_train_step`` on a
    ``voxel_batch(mode='train', up_tables=True)`` with gt boxes (DP_RATIO
    0.3: Dropouts between the shared blocks and after each tower's first).
    Cuts: the cropped range, 1000 voxels a level, 64 / 16 proposals before
    / after the train NMS, 16 RoIs a frame, three gt boxes near proposals.
    The loss terms and every gradient finite, every parameter moved."""
    cfg = zoo.parta2_kitti_cfg()
    _crop(cfg, CROP, 1000, mode='train')
    nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 64, 16
    cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
    pts, gt = synthetic_scene_batch(94, 2, 2048, pc_range=CROP,
                                    n_clusters=6)
    gt[:, :, 7] = 1
    batch = {k: torch.from_numpy(v) for k, v in voxel_batch(
        pts, cfg.DATA_CONFIG, mode='train', gt_boxes=list(gt),
        up_tables=True).items()}
    model = build_detector_from_cfg(cfg, device='cpu').train()
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = optimization.build_optimizer(cfg.OPTIMIZATION, model.parameters(),
                                       10, 2)
    loss, tb = make_train_step(model, opt)(copy.copy(batch))
    assert set(tb) == PART_KEYS - {'loss'} | {
        'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir', 'rpn_loss'}
    assert torch.isfinite(loss) and all(torch.isfinite(v)
                                        for v in tb.values())
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert not torch.equal(p.detach(), before[name]), name
