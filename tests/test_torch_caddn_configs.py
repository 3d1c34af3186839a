"""``kitti_models/CaDDN.yaml`` in the port against the JAX package on the
CPU, at full model width: the DDN's 64 channels and 80 LID bins, the
1 600-channel collapse (25 z slices of 64), the BEV backbone's three
levels of ten convolutions (64, 128, 256) and the three-class anchor head.

Both packages build it through ``build_detector_from_cfg`` (the class
names and the point-cloud range from its DATA_CONFIG; the voxel size is
CaDDN's default in both, whatever ``calculate_grid_size`` says: ROADMAP
Queue 3). The only cuts are of scale, each listed here:

- the range cropped to CROP, a 64 x 64 x 25 grid of 0.16 m;
- the image cropped to 96 x 320 (``VFE.IMAGE_SHAPE`` with it) and its
  calibration's focal length and principal point scaled to it (P2_CROP);
- synthetic camera frames (``data.camera``) of scans of 4 096 points.

Both get the same numpy-filled variables through the weight bridge.
Serving: the voxels, the BEV map and backbone, the anchor predictions and
the depth logits within RTOL relative plus ATOL of each tensor's largest
entry, the detections through ``hold_nms``. Training: a train-mode
forward's anchor labels (JAX's assignment run op by op) and its
depth-distribution loss within 1e-4 relative, on frames whose strided
depths lie off the bin edges (jitted JAX multiplies by the reciprocal
where the port divides).
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models.dense_heads import anchor_head as jax_anchor_head
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.utils import box_coder as jax_box_coder
from spsnet_torch import zoo
from spsnet_torch.data.camera import synthetic_camera_batch
from spsnet_torch.models import build_detector_from_cfg
from spsnet_torch.models.detectors.caddn import CaDDN
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.vfe import image_vfe
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_caddn import _vox
from tests.test_torch_pointpillar import _close, _nhwc, _t, hold_nms
from tests.test_torch_pvrcnn_train import _variables

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

PATH = 'tools/cfgs/kitti_models/CaDDN.yaml'
CROP = [2.0, -5.12, -3.0, 12.24, 5.12, 1.0]
RANGE = (2.0, -30.08, -3.0, 46.8, 30.08, 1.0)
IMAGE = (96, 320)
P2_CROP = np.array([[160, 0, 160, 10], [0, 160, 48, 0], [0, 0, 1, 0.005]],
                   np.float32)
LOSS_RTOL = 1e-4
BIN_SLACK = 1e-4


def _cut(cfg):
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(CROP)
    cfg.MODEL.VFE.IMAGE_SHAPE = list(IMAGE)
    return cfg


def test_caddn_yaml_builds_with_the_default_voxel_size():
    """CaDDN.yaml builds in both packages on the 280 x 376 x 25 grid with
    157 920 anchors; the voxel size is CaDDN's default 0.16 m in both,
    which the yaml's ``calculate_grid_size`` repeats: set to 0.32 m there,
    neither package reads it (ROADMAP Queue 3)."""
    for vs in (None, [0.32, 0.32, 0.32]):
        cfg, jcfg = zoo.load_yaml_cfg(PATH), jax_zoo.load_yaml_cfg(PATH)
        if vs is not None:
            for c in (cfg, jcfg):
                step = [p for p in c.DATA_CONFIG.DATA_PROCESSOR
                        if p.NAME == 'calculate_grid_size'][0]
                step.VOXEL_SIZE = vs
        model = build_detector_from_cfg(cfg, device='cpu')
        assert isinstance(model, CaDDN)
        assert model.grid_size == (280, 376, 25)
        assert model.dense_head.anchors.shape == (157920, 7)
        assert tuple(model.vfe.grid.centers.shape) == (280, 376, 25, 3)
        jm = jax_build_from_cfg(jcfg)
        assert tuple(jm.voxel_size) == (0.16, 0.16, 0.16)
        assert tuple(jm.point_cloud_range) == RANGE


@pytest.fixture(scope='module')
def cropped():
    """Both packages' CaDDN.yaml on the crop with the same variables (the
    anchor box layer at 0.05), two frames, JAX's eval outputs and
    detections (jitted once) and its train forward's loss terms."""
    cfg, jcfg = _cut(zoo.load_yaml_cfg(PATH)), _cut(jax_zoo.load_yaml_cfg(
        PATH))
    batch = synthetic_camera_batch(7, 2, image_shape=IMAGE, pc_range=CROP,
                                   p2=P2_CROP, n_points=4096, n_boxes=6)
    jm = jax_build_from_cfg(jcfg)
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    model = build_detector_from_cfg(cfg, device='cpu')
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    post = cfg.MODEL.POST_PROCESSING
    jout, jdets = jax.jit(lambda v, b: (lambda o: (
        o, jax_post_processing(o, StaticConfig(copy.deepcopy(
            jcfg.MODEL.POST_PROCESSING)))))(jm.apply(v, b, train=False)))(
        variables, batch)

    def train_loss(v, b):
        out, _ = jm.apply(v, b, train=True, mutable=['batch_stats'])
        return jm.apply(v, out, method='loss')
    _, jtb = jax.jit(train_loss)(variables, batch)
    return {'model': model, 'batch': batch, 'post': post, 'jout': jout,
            'jdets': jdets, 'janchors': jout['anchor_head_ret']['anchors'],
            'jtb': {k: float(v) for k, v in jtb.items()}}


def test_caddn_yaml_serves_as_jax_on_a_crop(cropped):
    """Every stage within tolerance, detections as ``hold_nms`` holds
    them; the 1 600 collapse channels and 6 144 anchors of the crop."""
    model, jout = cropped['model'], cropped['jout']
    assert model.map_to_bev_module.collapse.in_channels == 1600
    with torch.no_grad():
        out = model({k: _t(v) for k, v in cropped['batch'].items()})
    assert out['voxel_features_3d'].shape == (2, 64, 64, 64, 25)
    _close(out['voxel_features_3d'], _vox(jout['voxel_features_3d']),
           'voxels')
    for key in ('spatial_features', 'spatial_features_2d'):
        _close(out[key], _nhwc(jout[key]), key)
    _close(out['image_vfe_ret']['depth_logits'],
           _nhwc(jout['image_vfe_ret']['depth_logits']), 'depth logits')
    for key in ('batch_box_preds', 'batch_cls_preds'):
        _close(out[key], jout[key], key)
    assert out['batch_box_preds'].shape == (2, 6144, 7)
    dets = post_processing(out, cropped['post'])
    hold_nms(out, dets, cropped['jdets'], cropped['post'])
    assert int(dets['count'].min()) > 0


def test_caddn_yaml_train_targets_and_depth_loss_as_jax_on_a_crop(cropped):
    """A train-mode forward: the anchors JAX's, the anchor labels of the
    gt of three classes JAX's ``assign_anchor_targets`` run op by op
    (jitted XLA:CPU contracts the union area into an FMA and breaks the
    IoU ties of the gt's zero headings otherwise), the depth-distribution
    loss within LOSS_RTOL of jitted JAX's on strided depths off the bin
    edges; every loss term finite and positive."""
    model, batch = copy.deepcopy(cropped['model']), cropped['batch']
    disc = dict(model.model_cfg.VFE.FFN.DISCRETIZE)
    idx = image_vfe.bin_depths(_t(batch['depth_maps'][:, ::4, ::4]),
                               disc['mode'], disc['depth_min'],
                               disc['depth_max'], disc['num_bins'])
    idx = idx[torch.isfinite(idx)]
    assert int((batch['depth_maps'] > 0).sum()) > 500
    assert float((idx - idx.round()).abs().min()) > BIN_SLACK
    model.train()
    out = model({k: _t(v) for k, v in batch.items()})
    loss, tb = model.loss(out)
    head = model.dense_head
    np.testing.assert_array_equal(head.anchors.numpy(),
                                  np.asarray(cropped['janchors']))
    coder = jax_box_coder.build_box_coder('ResidualCoder')
    with jax.disable_jit():
        labels = [np.asarray(jax_anchor_head.assign_anchor_targets(
            jnp.asarray(head.anchors.numpy()), head.anchor_cls.numpy(),
            head.anchor_matched.numpy(), head.anchor_unmatched.numpy(),
            jnp.asarray(gt), coder, 3)[0]) for gt in batch['gt_boxes']]
    got = out['anchor_head_ret']['box_cls_labels'].numpy()
    np.testing.assert_array_equal(got, np.stack(labels))
    assert set(np.unique(got[got > 0])) == {1, 2, 3}
    assert set(tb) == set(cropped['jtb'])
    np.testing.assert_allclose(float(tb['ddn_loss'].detach()),
                               cropped['jtb']['ddn_loss'], rtol=LOSS_RTOL)
    assert torch.isfinite(loss) and all(float(v.detach()) > 0
                                         for v in tb.values())
