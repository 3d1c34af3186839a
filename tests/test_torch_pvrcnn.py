"""The port's PV-RCNN and SECOND serving paths against the JAX package on
the CPU.

The tiny PV-RCNN (``zoo.tiny_pvrcnn_cfg``, the topology of
``pv_rcnn.yaml``) serves the two frames of ``tests/test_pvrcnn.py``'s
``make_pv_batch``: random voxels on a (64, 16, 16) grid with the JAX
package's own host plan, 256 raw points. Flax variables from a fixed key go
through the weight bridge. Host tables, anchors, FPS, ball-query and NMS
indices must be identical; floats stay within ``RTOL`` relative plus
``ATOL`` times the tensor's largest entry: both packages run fp32 with
sums in another order (XLA:CPU against the CPU BLAS and oneDNN), ~1e-7
relative per layer, over ~20 layers. One case runs
``pv_rcnn.yaml`` at its full channel widths on a cropped range (fewer
voxels, keypoints and RoIs), one SECOND's forward; the unit cases hold
each module to its JAX counterpart.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import ops as jops
from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.data.processor.data_processor import DataProcessor
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_tpu.models.backbones_2d.base_bev_backbone import \
    BaseBEVBackbone as JaxBEV
from spsnet_tpu.models.dense_heads import anchor_head as jax_anchor_head
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.roi_heads.pvrcnn_head import \
    roi_grid_points as jax_roi_grid_points
from spsnet_torch import ops, zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector, build_detector_from_cfg
from spsnet_torch.models.backbones_2d.base_bev_backbone import \
    BaseBEVBackbone
from spsnet_torch.models.dense_heads.anchor_head import generate_anchors
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.roi_heads.pvrcnn_head import (grid_template,
                                                       roi_grid_points)
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_pvrcnn import PCR, VS, make_pv_batch

RTOL, ATOL = 1e-4, 1e-4
# kernel factors on the flax init (lecun-normal, whose activations fade
# through sparse neighbourhoods: 3e-6 at x_conv4 and 5e-8 at the anchor
# logits, where every score rounds to sigmoid(0)) that keep every stage
# near unit scale and the anchors' scores apart
KERNEL_SCALES = {('backbone_3d',): 3.5, ('backbone_2d',): 2.0,
                 ('dense_head', 'conv_cls'): 0.5,
                 ('dense_head', 'conv_box'): 0.05,
                 ('dense_head', 'conv_dir_cls'): 0.2}
# the cropped range of tests/test_pvrcnn.py at KITTI's voxel size: sparse
# grid (41, 256, 256), final (2, 32, 32), so NUM_BEV_FEATURES stays 256
CROP = (0, -6.4, -3, 12.8, 6.4, 1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    """Within ``rtol`` relative plus ``atol`` times the largest entry of
    ``want``: the rounding of a sum scales with its terms, and an entry
    near zero may be the sum of large ones."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def _jax_vars(model, batch):
    """Flax variables from key 0, the kernels scaled by KERNEL_SCALES."""
    variables = jax.jit(lambda k, b: model.init(k, b, train=False))(
        jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))

    def scale(path, leaf):
        names = tuple(getattr(k, 'key', k) for k in path)
        for prefix, factor in KERNEL_SCALES.items():
            if names[1:1 + len(prefix)] == prefix and names[-1] == 'kernel':
                return leaf * np.float32(factor)
        return leaf
    return jax.tree_util.tree_map_with_path(scale, variables)


def _run(jm, variables, batch):
    """The JAX forward's batch dict (every stage's outputs) and
    ``post_processing`` of it."""
    post = StaticConfig(jm.model_cfg.POST_PROCESSING)

    def forward(v, b):
        out = jm.apply(v, b, train=False)
        return out, jax_post_processing(out, post)
    return jax.jit(forward)(variables, batch)


def _torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def tiny():
    batch, final_zyx = make_pv_batch(np.random.default_rng(0))
    batch = {k: np.asarray(v) for k, v in batch.items()
             if k != 'gt_boxes'}
    final_zyx = tuple(int(v) for v in final_zyx)
    cfg = zoo.tiny_pvrcnn_cfg(final_zyx)
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=final_zyx)
    variables = _jax_vars(jm, batch)
    jax_out, jax_dets = _run(jm, variables, batch)
    model = build_detector(cfg, 1, device='cpu', voxel_size=VS,
                           point_cloud_range=PCR, final_grid_zyx=final_zyx)
    load_flax(model, variables)
    with torch.no_grad():
        out = model(_torch_batch(batch))
    return {'jm': jm, 'variables': variables, 'batch': batch,
            'jax_out': jax_out, 'jax_dets': jax_dets, 'model': model,
            'out': out, 'dets': post_processing(out, cfg.POST_PROCESSING),
            'cfg': cfg}


# ---------------------------------------------------------------- host side

def _jax_processor(data_cfg, training):
    steps = [p for p in data_cfg.DATA_PROCESSOR
             if p.NAME in ('transform_points_to_voxels',
                           'build_sparse_conv_plan')]
    return DataProcessor(steps, data_cfg.POINT_CLOUD_RANGE, training)


@pytest.mark.parametrize('seed,mode,cap', [(0, 'test', None),
                                           (1, 'train', None),
                                           (2, 'test', 1500),
                                           (3, 'train', 1200)])
def test_voxels_and_plan_are_identical_to_jax(seed, mode, cap):
    """``voxel_batch`` (the voxelization and the sparse plan at
    pv_rcnn.yaml's settings; ``cap`` lowers MAX_NUMBER_OF_VOXELS so that
    the voxel limit and the per-level cap cut) gives the JAX package's
    ``DataProcessor`` arrays, every table bit for bit."""
    jcfg = jax_zoo.load_yaml_cfg('tools/cfgs/kitti_models/pv_rcnn.yaml')
    cfg = zoo.pv_rcnn_kitti_cfg()
    if cap is not None:
        for c in (jcfg, cfg):
            step = [p for p in c.DATA_CONFIG.DATA_PROCESSOR
                    if p.NAME == 'transform_points_to_voxels'][0]
            step.MAX_NUMBER_OF_VOXELS[mode] = cap
    scans = synthetic_scan_batch(seed, 2, 4096)
    got = voxel_batch(scans, cfg.DATA_CONFIG, mode)
    proc = _jax_processor(jcfg.DATA_CONFIG, mode == 'train')
    for b in range(2):
        want = proc.forward({'points': scans[b].copy()})
        assert set(want) == set(got)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key][b], value, err_msg=key)
            assert got[key].dtype == value.dtype, key
    if cap is not None:
        assert got['voxel_valid'].sum(1).max() == cap


# ---------------------------------------------------------------- modules

def test_mean_vfe_matches_jax(tiny):
    _close(tiny['out']['voxel_features'], tiny['jax_out']['voxel_features'],
           'voxel_features', rtol=0, atol=1e-6)


def test_voxel_backbone_levels_match_jax(tiny):
    """Every level of the sparse backbone (x_conv1..4) and its output."""
    out, jout = tiny['out'], tiny['jax_out']
    for name in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
        want = np.asarray(jout['multi_scale_3d_features'][name])
        assert np.abs(want).max() > 0.1, name
        _close(out['multi_scale_3d_features'][name], want, name)
    _close(out['encoded_voxel_features'], jout['encoded_voxel_features'],
           'encoded_voxel_features')


def test_height_compression_is_z_major(tiny):
    """'spatial_features' (B, nz * C, ny, nx) is the JAX package's NHWC
    map with channel z * C + c."""
    got = tiny['out']['spatial_features']
    want = np.asarray(tiny['jax_out']['spatial_features'])
    _close(got, want.transpose(0, 3, 1, 2), 'spatial_features')
    nz, ny, nx = tiny['model'].map_to_bev_module.grid_zyx
    feats = tiny['out']['encoded_voxel_features']
    coords = tiny['batch']['out_coords']
    valid = tiny['batch']['out_valid']
    b, v = np.argwhere(valid)[0]
    z, y, x = coords[b, v]
    np.testing.assert_array_equal(got[b, z * 128:(z + 1) * 128, y, x],
                                  feats[b, v])


def test_bev_backbone_matches_jax(tiny):
    _close(tiny['out']['spatial_features_2d'],
           np.asarray(tiny['jax_out']['spatial_features_2d']).transpose(
               0, 3, 1, 2), 'spatial_features_2d')


class _Holder(torch.nn.Module):
    def __init__(self, **modules):
        super().__init__()
        for k, v in modules.items():
            self.add_module(k, v)


def test_stride_two_deblock_matches_flax_conv_transpose():
    """The bridge's ConvTranspose mapping (in / out swap and the spatial
    flip) on a non-symmetric kernel: a BEV backbone with one stride-2 level
    and a stride-2 deblock against flax on a random map."""
    cfg = JaxEDict({'LAYER_NUMS': [1], 'LAYER_STRIDES': [2],
                    'NUM_FILTERS': [6], 'UPSAMPLE_STRIDES': [2],
                    'NUM_UPSAMPLE_FILTERS': [5]})
    x = np.random.default_rng(5).normal(size=(2, 8, 10, 4)).astype(
        np.float32)
    jm = JaxBEV(model_cfg=StaticConfig(cfg), input_channels=4)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, f: jm.init(k, {'spatial_features': f}, train=False))(
            jax.random.PRNGKey(1), x)))
    kernel = variables['params']['deblock0']['kernel']
    assert kernel.shape == (2, 2, 6, 5)
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    want = jax.jit(lambda v, f: jm.apply(v, {'spatial_features': f},
                                         train=False))(
        variables, x)['spatial_features_2d']
    port = _Holder(backbone_2d=BaseBEVBackbone(cfg, 4)).eval()
    load_flax(port, {c: {'backbone_2d': t} for c, t in variables.items()})
    w = port.backbone_2d.deblocks[0][0].weight.detach().numpy()
    np.testing.assert_array_equal(w, kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    with torch.no_grad():
        got = port.backbone_2d({'spatial_features': _t(x.transpose(
            0, 3, 1, 2))})['spatial_features_2d']
    _close(got, np.asarray(want).transpose(0, 3, 1, 2), 'deblock output')


@pytest.mark.parametrize('align_center', [False, True])
def test_anchors_are_identical_to_jax(align_center):
    """pv_rcnn.yaml's three classes x two rotations on the KITTI grid."""
    agc = [dict(c) for c in zoo.pv_rcnn_kitti_cfg().MODEL.DENSE_HEAD.
           ANCHOR_GENERATOR_CONFIG]
    for c in agc:
        c['align_center'] = align_center
    got, cls, _, _ = generate_anchors(agc, (1408, 1600, 40),
                                      (0, -40, -3, 70.4, 40, 1), 8)
    want = jax_anchor_head.generate_anchors(agc, (1408, 1600, 40),
                                            (0, -40, -3, 70.4, 40, 1), 8)
    assert got.shape == (200, 176, 6, 7)
    np.testing.assert_array_equal(got, want[0])
    np.testing.assert_array_equal(cls, want[1])


def test_anchor_head_preds_and_decoded_boxes_match_jax(tiny):
    ret, jret = tiny['out']['anchor_head_ret'], \
        tiny['jax_out']['anchor_head_ret']
    for key in ('cls_preds', 'box_preds', 'dir_preds'):
        _close(ret[key], jret[key], key)
    np.testing.assert_array_equal(ret['anchors'].numpy(), jret['anchors'])
    np.testing.assert_array_equal(ret['dir_preds'].argmax(-1).numpy(),
                                  np.asarray(jret['dir_preds']).argmax(-1))
    with torch.no_grad():
        got = tiny['model'].dense_head({'spatial_features_2d': tiny['out'][
            'spatial_features_2d']})['batch_box_preds']
    _close(got, _jax_rpn_boxes(tiny), 'decoded anchor boxes')


def _jax_rpn_boxes(tiny):
    """The JAX anchor head's decoded boxes (the forward's final
    'batch_box_preds' are the RoI head's)."""
    jm = tiny['jm']
    return jax.jit(lambda v, f: jm.apply(
        v, {'spatial_features_2d': f},
        method=lambda m, b: m.dense_head(b, train=False))[
            'batch_box_preds'])(tiny['variables'],
                                tiny['jax_out']['spatial_features_2d'])


def test_zero_empty_balls_matches_jax():
    rng = np.random.default_rng(6)
    grouped = rng.normal(0, 0.5, size=(2, 7, 4, 6)).astype(np.float32)
    grouped[0, 3, 0, :3] = [0.3, 0.4, 0.0]   # d2 = 0.25 = r^2: empty
    want = jops.grouping.zero_empty_balls(grouped, 0.5)
    got = ops.zero_empty_balls(_t(grouped), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, 3] == 0).all()


def test_vsa_keypoints_balls_and_features_match_jax(tiny):
    """FPS keypoints identical (the same points gathered), each source's
    ball-query indices identical to the JAX package's on the same
    centers, the keypoint features within tolerance."""
    out, jout = tiny['out'], tiny['jax_out']
    pfe = tiny['model'].pfe
    np.testing.assert_array_equal(out['point_coords'].numpy(),
                                  jout['point_coords'])
    xyz = tiny['batch']['points'][..., :3]
    jidx = jax.jit(lambda p: jops.farthest_point_sample(p, 64))(xyz)
    np.testing.assert_array_equal(out['keypoint_idx'].numpy(), jidx)
    kp = out['point_coords']
    sources = [('raw_points', _t(xyz), pfe.SA_rawpoints)] + [
        (name, pfe.voxel_centers(_torch_batch(tiny['batch']), name), group)
        for name, group in pfe.SA_layers.items()]
    for name, support, group in sources:
        got = ops.ball_query_multi(group.radii, group.nsamples, support, kp)
        for r, ns, g in zip(group.radii, group.nsamples, got):
            want = jax.jit(lambda s, c, r=r, ns=ns: jops.ball_query(
                r, ns, s, c))(support.numpy(), kp.numpy())
            np.testing.assert_array_equal(g.numpy(), want,
                                          err_msg=f'{name} r={r}')
    _close(out['point_features_before_fusion'],
           jout['point_features_before_fusion'], 'keypoint features')
    _close(out['point_features'], jout['point_features'], 'point_features')


def test_point_head_simple_matches_jax(tiny):
    out, jout = tiny['out'], tiny['jax_out']
    _close(out['point_head_simple_ret']['point_cls_preds'],
           jout['point_head_simple_ret']['point_cls_preds'], 'cls preds')
    _close(out['point_cls_scores'], jout['point_cls_scores'], 'scores')


def test_roi_grid_points_match_jax():
    rng = np.random.default_rng(7)
    rois = np.concatenate([rng.uniform(-10, 10, (2, 5, 3)),
                           rng.uniform(0.5, 4, (2, 5, 3)),
                           rng.uniform(-3.2, 3.2, (2, 5, 1))],
                          -1).astype(np.float32)
    want = jax.jit(lambda r: jax_roi_grid_points(r, 6))(rois)
    got = roi_grid_points(_t(rois), torch.from_numpy(grid_template(6)))
    assert got.shape == (2, 5, 216, 3)
    _close(got, want, 'grid points', rtol=0, atol=1e-5)


def test_roi_grid_pool_matches_jax(tiny):
    """The pool over the JAX package's RoIs and keypoint features: the
    grid points' ball queries over the keypoints, the zeroed empty balls,
    the MLPs and the channel-major flatten."""
    jm, jout = tiny['jm'], tiny['jax_out']
    stage = {k: jout[k] for k in ('point_coords', 'point_features',
                                  'point_cls_scores')}
    rois = jout['roi_head_ret']['rois']
    want = jax.jit(lambda v, s, r: jm.apply(
        v, s, r, method=lambda m, b, rr: m.roi_head.roi_grid_pool(
            b, rr, False)))(tiny['variables'], stage, rois)
    with torch.no_grad():
        got = tiny['model'].roi_head.roi_grid_pool(
            {k: _t(v) for k, v in stage.items()}, _t(rois))
    assert got.shape == want.shape
    _close(got, want, 'pooled RoI-grid features')


def test_roi_head_outputs_match_jax(tiny):
    """Proposal indices identical (the same RoIs), the refinement and the
    decoded boxes within tolerance."""
    ret, jret = tiny['out']['roi_head_ret'], tiny['jax_out']['roi_head_ret']
    _close(ret['rois'], jret['rois'], 'rois')
    for key in ('rcnn_cls', 'rcnn_reg', 'batch_box_preds'):
        _close(ret[key], jret[key], key)
    np.testing.assert_array_equal(tiny['out']['batch_roi_labels'].numpy(),
                                  tiny['jax_out']['batch_roi_labels'])


def test_forward_and_post_processing_match_jax(tiny):
    dets, jdets = tiny['dets'], tiny['jax_dets']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    for key in ('boxes', 'scores'):
        _close(dets[key], jdets[key], key)
    assert int(dets['count'].sum()) > 0


def test_full_width_pv_rcnn_on_a_cropped_range():
    """pv_rcnn.yaml at its full channel widths (NUM_BEV_FEATURES 256, the
    VSA's five sources, 256-wide towers, 3 classes) on CROP: scans voxelized
    by the port's host code and the JAX package's alike; cut in scale:
    1000 voxels, 256 keypoints, 64 / 16 proposals before / after NMS."""
    jcfg = jax_zoo.load_yaml_cfg('tools/cfgs/kitti_models/pv_rcnn.yaml')
    cfg = zoo.pv_rcnn_kitti_cfg()
    for c in (jcfg, cfg):
        c.DATA_CONFIG.POINT_CLOUD_RANGE = list(CROP)
        step = [p for p in c.DATA_CONFIG.DATA_PROCESSOR
                if p.NAME == 'transform_points_to_voxels'][0]
        step.MAX_NUMBER_OF_VOXELS.test = 1000
        c.MODEL.PFE.NUM_KEYPOINTS = 256
        c.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 64
        c.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 16
    scans = synthetic_scan_batch(8, 2, 2048, pc_range=CROP)
    batch = voxel_batch(scans, cfg.DATA_CONFIG)
    proc = _jax_processor(jcfg.DATA_CONFIG, False)
    want = proc.forward({'points': scans[1].copy()})
    np.testing.assert_array_equal(batch['subm4_table'][1],
                                  want['subm4_table'])
    jm = jax_build_from_cfg(jcfg)
    assert tuple(jm.final_grid_zyx) == (2, 32, 32)
    variables = _jax_vars(jm, batch)
    jax_out, jax_dets = _run(jm, variables, batch)
    model = build_detector_from_cfg(cfg, device='cpu')
    load_flax(model, variables)
    with torch.no_grad():
        out = model(_torch_batch(batch))
    dets = post_processing(out, cfg.MODEL.POST_PROCESSING)
    assert out['spatial_features'].shape == (2, 256, 32, 32)
    np.testing.assert_array_equal(out['point_coords'].numpy(),
                                  jax_out['point_coords'])
    _close(out['spatial_features_2d'],
           np.asarray(jax_out['spatial_features_2d']).transpose(0, 3, 1, 2),
           'spatial_features_2d')
    _close(out['point_features'], jax_out['point_features'],
           'point_features')
    _close(out['rois'], jax_out['roi_head_ret']['rois'], 'rois')
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jax_out['batch_roi_labels'])
    for key in ('rcnn_cls', 'rcnn_reg'):
        _close(out['roi_head_ret'][key], jax_out['roi_head_ret'][key], key)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jax_dets[key],
                                      err_msg=key)
    _close(dets['boxes'], jax_dets['boxes'], 'boxes')
    _close(dets['scores'], jax_dets['scores'], 'scores')
    assert int(dets['count'].min()) > 0


# ---------------------------------------------------------------- SECOND

def _second_cfg(final_zyx):
    """The tiny SECOND of ``tests/test_sparse_conv.py::
    test_second_end2end_tiny``."""
    cfg = zoo.tiny_pvrcnn_cfg(final_zyx)
    cfg = type(cfg)({k: cfg[k] for k in ('VFE', 'BACKBONE_3D', 'MAP_TO_BEV',
                                         'BACKBONE_2D', 'DENSE_HEAD')})
    cfg.NAME = 'SECONDNet'
    cfg.POST_PROCESSING = type(cfg)({
        'SCORE_THRESH': 0.1, 'NMS_CONFIG': {
            'MULTI_CLASSES_NMS': False, 'NMS_THRESH': 0.01,
            'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 16}})
    return cfg


def test_second_forward_and_post_processing_match_jax():
    batch, final_zyx = make_pv_batch(np.random.default_rng(0))
    batch = {k: np.asarray(v) for k, v in batch.items()
             if k not in ('gt_boxes', 'points')}
    final_zyx = tuple(int(v) for v in final_zyx)
    cfg = _second_cfg(final_zyx)
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=final_zyx)
    variables = _jax_vars(jm, batch)
    jax_out, jax_dets = _run(jm, variables, batch)
    model = build_detector(cfg, 1, device='cpu', voxel_size=VS,
                           point_cloud_range=PCR, final_grid_zyx=final_zyx)
    load_flax(model, variables)
    with torch.no_grad():
        out = model(_torch_batch(batch))
    dets = post_processing(out, cfg.POST_PROCESSING)
    for key in ('batch_cls_preds', 'batch_box_preds'):
        _close(out[key], jax_out[key], key)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jax_dets[key],
                                      err_msg=key)
    _close(dets['boxes'], jax_dets['boxes'], 'boxes')
    assert int(dets['count'].sum()) > 0


# ------------------------------------------------------------ from the config

@pytest.mark.parametrize('name', ['pv_rcnn', 'second'])
def test_geometry_from_the_config_matches_jax(name):
    """``build_detector_from_cfg`` derives JAX's geometry from DATA_CONFIG:
    range, voxel size, final grid (2, 200, 176), point channels, the
    anchor grid and the BEV widths."""
    path = f'tools/cfgs/kitti_models/{name}.yaml'
    jm = jax_build_from_cfg(jax_zoo.load_yaml_cfg(path))
    model = build_detector_from_cfg(zoo.load_yaml_cfg(path), device='cpu')
    assert model.map_to_bev_module.grid_zyx == tuple(jm.final_grid_zyx) == \
        (2, 200, 176)
    assert model.backbone_3d.conv_input[0].in_features == \
        27 * jm.num_point_features
    assert model.dense_head.anchors.shape == (200 * 176 * 6, 7)
    if name == 'pv_rcnn':
        np.testing.assert_array_equal(model.pfe.voxel_size,
                                      np.float32(jm.voxel_size))
        np.testing.assert_array_equal(model.pfe.pcr,
                                      np.float32(jm.point_cloud_range))
        assert model.pfe.num_point_features_before_fusion == \
            256 + 32 + 32 + 64 + 128 + 128
        assert model.roi_head.shared_fc_layer[0].in_features == 216 * 128


@pytest.mark.parametrize('path', [
    'kitti_models/PartA2_free.yaml', 'kitti_models/PartA2.yaml',
    'kitti_models/second_iou.yaml', 'kitti_models/AL.yaml',
    'kitti_models/second_multihead.yaml', 'kitti_models/centerpoint_iou.yaml',
    'nuscenes_models/cbgs_pp_multihead.yaml'])
def test_unported_detectors_raise_naming_item_f(path):
    cfg = zoo.load_yaml_cfg(f'tools/cfgs/{path}')
    with pytest.raises(NotImplementedError, match='item F'):
        build_detector_from_cfg(cfg, device='cpu')


def test_flax_to_torch_maps_every_pvrcnn_key(tiny):
    """Every leaf of the PVRCNN tree lands on a port key and back."""
    sd = flax_to_torch(tiny['variables'])
    assert set(sd) == set(tiny['model'].state_dict())
