"""The port's Voxel R-CNN against the JAX package on the CPU, serving and
training.

The tiny Voxel R-CNN (``zoo.tiny_voxelrcnn_cfg``, the copy of
``tests/test_voxelrcnn.py``'s config) serves the two frames of
``tests/test_pvrcnn.py``'s ``make_pv_batch`` with flax variables from a
fixed key, their kernels scaled by ``tests/test_torch_pvrcnn.py``'s
KERNEL_SCALES (the flax init fades through the sparse levels), through the
weight bridge. Ball-query, proposal and NMS indices must be identical;
floats stay within RTOL relative plus ATOL times the tensor's largest
entry, as PV-RCNN's tests hold them (fp32 sums in another order, ~1e-7
relative a layer over ~20 layers). One train step of the same model
(variables filled from numpy, gt boxes at its proposals) is held to JAX's
``make_train_step`` with the JAX package's RoI draws, at the tolerances of
``tests/test_torch_pvrcnn_train.py``. ``voxel_rcnn_car.yaml`` and the Waymo
``voxel_rcnn_with_centerhead_dyn_voxel.yaml`` run at full width on cropped
ranges in ``tests/test_torch_voxelrcnn_configs.py``. The last cases hold
the port's messages that name ROADMAP items.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import ops as jops
from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_torch import ops, zoo
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_pvrcnn import PCR, VS, make_pv_batch
from tests.test_torch_pointrcnn_train import _jax_draws
from tests.test_torch_pvrcnn import _close, _jax_vars, _run, _torch_batch
from tests.test_torch_pvrcnn_train import (_gt_near_proposals, _head_key,
                                           _one_step, _variables)
from tests.test_torch_pvrcnn_train import \
    test_train_step_gradients_match_jax as _pv_gradients
from tests.test_torch_pvrcnn_train import \
    test_train_step_updates_params_and_bn_stats_as_jax as _pv_updates

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

# Waymo's range cropped to a 25.6 m square: sparse grid (41, 256, 256) at
# Waymo's voxel size, final (2, 32, 32), so NUM_BEV_FEATURES stays 256
WAYMO_CROP = (-12.8, -12.8, -2, 12.8, 12.8, 4)
# the train step's pool: one slot a ball, radii that reach a voxel of
# make_pv_batch's coarse levels (3.2 m and 6.4 m voxels) from most grid
# points. XLA:CPU recomputes the pool's pre-max activations in its fused
# backward with other roundings, so under jit the max's gradient at the
# slots that repeat a ball's first hit leaves JAX's own eager gradient
# (mlps_in's and mlps_pos's, while mlps_out's agree); the pool's backward
# over four slots is held to eager JAX alone
# (test_roi_grid_pool_gradients_match_eager_jax)
TRAIN_POOL_RADII = {'x_conv3': 1.6, 'x_conv4': 4.8}
VOXEL_KEYS = {'loss', 'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
              'rpn_loss', 'rcnn_loss_cls', 'rcnn_loss_reg',
              'rcnn_loss_corner', 'rcnn_loss'}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_model(cfg, final_zyx):
    return jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                              voxel_size=VS, point_cloud_range=PCR,
                              final_grid_zyx=final_zyx)


@pytest.fixture(scope='module')
def tiny():
    batch, final_zyx = make_pv_batch(np.random.default_rng(0))
    batch = {k: np.asarray(v) for k, v in batch.items()
             if k != 'gt_boxes'}
    final_zyx = tuple(int(v) for v in final_zyx)
    cfg = zoo.tiny_voxelrcnn_cfg(final_zyx)
    jm = _jax_model(cfg, final_zyx)
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
            'final_zyx': final_zyx}


# ----------------------------------------------------------------- serving

def test_flax_to_torch_maps_every_voxelrcnn_key(tiny):
    """Every leaf of the VoxelRCNN tree lands on a port key and back; the
    pool's three MLPs of each source level where their rule places
    them."""
    variables = tiny['variables']
    sd = flax_to_torch(variables)
    assert set(sd) == set(tiny['model'].state_dict())
    roi = variables['params']['roi_head']
    for src in ('x_conv3', 'x_conv4'):
        for which in ('in', 'pos', 'out'):
            want = roi[f'{src}_{which}_0']['Dense_0']['kernel'].T
            got = sd[f'roi_head.roi_grid_pool_layers.{src}.mlps_{which}.0.'
                     '0.weight']
            np.testing.assert_array_equal(got.numpy(), want)


def test_roi_grid_pool_matches_jax(tiny):
    """The pool over the JAX package's RoIs and voxel features: each
    level's voxel centers (padded ones far away) and the grid points'
    ball-query indices identical, the pooled features within tolerance."""
    jm, jout = tiny['jm'], tiny['jax_out']
    keys = ('down3_coords', 'down3_valid', 'down4_coords', 'down4_valid')
    stage = {k: tiny['batch'][k] for k in keys}
    stage['multi_scale_3d_features'] = {
        k: jout['multi_scale_3d_features'][k] for k in ('x_conv3',
                                                        'x_conv4')}
    rois = np.asarray(jout['roi_head_ret']['rois'])
    want = jax.jit(lambda v, s, r: jm.apply(
        v, s, r, method=lambda m, b, rr: m.roi_head.roi_grid_pool(
            b, rr, False)))(tiny['variables'], stage, rois)
    head = tiny['model'].roi_head
    tstage = {k: _t(v) for k, v in stage.items()
              if k != 'multi_scale_3d_features'}
    tstage['multi_scale_3d_features'] = {
        k: _t(v) for k, v in stage['multi_scale_3d_features'].items()}
    from spsnet_tpu.models.roi_heads.pvrcnn_head import \
        roi_grid_points as jax_grid
    centers_grid = np.asarray(jax_grid(rois[..., :7], 3)).reshape(2, -1, 3)
    for name, level, ds in (('x_conv3', 'down3', 4), ('x_conv4', 'down4',
                                                      8)):
        centers = head.level_centers(tstage, name)
        jcenters = jm.apply(
            tiny['variables'], tiny['batch'][f'{level}_coords'], ds,
            method=lambda m, c, d: m.roi_head._voxel_centers(c, d))
        valid = tiny['batch'][f'{level}_valid']
        np.testing.assert_array_equal(centers.numpy()[valid],
                                      np.asarray(jcenters)[valid])
        assert (centers.numpy()[~valid] == 1e6).all()
        layer = head.roi_grid_pool_layers[name]
        got = ops.ball_query_multi(layer.radii, layer.nsamples, centers,
                                   _t(centers_grid))[0]
        jidx = jax.jit(lambda s, c, r=layer.radii[0],
                       n=layer.nsamples[0]: jops.ball_query(r, n, s, c))(
            centers.numpy(), centers_grid)
        np.testing.assert_array_equal(got.numpy(), jidx, err_msg=name)
    with torch.no_grad():
        pooled = head.roi_grid_pool(tstage, _t(rois))
    assert pooled.shape == want.shape == (2, 8, 27 * 16)
    _close(pooled, want, 'pooled voxel features')


def test_roi_grid_pool_gradients_match_eager_jax(tiny):
    """The pool in training mode (batch statistics) over the JAX package's
    RoIs: the gradients of a random projection of its output with
    respect to the voxel features, the RoIs (through the grid points) and
    every pool parameter equal JAX's eager ones within 1e-5 of each
    tensor's largest entry, the max's gradient split over the slots that
    repeat a ball's first hit as JAX splits it."""
    jm, jout = tiny['jm'], tiny['jax_out']
    stage = {k: tiny['batch'][k] for k in ('down3_coords', 'down3_valid',
                                             'down4_coords', 'down4_valid')}
    f3, f4 = (np.asarray(jout['multi_scale_3d_features'][k])
              for k in ('x_conv3', 'x_conv4'))
    rois = np.asarray(jout['roi_head_ret']['rois'])
    proj = np.random.default_rng(3).normal(size=(2, 8, 27 * 16)).astype(
        np.float32)
    params = tiny['variables']['params']
    other = {k: v for k, v in tiny['variables'].items() if k != 'params'}

    def jax_loss(params, f3, rois):
        s = dict(stage, multi_scale_3d_features={'x_conv3': f3,
                                                 'x_conv4': f4})
        pooled, _ = jm.apply(
            {'params': params, **other}, s, rois,
            method=lambda m, b, r: m.roi_head.roi_grid_pool(b, r, True),
            mutable=['batch_stats'])
        return (pooled * proj).sum()
    with jax.disable_jit():
        jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(params, f3, rois)
    want = flax_to_torch({'params': jax.tree_util.tree_map(np.asarray,
                                                           jgrads[0])})
    head = copy.deepcopy(tiny['model'].roi_head).train()
    t3, troi = _t(f3).requires_grad_(), _t(rois).requires_grad_()
    tstage = {k: _t(v) for k, v in stage.items()}
    tstage['multi_scale_3d_features'] = {'x_conv3': t3, 'x_conv4': _t(f4)}
    (head.roi_grid_pool(tstage, troi) * _t(proj)).sum().backward()
    pairs = [('x_conv3', t3.grad, jgrads[1]), ('rois', troi.grad, jgrads[2])]
    pairs += [(name, p.grad, want[f'roi_head.{name}'])
              for name, p in head.named_parameters()
              if name.startswith('roi_grid_pool_layers.x_conv3')]
    for name, got, w in pairs:
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        _close(got, w, name, rtol=0, atol=1e-5)


def test_roi_head_outputs_match_jax(tiny):
    """The proposals identical to their rounding (the same RoIs), their
    labels identical, the refinement and decoded boxes within
    tolerance."""
    ret, jret = tiny['out']['roi_head_ret'], tiny['jax_out']['roi_head_ret']
    _close(ret['rois'], jret['rois'], 'rois')
    for key in ('rcnn_cls', 'rcnn_reg', 'batch_box_preds'):
        _close(ret[key], jret[key], key)
    np.testing.assert_array_equal(tiny['out']['batch_roi_labels'].numpy(),
                                  tiny['jax_out']['batch_roi_labels'])
    assert tiny['out']['has_class_labels'] is False


def test_forward_and_post_processing_match_jax(tiny):
    dets, jdets = tiny['dets'], tiny['jax_dets']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    for key in ('boxes', 'scores'):
        _close(dets[key], jdets[key], key)
    assert int(dets['count'].sum()) > 0


# ---------------------------------------------------------------- training

@pytest.fixture(scope='module')
def train_step():
    """One ``adam_onecycle`` step of each package from the same variables
    (numpy-filled, ``_variables``) on ``make_pv_batch``'s frames with gt
    boxes at the proposals, the port drawing JAX's RoIs."""
    batch, final_zyx = make_pv_batch(np.random.default_rng(0))
    batch = {k: np.array(v) for k, v in batch.items()}
    final_zyx = tuple(int(v) for v in final_zyx)
    cfg = zoo.tiny_voxelrcnn_cfg(final_zyx)
    for name, radius in TRAIN_POOL_RADII.items():
        layer = cfg.ROI_HEAD.ROI_GRID_POOL.POOL_LAYERS[name]
        layer.POOL_RADIUS, layer.NSAMPLE = [radius], [1]
    jm = _jax_model(cfg, final_zyx)
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    model = load_flax(build_detector(cfg, 1, device='cpu', voxel_size=VS,
                                     point_cloud_range=PCR,
                                     final_grid_zyx=final_zyx), variables)
    batch = {k: _t(v) for k, v in batch.items()}
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    key = _head_key(jm, variables, 0)
    return _one_step(jm, variables, model, batch,
                     lambda g, B_, R, M, d: _jax_draws(key, B_, R, M))


def test_train_step_loss_terms_match_jax(train_step):
    """JAX's tb keys; every term within 1e-4 relative and non-zero (the
    RoI loss's regression and corner terms among them)."""
    jm = train_step['jax_metrics']
    assert set(jm) == VOXEL_KEYS
    for tb, loss in ((train_step['tb'], train_step['loss']),
                     (train_step['step_tb'], train_step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=1e-4)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=1e-4, err_msg=k)
    assert all(v > 0 for v in jm.values())


def test_train_step_gradients_match_jax(train_step):
    """Every parameter's gradient within 1e-3 of its largest entry (the
    PV-RCNN train step's GRAD_RTOL), none of them zero."""
    _pv_gradients('vrcnn', _Request(train_step))


def test_train_step_updates_params_and_bn_stats_as_jax(train_step):
    """Parameters within 1e-5 plus each entry's first-step slack, every BN
    running statistic (the pool's at flax's momentum 0.9, the sparse
    levels' over their padded rows) within 1e-5 + 1e-4 relative, every one
    moved; the six BEV BatchNorm layers among them."""
    _pv_updates('vrcnn', _Request(train_step))


class _Request:
    """Hands a step to the PV-RCNN train-step checks as their fixture."""

    def __init__(self, step):
        self.step = step

    def getfixturevalue(self, name):
        return self.step


# -------------------------------------------------- the ROADMAP pointers

def test_unported_samplers_and_dilated_groups_name_item_e():
    """Item E is ported: every sampler name of the JAX package's dispatch
    and dilated grouping build in the port, and a sampler name that
    neither package knows raises NotImplementedError naming it in both
    (``spsnet_tpu/models/sa_module.py:130-131``)."""
    from spsnet_tpu.models.sa_module import \
        SAModuleMSGWithSampling as JaxSAModule
    from spsnet_torch.models.sa_module import (SAModuleMSGWithSampling,
                                               _sampler_kind)
    for name in ('ctr_aware', 'sss_aware', 'S-FPS', 'D-FPS', 'F-FPS', 'FS',
                 'Rand', 'ds-FPS', 'ry_FPS'):
        _sampler_kind(name)
    SAModuleMSGWithSampling(1, [16], [-1], ['D-FPS'], [0.2, 0.4], [4, 8],
                            [[8], [8]], 3, dilated_group=True)
    xyz = np.random.default_rng(0).normal(size=(1, 32, 3)).astype(np.float32)
    kw = dict(npoint_list=[8], sample_range_list=[-1],
              sample_type_list=['Made-Up-FPS'], radii=[], nsamples=[],
              mlps=[], num_class=3)
    with pytest.raises(NotImplementedError, match='Made-Up-FPS'):
        JaxSAModule(**kw).init(jax.random.PRNGKey(0), xyz, xyz,
                               train=False)
    with pytest.raises(NotImplementedError, match='Made-Up-FPS'):
        SAModuleMSGWithSampling(3, **kw)

