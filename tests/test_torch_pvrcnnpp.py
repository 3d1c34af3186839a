"""The port's PV-RCNN++ against the JAX package on the CPU.

Each new module on numpy-seeded inputs against its JAX counterpart:
``grid_offsets`` and ``cube_query``, the SPC RoI mask and the sectorized
FPS, ``VectorPoolAggregation`` in each branch (local interpolation, voxel
average pool and random choice over the cube and the ball query) in eval
and in training (batch statistics and the running statistics after the
step), ``VectorPoolAggregationMSG``, the plain ``CenterHead`` (maps,
decode, targets, ``center_head_loss``) and the RoI head's VectorPool pool
and ``propose_and_assign``. Then the tiny PV-RCNN++
(``zoo.tiny_pvrcnnpp_cfg``, the config of ``tests/test_pvrcnn_plusplus.py``)
on ``make_pv_batch``'s two frames: the forward stage by stage and
``post_processing``, and one train step against JAX's ``make_train_step``
(losses, every gradient, the updated parameters and BN statistics, with
the JAX package's RoI draws). Both Waymo PV-RCNN++ configs at full width
are in ``tests/test_torch_pvrcnnpp_configs.py``. Flax variables reach the
port through the weight bridge. Indices must be identical; floats within
the tolerances of ``tests/test_torch_pvrcnn_train.py`` (RTOL relative plus
ATOL times each tensor's largest entry: fp32 sums in another order, grown
by BatchNorm's 1/std in training).
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.dense_heads import center_head as jax_center_head
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.model_utils import vector_pool as jax_vp
from spsnet_tpu.models.pfe import voxel_set_abstraction as jax_vsa
from spsnet_torch import zoo
from spsnet_torch.models import build_detector
from spsnet_torch.models.dense_heads.center_head import (CenterHead,
                                                         center_head_loss)
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.model_utils import vector_pool
from spsnet_torch.models.pfe import voxel_set_abstraction as vsa
from spsnet_torch.models.roi_heads import pointrcnn_head
from spsnet_torch.runtime.trainer import step_rngs
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_pvrcnn import PCR, VS, make_pv_batch
from tests.test_pvrcnn_plusplus import pvrcnnpp_tiny_cfg
from tests.test_torch_pointrcnn_train import _jax_draws
from tests.test_torch_pvrcnn_train import (ATOL, GRAD_RTOL, LOSS_RTOL, RTOL,
                                           STEP_ATOL, _first_step_slack,
                                           _gt_near_proposals, _head_key,
                                           _one_step)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def _fill(shapes, seed, scaled=()):
    """Flax variables of the tree ``shapes`` from numpy: He-normal kernels
    (the per-cell kernels over their input channels), N(0, 0.1) biases,
    BN scales in [0.5, 1.5], running statistics off their identity; the
    kernels and biases of the modules named in ``scaled`` (path prefix,
    factor) scaled."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            v = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        elif name == 'grouped_kernel':
            v = rng.normal(0, np.sqrt(2.0 / shape[1]), shape)
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, shape)
        keys = tuple(k.key for k in path)
        for prefix, factor in scaled:
            if keys[1:1 + len(prefix)] == prefix and name in ('kernel',
                                                              'bias'):
                v = v * factor
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


# ----------------------------------------------------- grid and cube query

def test_grid_offsets_match_jax():
    for nv, r in (([2, 2, 2], 0.2), ([3, 3, 3], 2.4), ([3, 2, 4], 0.8)):
        np.testing.assert_array_equal(vector_pool.grid_offsets(nv, r),
                                      jax_vp.grid_offsets(nv, r))


def test_cube_query_matches_jax():
    """First hits in index order under the Chebyshev distance, slots past
    the last hit the first hit, a centre with no hit all 0, padded
    supports at 1e6 never hit, more hits than slots."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-2, 2, (2, 300, 3)).astype(np.float32)
    xyz[:, 250:] = 1e6
    ctr = rng.uniform(-2.5, 2.5, (2, 90, 3)).astype(np.float32)
    ctr[:, :5] = 50.0                            # no hit
    ctr[:, 5:10] = xyz[:, :5]                    # centres on supports
    for r, ns in ((0.8, 8), (0.3, 4), (1.6, 32)):
        idx = vector_pool.cube_query(r, ns, _t(xyz), _t(ctr))
        jidx, jhit = jax.jit(lambda x, c, r=r, ns=ns: jax_vp.cube_query(
            r, ns, x, c))(xyz, ctr)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx),
                                      err_msg=f'r={r}')
    assert not np.asarray(jhit)[:, :5].any() and (idx[:, :5] == 0).all()
    assert (idx[:, 5:10, -1] > idx[:, 5:10, 0]).all()


# ------------------------------------------------------------ SPC sampling

def test_roi_mask_matches_jax():
    """Points near a RoI (within its half diagonal + the radius of its
    centre), padded RoIs ignored, and a frame of padding only falling back
    to point 0."""
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-20, 20, (3, 400, 3)).astype(np.float32)
    rois = np.zeros((3, 6, 7), np.float32)
    rois[:2, :4, 0:3] = rng.uniform(-15, 15, (2, 4, 3))
    rois[:2, :4, 3:6] = rng.uniform(1, 5, (2, 4, 3))
    rois[:2, :4, 6] = rng.uniform(-3, 3, (2, 4))
    want = jax.jit(lambda x, r: jax_vsa.sample_points_with_roi_mask(
        x, r, 1.6))(xyz, rois)
    got = vsa.sample_points_with_roi_mask(_t(xyz), _t(rois), 1.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:2].sum() > 10 and got[2].tolist() == [True] + [False] * 399


def _sectors_replayed(xyz, S):
    """The port's sectors, with JAX's where the two differ: each such
    point must lie within atan2's rounding slack of a sector edge."""
    got = vsa.point_sectors(_t(xyz), S).numpy()
    ang = np.asarray(jnp.arctan2(xyz[..., 1], xyz[..., 0]) + np.pi)
    want = np.clip(np.floor(ang / (2 * np.pi / S)), 0, S - 1).astype(
        np.int64)
    diff = got != want
    edge = np.abs(ang / (2 * np.pi / S) - np.round(ang / (2 * np.pi / S)))
    assert (edge[diff] < 1e-5).all(), \
        f'{int(diff.sum())} sectors differ away from an edge'
    return torch.from_numpy(want), int(diff.sum())


@pytest.mark.parametrize('case', ['random', 'quota_overflow',
                                  'empty_sector', 'small_sectors'])
def test_sector_fps_matches_jax(case):
    """Indices and valid slots identical to JAX's ``sector_fps_dense``:
    a random mask; quotas whose ceilings sum past K; a sector with no
    masked point; sectors with fewer points than K. Points that fall in
    another sector by atan2's rounding at an edge take JAX's sector (the
    count replayed is in the message)."""
    rng = np.random.default_rng(3)
    S, K, N = 6, 64, 512
    xyz = rng.uniform(-10, 10, (2, N, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, N)) < 0.5
    sector, replayed = _sectors_replayed(xyz, S)
    if case == 'quota_overflow':
        K = 61
    elif case == 'empty_sector':
        mask &= sector.numpy() != 3
    elif case == 'small_sectors':
        K = 200
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vsa, 'point_sectors', lambda x, s: sector)
        idx, valid, quota = vsa.sector_fps_dense(_t(xyz), _t(mask), K, S)
    jidx, jvalid = jax.jit(lambda x, m: jax_vsa.sector_fps_dense(
        x, m, K, S))(xyz, mask)
    msg = f'{case}: {replayed} sectors replayed at an edge'
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid),
                                  err_msg=msg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx), err_msg=msg)
    cnt = torch.stack([(_t(mask) & (sector == s)).sum(-1)
                       for s in range(S)], -1)
    if case == 'quota_overflow':
        assert (quota.sum(-1) > K).all() and valid.all()
    if case == 'empty_sector':
        assert (cnt[:, 3] == 0).all() and (quota[:, 3] == 0).all()
    if case == 'small_sectors':
        assert (cnt < K).all() and (quota <= cnt).all()


# ------------------------------------------------------------ VectorPool

def _vp_inputs(seed):
    """Supports in a 6 m cube (the last 40 padded at 1e6), their features,
    queries near and away from them, a mask of valid queries."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, (2, 300, 3)).astype(np.float32)
    xyz[:, 260:] = 1e6
    feats = rng.normal(size=(2, 300, 4)).astype(np.float32)
    new_xyz = rng.uniform(-3.5, 3.5, (2, 40, 3)).astype(np.float32)
    new_xyz[:, 30:] = 20.0                       # nothing near
    valid = rng.uniform(size=(2, 40)) < 0.8
    return xyz, feats, new_xyz, valid


VP_BRANCHES = {
    'interp': dict(local_aggregation_type='local_interpolation',
                   num_reduced_channels=2),
    'avg_cube': dict(local_aggregation_type='voxel_avg_pool',
                     neighbor_nsample=8, num_reduced_channels=4),
    'random_cube': dict(local_aggregation_type='voxel_random_choice',
                        neighbor_nsample=8, num_reduced_channels=2),
    'avg_ball': dict(local_aggregation_type='voxel_avg_pool',
                     neighbor_nsample=8, neighbor_type=1,
                     num_reduced_channels=2),
    'random_ball': dict(local_aggregation_type='voxel_random_choice',
                        neighbor_nsample=16, neighbor_type=1,
                        num_reduced_channels=4),
}


def _sub_state(variables, layer=False):
    """The port's state dict of a flax VectorPoolAggregationMSG (or, with
    ``layer``, of one VectorPoolAggregation), through the bridge as the
    raw-points source of the VSA."""
    prefix = 'pfe.SA_rawpoints.' + ('layers.0.' if layer else '')
    sd = flax_to_torch({coll: {'pfe': {'raw_vp': {'layer_0': tree}
                                       if layer else tree}}
                        for coll, tree in variables.items()})
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('branch', sorted(VP_BRANCHES))
def test_vector_pool_aggregation_matches_flax(branch, train):
    """One VectorPool group against flax in each branch, with the queries'
    valid mask: outputs within tolerance; in training (batch statistics)
    the running statistics after the forward too."""
    xyz, feats, new_xyz, valid = _vp_inputs(4)
    kw = dict(num_local_voxel=(3, 3, 2), max_neighbor_distance=0.8,
              post_mlps=(8, 8), num_channels_of_local_aggregation=8,
              **VP_BRANCHES[branch])
    jm = jax_vp.VectorPoolAggregation(**kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xyz,
                                            feats, new_xyz, train=False))
    variables = _fill(shapes, 5)
    args = (xyz, feats, new_xyz)
    if train:
        want, upd = jax.jit(lambda v: jm.apply(
            v, *args, train=True, new_valid=valid,
            mutable=['batch_stats']))(variables)
    else:
        want = jax.jit(lambda v: jm.apply(v, *args, train=False,
                                          new_valid=valid))(variables)
    model = vector_pool.VectorPoolAggregation(
        kw['num_local_voxel'], kw['max_neighbor_distance'], kw['post_mlps'],
        kw['num_reduced_channels'], 8, kw['local_aggregation_type'],
        kw.get('neighbor_nsample', -1), kw.get('neighbor_type', 0))
    model.load_state_dict(_sub_state(variables, layer=True))
    model.train(train)
    got = model(_t(xyz), _t(feats), _t(new_xyz), _t(valid))
    _close(got, want, f'{branch} train={train}')
    assert (got[~_t(valid)] == 0).all() and got.abs().max() > 0
    if train:
        sd = _sub_state({'params': variables['params'], **upd}, layer=True)
        for name, w in sd.items():
            if name.endswith(('running_mean', 'running_var')):
                _close(model.state_dict()[name], w, name)


def test_vector_pool_msg_matches_flax():
    """Two groups (interpolation at 0.4 and 0.8 m), their concatenation
    with the queries' xyz and the MSG post MLP, in training."""
    xyz, feats, new_xyz, valid = _vp_inputs(6)
    cfg = pvrcnnpp_tiny_cfg((2, 2, 2)).PFE.SA_LAYER.raw_points
    jm = jax_vp.VectorPoolAggregationMSG(model_cfg=StaticConfig(cfg),
                                         input_channels=4)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xyz,
                                            feats, new_xyz, train=False))
    variables = _fill(shapes, 7)
    want, _ = jax.jit(lambda v: jm.apply(v, xyz, feats, new_xyz, train=True,
                                         new_valid=valid,
                                         mutable=['batch_stats']))(variables)
    model = vector_pool.VectorPoolAggregationMSG(
        zoo.tiny_pvrcnnpp_cfg((2, 2, 2)).PFE.SA_LAYER.raw_points, 4)
    model.load_state_dict(_sub_state(variables))
    got = model.train()(_t(xyz), _t(feats), _t(new_xyz), _t(valid))
    _close(got, want, 'MSG')
    assert got.shape == (2, 40, 16) and (got[~_t(valid)] == 0).all()


# ---------------------------------------------------------- the CenterHead

def _center_cfg():
    cfg = zoo.tiny_pvrcnnpp_cfg((2, 2, 2)).DENSE_HEAD
    cfg.POST_CONFIG.MAX_OBJ_PER_SAMPLE = 40
    return cfg


def test_center_head_matches_jax():
    """The plain CenterHead (3 classes, a 12 x 10 map at stride 8) in
    training: the maps, the heatmap targets, centre pixels and masks, the
    decoded top-40 boxes and one-hot scores within tolerance, the top-40
    (pixel, class) picks identical, and ``center_head_loss``."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, 10, 8)).astype(np.float32)
    gt = np.zeros((2, 5, 8), np.float32)
    gt[:, :4, 0] = rng.uniform(0, 70, (2, 4))
    gt[:, :4, 1] = rng.uniform(-40, 40, (2, 4))
    gt[:, :4, 3:6] = rng.uniform(1, 4, (2, 4, 3))
    gt[:, :4, 6] = rng.uniform(-3, 3, (2, 4))
    gt[:, :4, 7] = [1, 2, 3, 1]
    cfg = _center_cfg()
    geo = dict(voxel_size=(0.8, 1.0, 0.1),
               point_cloud_range=(0, -40, -3, 64, 56, 1))
    jm = jax_center_head.CenterHead(model_cfg=StaticConfig(cfg),
                                    num_class=3, grid_size=(80, 96, 40),
                                    **geo)
    jb = {'spatial_features_2d': x, 'gt_boxes': gt}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb))
    variables = _fill(shapes, 9, scaled=((('center',), 0.1),
                                         (('dim',), 0.1)))
    jout = jax.jit(lambda v: jm.apply(v, jb, train=True))(variables)
    jloss, jtb = jax_center_head.center_head_loss(
        jout['center_head_ret'], JaxEDict(cfg.LOSS_CONFIG))
    head = CenterHead(cfg, 3, 8, **geo)
    sd = flax_to_torch({'params': {'dense_head': variables['params']}})
    head.load_state_dict({k[len('dense_head.'):]: v for k, v in sd.items()})
    out = head.train()({'spatial_features_2d': _t(x.transpose(0, 3, 1, 2)),
                        'gt_boxes': _t(gt)})
    ret, jret = out['center_head_ret'], jout['center_head_ret']
    for k in ('heatmap', 'center', 'center_z', 'dim', 'rot'):
        _close(ret[k], np.asarray(jret[k]).transpose(0, 3, 1, 2), k)
    # the port's Gaussians take their exp in float64 rounded once, jitted
    # JAX's in fp32: within 2e-6 relative (tests/test_torch_centerpoint.py)
    hm = ret['heatmap_target'].detach().numpy()
    jhm = np.asarray(jret['heatmap_target'])
    np.testing.assert_allclose(hm, jhm, rtol=2e-6, atol=0)
    np.testing.assert_array_equal(hm == 1.0, jhm == 1.0)
    for k in ('inds', 'masks'):
        np.testing.assert_array_equal(ret[k].detach().numpy(),
                                      np.asarray(jret[k]),
                                      err_msg=k)
    _close(ret['box_targets'], jret['box_targets'], 'box targets')
    np.testing.assert_array_equal(out['batch_cls_preds'].detach().numpy() > 0,
                                  np.asarray(jout['batch_cls_preds']) > 0)
    _close(out['batch_cls_preds'], jout['batch_cls_preds'], 'scores')
    _close(out['batch_box_preds'], jout['batch_box_preds'], 'boxes')
    assert out['cls_preds_normalized'] is True
    loss, tb = center_head_loss(ret, cfg.LOSS_CONFIG)
    assert set(tb) == set(jtb)
    for k in tb:
        np.testing.assert_allclose(float(tb[k].detach()), float(jtb[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert int(ret['masks'].sum()) == 8 and float(tb['loc_loss']) > 0


# ------------------------------------------------- the tiny PV-RCNN++

def _pp_variables(jm, batch, seed=4):
    """``_fill`` of the tiny PV-RCNN++ tree; the CenterHead's centre and
    size maps at 0.1 (sizes are exp of the 'dim' map) and the RoI head's
    box output at 1e-2."""
    shapes = jax.eval_shape(lambda b: jm.init(
        {'params': jax.random.PRNGKey(0),
         'roi_sampling': jax.random.PRNGKey(1)}, b, train=False), batch)
    return _fill(shapes, seed, scaled=(
        (('dense_head', 'center'), 0.1), (('dense_head', 'dim'), 0.1),
        (('roi_head', 'reg_layers', 'Dense_0'), 1e-2)))


@pytest.fixture(scope='module')
def tiny():
    batch, final_zyx = make_pv_batch(np.random.default_rng(0))
    batch = {k: np.array(v) for k, v in batch.items()}
    final_zyx = tuple(int(v) for v in final_zyx)
    cfg = zoo.tiny_pvrcnnpp_cfg(final_zyx)
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=final_zyx)
    serve = {k: v for k, v in batch.items() if k != 'gt_boxes'}
    variables = _pp_variables(jm, serve)
    model = build_detector(cfg, 1, device='cpu', voxel_size=VS,
                           point_cloud_range=PCR, final_grid_zyx=final_zyx)
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    post = StaticConfig(cfg.POST_PROCESSING)
    jout, jdets = jax.jit(lambda v, b: (lambda o: (o, jax_post_processing(
        o, post)))(jm.apply(v, b, train=False)))(variables, serve)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in serve.items()})
    return {'jm': jm, 'variables': variables, 'model': model, 'cfg': cfg,
            'batch': batch, 'out': out, 'jout': jout, 'jdets': jdets,
            'dets': post_processing(out, cfg.POST_PROCESSING)}


def test_flax_to_torch_maps_every_pvrcnnpp_key(tiny):
    """Every leaf of the PVRCNNPlusPlus tree (the plain CenterHead, the
    VSA's three VectorPool sources and the RoI pool's, each group's
    per-cell kernel, agg_bn, post and MSG post layers) lands on a port key
    and back."""
    sd = flax_to_torch(tiny['variables'])
    assert set(sd) == set(tiny['model'].state_dict())
    for key in ('dense_head.shared.weight', 'dense_head.rot.bias',
                'pfe.SA_rawpoints.layers.1.grouped_kernel',
                'pfe.SA_layers.x_conv4.layers.0.agg_bn.running_var',
                'pfe.SA_layers.x_conv3.layers.0.post_mlps.4.weight',
                'pfe.SA_rawpoints.msg_post_mlps.1.running_mean',
                'roi_head.roi_grid_pool_layer.layers.1.post_mlps.3.weight'):
        assert key in sd, key
    np.testing.assert_array_equal(
        sd['pfe.SA_rawpoints.layers.1.grouped_kernel'].numpy(),
        tiny['variables']['params']['pfe']['raw_vp']['layer_1'][
            'grouped_kernel'])


@pytest.mark.parametrize('where', ['layer', 'msg'])
def test_pvrcnnpp_tree_raises_on_unmapped_flax_keys(tiny, where):
    variables = copy.deepcopy(tiny['variables'])
    vp = variables['params']['roi_head']['vp_pool']
    if where == 'layer':
        vp['layer_0']['post_9x'] = {'kernel': np.zeros((2, 2), np.float32)}
    else:
        vp['msg_post_bn_x'] = {'scale': np.zeros(2, np.float32)}
    with pytest.raises(KeyError, match='unmapped flax leaf'):
        flax_to_torch(variables)


def test_tiny_forward_matches_jax_stage_by_stage(tiny):
    """The CenterHead's maps and top-K boxes, the RoIs (identical labels),
    the SPC keypoints (identical, invalid slots at 1e6) and their
    features, the point head, the RoI head's outputs."""
    out, jout = tiny['out'], tiny['jout']
    for k in ('heatmap', 'center', 'dim', 'rot'):
        _close(out['center_head_ret'][k], np.asarray(
            jout['center_head_ret'][k]).transpose(0, 3, 1, 2), k)
    _close(out['rois'], jout['roi_head_ret']['rois'], 'rois')
    np.testing.assert_array_equal(out['point_valid'].numpy(),
                                  jout['point_valid'])
    np.testing.assert_array_equal(out['point_coords'].numpy(),
                                  jout['point_coords'])
    assert out['point_valid'].any() and not out['point_valid'].all()
    for k in ('point_features_before_fusion', 'point_features',
              'point_cls_scores'):
        _close(out[k], jout[k], k)
    for k in ('rcnn_cls', 'rcnn_reg', 'batch_box_preds'):
        _close(out['roi_head_ret'][k], jout['roi_head_ret'][k], k)
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jout['batch_roi_labels'])


def test_tiny_post_processing_matches_jax(tiny):
    dets, jdets = tiny['dets'], tiny['jdets']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    for key in ('boxes', 'scores'):
        _close(dets[key], jdets[key], key)
    assert int(dets['count'].sum()) > 0


def test_roi_grid_vector_pool_matches_jax(tiny):
    """The RoI head's VectorPool pool (random choice over the cube query
    of the keypoints, invalid ones at 1e6) over JAX's RoIs and keypoint
    features, flattened channel-major."""
    jm, jout = tiny['jm'], tiny['jout']
    stage = {k: jout[k] for k in ('point_coords', 'point_features',
                                  'point_cls_scores', 'point_valid')}
    rois = jout['roi_head_ret']['rois']
    want = jax.jit(lambda v, s, r: jm.apply(
        v, s, r, method=lambda m, b, rr: m.roi_head.roi_grid_pool(
            b, rr, False)))(tiny['variables'], stage, rois)
    with torch.no_grad():
        got = tiny['model'].roi_head.roi_grid_pool(
            {k: _t(v) for k, v in stage.items()}, _t(rois))
    assert got.shape == want.shape == (2, 4, 16 * 27)
    _close(got, want, 'pooled RoI-grid features')


def test_propose_and_assign_matches_jax(tiny):
    """The proposals before the keypoints, over JAX's CenterHead boxes:
    the eval NMS at TEST, and in training the NMS at TRAIN and the sampled
    RoIs and their targets with JAX's draws."""
    jm, variables = tiny['jm'], tiny['variables']
    serve = {k: v for k, v in tiny['batch'].items() if k != 'gt_boxes'}

    def stage_one(m, b):
        for module in (m.vfe, m.backbone_3d, m.map_to_bev_module,
                       m.backbone_2d, m.dense_head):
            b = module(b, train=False)
        return {k: b[k] for k in ('batch_box_preds', 'batch_cls_preds')}
    stage = jax.jit(lambda v, b: jm.apply(v, b, method=stage_one))(
        variables, serve)
    stage['gt_boxes'] = tiny['batch']['gt_boxes']
    rngs = {'roi_sampling': jax.random.fold_in(jax.random.PRNGKey(17), 0)}
    want = {train: jax.jit(lambda v, s, train=train: jm.apply(
        v, dict(s, cls_preds_normalized=True),
        method=lambda m, b: m.roi_head.propose_and_assign(b, train),
        rngs=rngs))(variables, stage) for train in (False, True)}
    key = _head_key(jm, variables, 0)
    head = copy.deepcopy(tiny['model'].roi_head)
    port_stage = dict({k: _t(v) for k, v in stage.items()},
                      cls_preds_normalized=True)
    with torch.no_grad():
        ev = head.eval().propose_and_assign(port_stage)
    _close(ev['rois'], want[False]['rois'], 'eval rois')
    _close(ev['rois'], tiny['out']['rois'], 'the forward\'s rois')
    assert ev['targets'] is None and ev['roi_valid'].any()
    own = pointrcnn_head.draw_roi_sampling
    pointrcnn_head.draw_roi_sampling = \
        lambda g, B_, R, M, d: _jax_draws(key, B_, R, M)
    try:
        got = head.train().propose_and_assign(dict(port_stage,
                                                   rngs=step_rngs(0)))
    finally:
        pointrcnn_head.draw_roi_sampling = own
    _close(got['rois'], want[True]['rois'], 'sampled rois')
    np.testing.assert_array_equal(got['roi_labels'].numpy(),
                                  want[True]['roi_labels'])
    t, jt = got['targets'], want[True]['targets']
    for field in ('gt_of_rois_src', 'reg_valid_mask'):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(jt, field)))
    assert got['rois'].shape[1] == 16


# keypoints of the train step: every slot valid (each frame has more
# points near its RoIs than that), see ``pp_step``
TRAIN_KEYPOINTS = 32


@pytest.fixture(scope='module')
def pp_step(tiny):
    """One train step of each package on the tiny PV-RCNN++ from the same
    variables (gt boxes of ``make_pv_batch`` and three boxes near the
    CenterHead's top proposals, so that RoIs reach the regression
    threshold), with JAX's RoI draws of step 0.

    The step samples TRAIN_KEYPOINTS keypoints, all of them valid. With
    invalid keypoints the VSA's VectorPool BatchNorm would take rows that
    neither package computes to any precision: the invalid keypoints and
    the levels' padded voxels both sit at 1e6, where the three-NN's
    |a|^2 + |b|^2 - 2ab distances round at ~3e12 (ROADMAP Queue 3); the
    invalid rows' part in the statistics is held in
    ``test_vector_pool_aggregation_matches_flax`` (masked queries at finite
    coordinates)."""
    cfg = copy.deepcopy(tiny['cfg'])
    cfg.PFE.NUM_KEYPOINTS = TRAIN_KEYPOINTS
    final_zyx = tuple(tiny['model'].map_to_bev_module.grid_zyx)
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=final_zyx)
    model = load_flax(build_detector(cfg, 1, device='cpu', voxel_size=VS,
                                     point_cloud_range=PCR,
                                     final_grid_zyx=final_zyx),
                      tiny['variables'])
    batch = {k: _t(v) for k, v in tiny['batch'].items()}
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    key = _head_key(jm, tiny['variables'], 0)

    def draws(g, B_, R, M, d):
        return _jax_draws(key, B_, R, M)
    step = _one_step(jm, tiny['variables'], model, batch, draws)
    own = pointrcnn_head.draw_roi_sampling
    pointrcnn_head.draw_roi_sampling = draws
    try:
        with torch.no_grad():
            out = copy.deepcopy(model).train()(dict(batch,
                                                     rngs=step_rngs(0)))
    finally:
        pointrcnn_head.draw_roi_sampling = own
    step['point_valid'] = out['point_valid']
    return step


def test_tiny_train_step_loss_terms_match_jax(pp_step):
    """JAX's tb keys (the CenterHead's, the point head's, the RoI head's),
    every term within LOSS_RTOL and non-zero."""
    assert pp_step['point_valid'].all()
    jm = pp_step['jax_metrics']
    assert set(jm) == {'loss', 'hm_loss', 'loc_loss', 'center_loss',
                       'point_loss_cls', 'rcnn_loss_cls', 'rcnn_loss_reg',
                       'rcnn_loss_corner', 'rcnn_loss'}
    for tb, loss in ((pp_step['tb'], pp_step['loss']),
                     (pp_step['step_tb'], pp_step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert all(v > 0 for v in jm.values())


def test_tiny_train_step_gradients_match_jax(pp_step):
    """Every parameter's gradient (the per-cell kernels among them) within
    GRAD_RTOL of its largest entry, none of them zero."""
    want = {k: v for k, v in pp_step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(pp_step['grads']) == set(want)
    assert sum(k.endswith('grouped_kernel') for k in want) == 6
    for name, g in pp_step['grads'].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_tiny_train_step_updates_params_and_bn_stats_as_jax(pp_step):
    """Parameters after the step within STEP_ATOL plus each entry's
    first-step slack; every BN's running statistics (the VectorPool ones
    at flax's momentum 0.99) within STEP_ATOL + RTOL; all moved."""
    state, want, init = pp_step['state'], pp_step['jax_state'], \
        pp_step['init']
    opt = pp_step['opt']
    slack = _first_step_slack(pp_step['grads'], pp_step['jax_grads'],
                              opt.lr_fn(0), opt.max_norm)
    n_vp = 0
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        diff = (state[name] - w).abs()
        bound = STEP_ATOL + slack.get(name, torch.zeros(()))
        if name.endswith(('running_mean', 'running_var')):
            bound = bound + RTOL * w.abs()
            n_vp += '.layers.' in name or 'msg_post' in name
        assert (diff <= bound).all(), (
            f'{name}: {int((diff > bound).sum())} entries beyond the bound, '
            f'largest difference {float(diff.max()):.3e}')
        assert not torch.equal(state[name], init[name]), f'{name} unchanged'
    assert n_vp == 2 * (6 * 3 + 4) and opt.count == 1


# ------------------------------------------- the configs a user loads
