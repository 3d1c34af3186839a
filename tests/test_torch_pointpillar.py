"""The port's pillar detectors (PointPillar, CenterPoint over pillars and
over dynamic pillars) against the JAX package on the CPU, serving and
training.

The host steps first: ``voxel_batch`` on pointpillar.yaml against JAX's
``DataProcessor``, ``sample_points`` and the placeholder step under the
same seed. Then the modules one by one on seeded numpy inputs:
``PillarVFE`` (eval, and train with its BatchNorm statistics),
``PointPillarScatter`` with invalid pillars, ``DynamicPillarVFE``
(features, canvas, points on pillar boundaries and out of range) and the
max's gradient where slots tie. Then the tiny PointPillar
(``zoo.tiny_pointpillar_cfg``), the tiny pillar CenterPoint
(``zoo.tiny_centerpoint_cfg`` with Waymo's two-layer PFN) and its dynamic
twin on a cropped range, their flax variables filled from numpy through
the weight bridge: a forward with ``post_processing`` (their train step:
``tests/test_torch_pointpillar_train.py``). Index outputs
(pillar ids, NMS keeps, labels) must be identical, host arrays bit for
bit; floats within the tolerances stated below.

Under jit XLA divides by a constant as a product with its reciprocal, so
JAX's jitted DynamicPillarVFE floors (x - start) * (1 / size) where the
reference and the port floor the true quotient: a point on (or an ulp
from) a pillar boundary can land one pillar off, ~1e-5 of uniform points.
The module tests hold the port to JAX run eagerly (true quotients) on
points at the boundaries, and count the points where the jitted form
departs; the model tests, which jit JAX, check that their points hold
none.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.data.processor.data_processor import DataProcessor
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.map_to_bev.pointpillar_scatter import \
    PointPillarScatter as JaxScatter
from spsnet_tpu.models.vfe.vfe_modules import \
    DynamicPillarVFE as JaxDynamicVFE
from spsnet_tpu.models.vfe.vfe_modules import PillarVFE as JaxPillarVFE
from spsnet_torch import zoo
from spsnet_torch.config import EDict
from spsnet_torch.data.processor import (
    sample_points, transform_points_to_voxels_placeholder, voxel_batch)
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.map_to_bev import PointPillarScatter
from spsnet_torch.models.vfe import DynamicPillarVFE, PillarVFE
from spsnet_torch.ops.boxes import boxes_iou_bev_fast, topk_desc
from spsnet_torch.utils.synthetic import (synthetic_scan_batch,
                                          synthetic_scene_batch)
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_pvrcnn import _Holder
from tests.test_torch_pvrcnn_train import _np_tree, _variables

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

# the tiny models' geometry (tests/test_pointpillar.py's): a 25.6 m
# square of 0.4 m pillars, a 64 x 64 map
PCR = (0, -12.8, -3, 25.6, 12.8, 1)
VS = (0.4, 0.4, 4)
B = 2
CLASSES = ['Car', 'Pedestrian', 'Cyclist']
# features, predictions, loss terms: fp32 sums in another order (XLA:CPU
# against the CPU BLAS and oneDNN), ~1e-7 relative a layer, grown by
# BatchNorm's 1/std in training; relative plus a share of each tensor's
# largest entry, as the voxel detectors' tests hold them
RTOL, ATOL = 1e-4, 1e-4
# gradients against the largest entry of each layer's; parameters and BN
# statistics after one step (Adam's first update: _first_step_slack)
GRAD_RTOL, STEP_ATOL = 1e-3, 1e-5
# NMS: boxes ~1e-6 apart give IoUs ~1e-6 apart, and KITTI's NMS_THRESH of
# 0.01 meets pairs that straddle it (0.0100034 on the port's boxes,
# 0.0099998 on JAX's, the tiny dynamic model)
NMS_SLACK = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _nhwc(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _data_cfg(n_voxels=800, max_points=8, dynamic=False, n_points=1500):
    steps = [{'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': list(VS),
              'MAX_POINTS_PER_VOXEL': max_points,
              'MAX_NUMBER_OF_VOXELS': {'train': n_voxels,
                                       'test': n_voxels}}]
    if dynamic:
        steps = [{'NAME': 'sample_points',
                  'NUM_POINTS': {'train': n_points, 'test': n_points}},
                 {'NAME': 'transform_points_to_voxels_placeholder',
                  'VOXEL_SIZE': list(VS)}]
    return EDict({'POINT_CLOUD_RANGE': list(PCR), 'DATA_PROCESSOR': steps})


def _fill(shapes, seed):
    """Numpy variables of an ``eval_shape`` tree: He-normal kernels,
    N(0, 0.1) biases and means, BN scales in [0.5, 1.5], variances in
    [0.5, 2]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            v = rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-1])), s.shape)
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, s.shape)
        else:
            v = rng.normal(0, 0.1, s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def hold_nms(out, dets, jdets, post):
    """``post_processing``'s detections against JAX's: each frame's kept
    indices identical, or JAX's list a greedy NMS of the port's own IoUs
    (``boxes_iou_bev_fast`` over the port's boxes in the port's score
    order) in which the pairs within NMS_SLACK of the threshold may fall
    either way; labels of JAX's kept boxes the port's labels there. Returns
    the number of decisions taken otherwise than the port's (at most 2)."""
    nms = post.NMS_CONFIG
    thresh = float(nms.NMS_THRESH)
    post_max = int(jdets['indices'].shape[1])
    scores = torch.sigmoid(out['batch_cls_preds']).amax(-1)
    labels = torch.sigmoid(out['batch_cls_preds']).argmax(-1) + 1
    flips = 0
    for b in range(scores.shape[0]):
        want = [int(i) for i in np.asarray(jdets['indices'][b]) if i >= 0]
        np.testing.assert_array_equal(
            labels[b, want].numpy(),
            np.asarray(jdets['labels'][b])[:len(want)])
        got = [int(i) for i in dets['indices'][b] if i >= 0]
        if got == want:
            continue
        valid = scores[b] > float(post.SCORE_THRESH)
        _, order = topk_desc(torch.where(valid, scores[b], -torch.inf),
                             min(int(nms.NMS_PRE_MAXSIZE), len(valid)))
        order = order[valid[order]]
        boxes = out['batch_box_preds'][b, order]
        iou = boxes_iou_bev_fast(boxes, boxes).numpy()
        kept, wanted = [], set(want)
        for r, i in enumerate(order.tolist()):
            if len(kept) == post_max:
                break
            over = iou[kept, r]
            if i in wanted:
                assert (over <= thresh + NMS_SLACK).all(), (b, i)
                flips += int((over > thresh).any())
                kept.append(r)
            else:
                assert (over > thresh - NMS_SLACK).any(), (b, i)
                flips += int(not (over > thresh).any())
        assert [int(order[r]) for r in kept] == want
    assert flips <= 2
    return flips


def _recip_departures(points, pcr=PCR, vs=VS):
    """How many of ``points``' (x, y) pillar indices the jitted JAX form
    (the offset times the fp32 reciprocal of the size) floors otherwise
    than the true quotient."""
    pts = np.asarray(points, np.float32)
    n = 0
    for k in range(2):
        d = pts[..., k] - np.float32(pcr[k])
        s = np.float32(vs[k])
        n += int((np.floor(d / s) != np.floor(d * (np.float32(1) / s))).sum())
    return n


# ------------------------------------------------------------- host side

def _jax_processor(data_cfg, training):
    steps = [p for p in data_cfg.DATA_PROCESSOR
             if p.NAME in ('sample_points', 'transform_points_to_voxels',
                           'transform_points_to_voxels_placeholder')]
    return DataProcessor(steps, data_cfg.POINT_CLOUD_RANGE, training)


@pytest.mark.parametrize('seed,mode,cap', [(0, 'test', None),
                                           (1, 'train', 700)])
def test_pillars_are_identical_to_jax(seed, mode, cap):
    """``voxel_batch`` on pointpillar.yaml (no sparse plan: the batch
    holds the points, pillars, coordinates, counts and valid mask only)
    gives JAX's ``DataProcessor`` arrays bit for bit; ``cap`` lowers
    MAX_NUMBER_OF_VOXELS so that it cuts."""
    jcfg = jax_zoo.load_yaml_cfg('tools/cfgs/kitti_models/pointpillar.yaml')
    cfg = zoo.pointpillar_kitti_cfg()
    if cap is not None:
        for c in (jcfg, cfg):
            step = [p for p in c.DATA_CONFIG.DATA_PROCESSOR
                    if p.NAME == 'transform_points_to_voxels'][0]
            step.MAX_NUMBER_OF_VOXELS[mode] = cap
    scans = synthetic_scan_batch(seed, B, 4096)
    got = voxel_batch(scans, cfg.DATA_CONFIG, mode)
    assert set(got) == {'points', 'voxels', 'voxel_coords',
                        'voxel_num_points', 'voxel_valid'}
    assert got['voxels'].shape[2] == 32
    proc = _jax_processor(jcfg.DATA_CONFIG, mode == 'train')
    for b in range(B):
        want = proc.forward({'points': scans[b].copy()})
        assert set(want) == set(got)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key][b], value, err_msg=key)
            assert got[key].dtype == value.dtype, key
    assert (got['voxel_coords'][..., 0] == 0).all()
    if cap is not None:
        assert got['voxel_valid'].sum(1).max() == cap


def _far_scan(rng, n, far):
    """(n, 5) points, ``far`` of them 40-60 m out, the rest within 30 m."""
    r = np.concatenate([rng.uniform(2, 30, n - far), rng.uniform(40, 60, far)])
    a = rng.uniform(-np.pi, np.pi, n)
    pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-2, 2, n),
                    rng.uniform(0, 1, n), rng.uniform(0, 1, n)], 1)
    return pts[rng.permutation(n)].astype(np.float32)


@pytest.mark.parametrize('case,n,far,num', [
    ('near_draws', 3000, 400, 1000), ('far_exceed', 3000, 1500, 1000),
    ('pad', 700, 50, 1000), ('keep', 900, 100, -1)])
def test_sample_points_and_placeholder_match_jax(case, n, far, num):
    """``sample_points`` with ``RandomState(s)`` gives JAX's
    ``sample_points`` after ``np.random.seed(s)`` bit for bit in each
    branch (near points drawn beside every far one, all drawn when the
    far ones exceed N, padding by draws with replacement, -1 keeps the
    scan), and the placeholder step keeps the points and records JAX's
    grid."""
    rng = np.random.default_rng(n + far)
    scan = _far_scan(rng, n, far)
    data_cfg = EDict({'POINT_CLOUD_RANGE': [-51.2, -51.2, -5, 51.2, 51.2, 3],
                      'DATA_PROCESSOR': [
                          {'NAME': 'sample_points',
                           'NUM_POINTS': {'train': num, 'test': num}},
                          {'NAME': 'transform_points_to_voxels_placeholder',
                           'VOXEL_SIZE': [0.2, 0.2, 8.0]}]})
    proc = _jax_processor(JaxEDict(copy.deepcopy(data_cfg)), False)
    np.random.seed(7)
    want = proc.forward({'points': scan.copy()})['points']
    got = sample_points(scan, num, np.random.RandomState(7))
    np.testing.assert_array_equal(got, want)
    assert len(got) == (n if num == -1 else num)
    np.testing.assert_array_equal(
        transform_points_to_voxels_placeholder(data_cfg.POINT_CLOUD_RANGE,
                                               [0.2, 0.2, 8.0]),
        proc.grid_size)
    batch = voxel_batch(scan[None], data_cfg, rng=np.random.RandomState(7))
    assert set(batch) == {'points'}
    np.testing.assert_array_equal(batch['points'][0], want)


def test_voxel_batch_needs_a_generator_to_sample():
    with pytest.raises(ValueError, match='RandomState'):
        voxel_batch(np.zeros((1, 10, 4), np.float32),
                    _data_cfg(dynamic=True))


# ---------------------------------------------------------------- modules

def _vfe_cfg(filters, abs_xyz=True, distance=False):
    return EDict({'NAME': 'PillarVFE', 'WITH_DISTANCE': distance,
                  'USE_ABSLOTE_XYZ': abs_xyz, 'USE_NORM': True,
                  'NUM_FILTERS': list(filters)})


def _pillar_batch(seed, duplicates=True):
    """The tiny config's pillars of B scans with clusters (partly filled
    and full pillars, padded ones past the count); with ``duplicates``,
    every pillar's second point a copy of its first, so that the max ties
    between real slots too."""
    pts, _ = synthetic_scene_batch(seed, B, 1500, pc_range=PCR,
                                   n_clusters=6)
    batch = voxel_batch(pts, _data_cfg())
    if duplicates:
        two = batch['voxel_num_points'] >= 2
        batch['voxels'][two, 1] = batch['voxels'][two, 0]
    return batch


def _pillar_vfe_pair(cfg, batch, seed, channels=4):
    jm = JaxPillarVFE(model_cfg=StaticConfig(JaxEDict(copy.deepcopy(cfg))),
                      num_point_features=channels, voxel_size=VS,
                      point_cloud_range=PCR)
    variables = _fill(jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), b, train=False), batch),
        seed)
    port = _Holder(vfe=PillarVFE(cfg, channels, VS, PCR))
    load_flax(port, {c: {'vfe': t} for c, t in variables.items()})
    return jm, variables, port


@pytest.mark.parametrize('mode,abs_xyz,distance', [
    ('eval', True, False), ('train', True, False), ('eval', False, True)])
def test_pillar_vfe_matches_jax(mode, abs_xyz, distance):
    """PillarVFE with a two-layer PFN (Waymo's [64, 64] topology, here
    [16, 16]) on partly filled, full and padded pillars: the features
    within tolerance; in training its BatchNorms' statistics over all B x V
    x P rows, the padded pillars and slots included, land on flax's
    running statistics. The USE_ABSLOTE_XYZ / WITH_DISTANCE variant takes
    the point's channels past xyz and the norm."""
    train = mode == 'train'
    cfg = _vfe_cfg([16, 16], abs_xyz, distance)
    batch = _pillar_batch(10)
    assert (~batch['voxel_valid']).any()
    assert ((batch['voxel_num_points'] > 0) &
            (batch['voxel_num_points'] < 8)).any()
    jm, variables, port = _pillar_vfe_pair(cfg, batch, 11)
    jout, mut = jax.jit(lambda v, b: jm.apply(
        v, b, train=train, mutable=['batch_stats']))(variables, batch)
    port.train(train)
    with torch.no_grad():
        out = port.vfe({k: _t(v) for k, v in batch.items()})
    _close(out['pillar_features'], jout['pillar_features'], 'features')
    assert out['pillar_features'].shape == (B, 800, 16)
    assert port.vfe.pfn_layers[0].linear.in_features == \
        (10 if abs_xyz else 7) + distance
    if train:
        want = flax_to_torch({c: {'vfe': _np_tree(t)} for c, t in (
            ('params', variables['params']),
            ('batch_stats', mut['batch_stats']))})
        for name, w in want.items():
            if name.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(
                    port.state_dict()[name].numpy(), w.numpy(), rtol=RTOL,
                    atol=STEP_ATOL, err_msg=name)


def test_pillar_scatter_matches_jax():
    """The scatter of (B, V, C) features with invalid pillars (their
    coordinates pointing at occupied cells) into the (B, C, ny, nx) map:
    bit for bit JAX's NHWC canvas, zero where no pillar."""
    batch = _pillar_batch(12, duplicates=False)
    valid = batch['voxel_valid']
    coords = batch['voxel_coords'].copy()
    coords[~valid] = coords[0, 0]
    feats = np.random.default_rng(13).normal(
        size=valid.shape + (8,)).astype(np.float32)
    jb = {'pillar_features': feats, 'voxel_coords': coords,
          'voxel_valid': valid}
    want = JaxScatter(model_cfg=None, grid_size=(64, 64, 1)).apply(
        {}, jb)['spatial_features']
    got = PointPillarScatter((64, 64, 1))({k: _t(v) for k, v in jb.items()})
    np.testing.assert_array_equal(got['spatial_features'].numpy(),
                                  _nhwc(want))
    occupied = (got['spatial_features'] != 0).any(1)
    assert int(occupied.sum()) == int(valid.sum())


def _dynamic_points(seed, n=1200):
    """B scans in and around the tiny range: clusters, points exactly on
    pillar boundaries (offsets k * 0.4 in fp32, k from 1: an ulp below 0
    is a subnormal, which XLA:CPU flushes to zero) and an ulp from them,
    and points past each edge of the range."""
    rng = np.random.default_rng(seed)
    pts, _ = synthetic_scene_batch(seed, B, n, pc_range=PCR, n_clusters=6)
    k = rng.integers(1, 64, (B, 200))
    edge = (np.float32(PCR[0]) + k.astype(np.float32) * np.float32(VS[0]))
    pts[:, :200, 0] = edge
    pts[:, 200:300, 0] = np.nextafter(edge[:, :100], np.float32(-1e9))
    pts[:, 300:400, 1] = (np.float32(PCR[1]) + k[:, :100].astype(
        np.float32) * np.float32(VS[1]))
    pts[:, 400:420, 0] = rng.uniform(-3, -0.01, (B, 20))
    pts[:, 420:440, 1] = rng.uniform(12.81, 15, (B, 20))
    pts[:, 440:450, 0] = np.float32(PCR[3])
    return pts.astype(np.float32)


def _dynamic_pair(cfg, batch, seed):
    jm = JaxDynamicVFE(model_cfg=StaticConfig(JaxEDict(copy.deepcopy(cfg))),
                       num_point_features=4, voxel_size=VS,
                       point_cloud_range=PCR)
    variables = _fill(jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), b, train=False), batch),
        seed)
    port = _Holder(vfe=DynamicPillarVFE(cfg, 4, VS, PCR))
    load_flax(port, {c: {'vfe': t} for c, t in variables.items()})
    return jm, variables, port


@pytest.mark.parametrize('mode', ['eval', 'train', 'points_valid'])
def test_dynamic_pillar_vfe_matches_jax(mode):
    """DynamicPillarVFE on points on and an ulp from pillar boundaries and
    out of range (and, in one case, a 'points_valid' mask): each point's
    pillar id is the floor of the true quotient (numpy's, bit for bit),
    the occupied cells those of the ids, and the canvas within tolerance
    of JAX run eagerly (true quotients); in training the BatchNorms'
    statistics over all N point slots land on flax's. The jitted JAX form
    floors the reciprocal product and departs at some of these points."""
    train = mode == 'train'
    cfg = EDict({'NAME': 'DynamicPillarVFE', 'USE_NORM': True,
                 'NUM_FILTERS': [16, 16]})
    pts = _dynamic_points(20)
    batch = {'points': pts}
    if mode == 'points_valid':
        batch['points_valid'] = np.random.default_rng(21).uniform(
            size=pts.shape[:2]) > 0.2
    jm, variables, port = _dynamic_pair(cfg, batch, 22)
    with jax.disable_jit():
        jout, mut = jm.apply(variables, batch, train=train,
                             mutable=['batch_stats'])
    port.train(train)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        out = port.vfe(tb)
        ix, iy, flat, mask = port.vfe.pillar_index(tb)
    want_ix = np.floor((pts[..., 0] - np.float32(PCR[0])) /
                       np.float32(VS[0])).astype(np.int64)
    want_iy = np.floor((pts[..., 1] - np.float32(PCR[1])) /
                       np.float32(VS[1])).astype(np.int64)
    np.testing.assert_array_equal(ix.numpy(), want_ix)
    np.testing.assert_array_equal(iy.numpy(), want_iy)
    inside = (want_ix >= 0) & (want_ix < 64) & (want_iy >= 0) & \
        (want_iy < 64)
    if 'points_valid' in batch:
        inside &= batch['points_valid']
    np.testing.assert_array_equal(mask.numpy(), inside)
    assert 0 < (~inside).sum() < inside.sum()
    canvas = out['spatial_features']
    assert canvas.shape == (B, 16, 64, 64)
    _close(canvas, _nhwc(jout['spatial_features']), 'canvas')
    cells = np.zeros((B, 64 * 64 + 1), bool)
    cells[np.arange(B)[:, None], flat.numpy()] = True
    occupied = (canvas != 0).any(1).reshape(B, -1).numpy()
    assert not (occupied & ~cells[:, :-1]).any()
    assert _recip_departures(pts[inside]) > 0
    if train:
        want = flax_to_torch({c: {'vfe': _np_tree(t)} for c, t in (
            ('params', variables['params']),
            ('batch_stats', mut['batch_stats']))})
        stats = [n for n in want if n.endswith(('running_mean',
                                                'running_var'))]
        assert len(stats) == 4
        for name in stats:
            np.testing.assert_allclose(
                port.state_dict()[name].numpy(), want[name].numpy(),
                rtol=RTOL, atol=STEP_ATOL, err_msg=name)


@pytest.mark.parametrize('which', ['pillar', 'dynamic'])
def test_max_gradient_splits_ties_as_jax(which):
    """The gradient of a weighted sum of the features through a two-layer
    PFN in training, where slots tie at each pillar's max (duplicate
    points, and in PillarVFE the padded slots' f(0)): the gradient at the
    input points and every parameter's within GRAD_RTOL of its largest
    entry of JAX's, which splits a max's gradient evenly among tied
    entries (``jnp.max``, ``.at[].max``). Tied rows are identical rows, so
    the parameters' gradients sum over them whatever the split; the
    points' gradients show it: a max that gave all of it to one of two
    duplicate points would not agree."""
    if which == 'pillar':
        cfg = _vfe_cfg([16, 16])
        batch = _pillar_batch(30)
        jm, variables, port = _pillar_vfe_pair(cfg, batch, 31)
        key, src = 'pillar_features', 'voxels'
    else:
        cfg = EDict({'NAME': 'DynamicPillarVFE', 'USE_NORM': True,
                     'NUM_FILTERS': [16, 16]})
        pts, _ = synthetic_scene_batch(32, B, 1200, pc_range=PCR,
                                       n_clusters=6)
        pts[:, 1::2] = pts[:, 0::2]
        batch = {'points': pts}
        assert _recip_departures(pts) == 0
        jm, variables, port = _dynamic_pair(cfg, batch, 33)
        key, src = 'spatial_features', 'points'

    def apply(p, x):
        return jm.apply({'params': p,
                         'batch_stats': variables['batch_stats']},
                        dict(batch, **{src: x}), train=True,
                        mutable=['batch_stats'])[0][key]
    shape = jax.eval_shape(apply, variables['params'], batch[src]).shape
    w = np.random.default_rng(34).normal(size=shape).astype(np.float32)
    grads, x_grad = jax.jit(jax.grad(lambda p, x: (apply(p, x) * w).sum(),
                                     argnums=(0, 1)))(variables['params'],
                                                      batch[src])
    port.train()
    x = _t(batch[src]).requires_grad_()
    out = port.vfe(dict({k: _t(v) for k, v in batch.items()}, **{src: x}))
    if which == 'dynamic':
        w = _nhwc(w)
    (out[key] * _t(w)).sum().backward()
    want = {n: g for n, g in flax_to_torch(
        {'params': {'vfe': _np_tree(grads)}}).items()
        if not n.endswith('num_batches_tracked')}
    want[src] = _t(x_grad)
    got = dict({n: p.grad for n, p in port.named_parameters()},
               **{src: x.grad})
    assert set(got) == set(want) and len(got) == 7
    for name, g in got.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


# ------------------------------------------------------- the tiny models

def _tiny(which):
    """The tiny model config: PointPillar, the pillar CenterPoint (the
    plain CenterHead) with Waymo's two-layer PFN, or its dynamic twin."""
    if which == 'pointpillar':
        return zoo.tiny_pointpillar_cfg()
    cfg = zoo.tiny_centerpoint_cfg()
    cfg.VFE.NUM_FILTERS = [32, 32]
    if which == 'dynamic':
        cfg.VFE.NAME = 'DynPillarVFE'
    return cfg


def _gt(rng, n):
    """(n, 8) gt boxes of the three KITTI classes at their anchors' sizes
    and heights, inside the tiny range."""
    cls = rng.integers(1, 4, n)
    sizes = np.float32([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73],
                        [1.76, 0.6, 1.73]])[cls - 1]
    boxes = np.zeros((n, 8), np.float32)
    boxes[:, 0] = rng.uniform(2, 23, n)
    boxes[:, 1] = rng.uniform(-10, 10, n)
    boxes[:, 3:6] = sizes * rng.uniform(0.9, 1.1, (n, 3))
    boxes[:, 2] = np.where(cls == 1, -1.78, -0.6) + boxes[:, 5] / 2
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 7] = cls
    return boxes


def _batch(which, seed, train=False):
    """The port's host batch of B scans with clusters (and gt boxes, 6
    and 4 a frame, in training) for the tiny model."""
    pts, _ = synthetic_scene_batch(seed, B, 1800, pc_range=PCR,
                                   n_clusters=6)
    rng = np.random.default_rng(seed)
    gt = [_gt(rng, 6), _gt(rng, 4)] if train else None
    return voxel_batch(pts, _data_cfg(dynamic=which == 'dynamic'),
                       mode='train' if train else 'test', gt_boxes=gt,
                       rng=np.random.RandomState(seed))


def _models(which, batch):
    """Both packages' tiny models with the same numpy-filled variables
    (``_variables``: the anchor head's box layer at 0.05; the plain
    CenterHead's centre and size maps at 0.1, sizes being exp of the
    latter), and the variables."""
    cfg = _tiny(which)
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=3,
                            voxel_size=VS, point_cloud_range=PCR,
                            class_names=CLASSES)
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    if which != 'pointpillar':
        for name in ('center', 'dim'):
            layer = variables['params']['dense_head'][name]
            layer['kernel'] = layer['kernel'] * np.float32(0.1)
    model = build_detector(cfg, 3, device='cpu', voxel_size=VS,
                           point_cloud_range=PCR, class_names=CLASSES)
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    return jm, variables, load_flax(model, variables)


WHICH = ['pointpillar', 'centerpoint', 'dynamic']


@pytest.mark.parametrize('which', WHICH)
def test_tiny_model_serves_as_jax(which):
    """The tiny model's BEV map, head outputs and ``post_processing``'s
    detections: indices, counts and labels identical, boxes and scores
    within tolerance, or the NMS held as ``hold_nms`` holds it where a
    pair straddles the threshold; detections in every frame."""
    batch = _batch(which, 40)
    if which == 'dynamic':
        assert _recip_departures(batch['points']) == 0
    jm, variables, model = _models(which, batch)
    post = _tiny(which).POST_PROCESSING
    jout, jdets = jax.jit(lambda v, b: (lambda o: (
        o, jax_post_processing(o, StaticConfig(post))))(
            jm.apply(v, b, train=False)))(variables, batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    _close(out['spatial_features'], _nhwc(jout['spatial_features']),
           'spatial_features')
    _close(out['spatial_features_2d'], _nhwc(jout['spatial_features_2d']),
           'spatial_features_2d')
    for k in ('batch_box_preds', 'batch_cls_preds'):
        _close(out[k], jout[k], k)
    dets = post_processing(out, post)
    if hold_nms(out, dets, jdets, post) == 0:
        for key in ('indices', 'count', 'labels'):
            np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                          err_msg=key)
        _close(dets['boxes'], jdets['boxes'], 'boxes')
        _close(dets['scores'], jdets['scores'], 'scores')
    assert int(dets['count'].min()) > 0


@pytest.mark.parametrize('which', WHICH)
def test_flax_to_torch_maps_every_pillar_key(which):
    """Every leaf of the tiny model's tree lands on a port key and back,
    the PFN's where its rule puts it (PillarVFE's pfn_{i}/Dense_0 and
    BatchNorm_0, DynamicPillarVFE's pfn{i}_fc and pfn{i}_bn); a PFN layer
    of no known kind raises."""
    batch = _batch(which, 42)
    _, variables, model = _models(which, batch)
    sd = flax_to_torch(variables)
    assert set(sd) == set(model.state_dict())
    vfe = variables['params']['vfe']
    if which == 'dynamic':
        kernel, stats = vfe['pfn1_fc']['kernel'], \
            variables['batch_stats']['vfe']['pfn1_bn']['var']
    else:
        layer = vfe['pfn_0']
        kernel, stats = layer['Dense_0']['kernel'], variables[
            'batch_stats']['vfe']['pfn_0']['BatchNorm_0']['var']
    i = 1 if which == 'dynamic' else 0
    np.testing.assert_array_equal(
        sd[f'vfe.pfn_layers.{i}.linear.weight'].numpy(), kernel.T)
    np.testing.assert_array_equal(
        sd[f'vfe.pfn_layers.{i}.norm.running_var'].numpy(), stats)
    vfe['pfn_extra'] = {'kernel': np.ones((3, 3), np.float32)}
    with pytest.raises(KeyError, match='unmapped'):
        flax_to_torch(variables)

