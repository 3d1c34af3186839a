"""The port's CenterPoint (voxel trunk, residual sparse backbone,
multi-group CenterHeadIoU) against the JAX package on the CPU, serving and
training.

The modules one by one on seeded numpy inputs: the CenterNet radius, the
heatmap and centre targets of 8- and 10-wide gt boxes, the focal loss and
``VoxelResBackBone8x`` (eval and train mode, its BatchNorm over the padded
rows). Then the tiny voxel CenterPoint (``zoo.tiny_centerpoint_voxel_cfg``:
two head groups, the velocity and IoU maps, a rectifier) on frames of the
port's host voxels and plan over a cropped KITTI range, its flax variables
filled from numpy through the weight bridge: serving under both decode
protocols, and one ``adam_onecycle`` step with 10-wide gt against JAX's
``make_train_step``. Index outputs (top-k picks, NMS keeps, labels, valid
masks, target pixels) must be identical; floats within the tolerances
stated below. The train step: ``tests/test_torch_centerpoint_train.py``.
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
from spsnet_tpu.models.backbones_3d.spconv_backbone import \
    VoxelResBackBone8x as JaxResBackBone
from spsnet_tpu.models import vfe as jax_vfe
from spsnet_tpu.models.dense_heads import center_head as jax_center
from spsnet_tpu.models.detectors import centerpoint as jax_centerpoint
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_torch import zoo
from spsnet_torch.config import EDict
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.data.processor.sparse_plan import plan_final_grid
from spsnet_torch.data.processor.voxelize import sparse_grid_zyx
from spsnet_torch.models import build_detector
from spsnet_torch.models.backbones_3d.spconv_backbone import \
    VoxelResBackBone8x
from spsnet_torch.models.dense_heads import center_head
from spsnet_torch.models.detectors.detector3d import (head_detections,
                                                      post_processing)
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_pvrcnn import _Holder
from tests.test_torch_pvrcnn_train import (_clustered_frames, _np_tree,
                                           _variables)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

CLASSES = ['Car', 'Pedestrian', 'Cyclist']
# the tiny model's geometry: a cropped KITTI range at 0.1 m voxels, sparse
# grid (41, 128, 128), final (2, 16, 16): a 16 x 16 BEV map at stride 8
PCR = (0, -6.4, -3, 12.8, 6.4, 1)
VS = (0.1, 0.1, 0.1)
FINAL = tuple(plan_final_grid(sparse_grid_zyx(PCR, VS)))
B = 2
# features, predictions, loss terms: fp32 sums in another order (XLA:CPU
# against the CPU BLAS and oneDNN), ~1e-7 relative a layer, grown by
# BatchNorm's 1/std in training; relative plus a share of each tensor's
# largest entry, as the PV-RCNN tests hold them
RTOL, ATOL = 1e-4, 1e-4
# each gradient against its largest entry; parameters and BN statistics
# after one step (Adam's first update: see _first_step_slack)
GRAD_RTOL, STEP_ATOL = 1e-3, 1e-5
# the heatmap's Gaussians: the port's exp is the correctly rounded one,
# XLA:CPU's an ulp off it on some arguments, so the port is held to eager
# JAX within HM_ULP; under jit XLA:CPU also rounds the Gaussian's quotient
# otherwise, an ulp of an argument down to -9, which exp turns into ~9
# ulps of the result, and HM_JIT_RTOL (~17 ulps) bounds it. The residual
# coder's log, cos and sin differ by an ulp
HM_ULP, HM_JIT_RTOL, TARGET_ATOL = 1, 2e-6, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _gt(rng, n, width=8, pad=2, classes=(1, 2, 3)):
    """(n, width) gt boxes in PCR (headings in [-pi, pi], sizes of the
    three KITTI classes, velocities in [-3, 3] when 10 wide), the last
    ``pad`` rows zero; one box is pushed past the range's edge, where its
    centre clips to the map's border."""
    boxes = np.zeros((n, width), np.float32)
    k = n - pad
    boxes[:k, 0] = rng.uniform(0.5, 12.5, k)
    boxes[:k, 1] = rng.uniform(-6, 6, k)
    boxes[:k, 2] = rng.uniform(-2, 0, k)
    boxes[:k, 3:6] = rng.uniform([0.5, 0.5, 1.4], [4.2, 1.8, 1.8], (k, 3))
    boxes[:k, 6] = rng.uniform(-np.pi, np.pi, k)
    boxes[0, 0] = 13.5
    if width == 10:
        boxes[:k, 7:9] = rng.uniform(-3, 3, (k, 2))
    boxes[:k, -1] = rng.choice(classes, k)
    return boxes


# ---------------------------------------------------------- heatmap targets

def test_gaussian_radius_matches_jax():
    """The radius of boxes 0.3-40 pixels wide (the reference's /2 quirk on
    the third root), within 1e-5 relative; its integer part identical."""
    rng = np.random.default_rng(0)
    h, w = (rng.uniform(0.3, 40, 2000).astype(np.float32) for _ in range(2))
    got = center_head.gaussian_radius(_t(h), _t(w), 0.1).numpy()
    want = np.asarray(jax.jit(lambda a, b: jax_center.gaussian_radius(
        a, b, 0.1))(h, w))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got.astype(np.int32),
                                  want.astype(np.int32))


@pytest.mark.parametrize('width', [8, 10])
def test_center_targets_match_jax(width):
    """Both frames' targets of one head group (3 classes, a 16 x 16 map)
    against eager JAX: the heatmap within HM_ULP and its peaks (1.0)
    identical, the centre pixels, masks and raw gt identical, the
    regression targets (with the velocity when 10 wide) within
    TARGET_ATOL; padding rows and slots past T empty."""
    rng = np.random.default_rng(width)
    gt = np.stack([_gt(rng, 9, width), _gt(rng, 9, width, pad=4)])
    gt[1, 2] = gt[1, 1]                       # two boxes on one pixel
    args = (3, (16, 16), 8, np.float32(VS), np.float32(PCR))
    kw = {'num_max_objs': 12, 'gaussian_overlap': 0.1, 'min_radius': 2}
    got = center_head.assign_center_targets(_t(gt), *args, **kw)
    with jax.disable_jit():
        want = [jax_center.assign_center_targets(jnp.asarray(g), *args,
                                                 **kw) for g in gt]
    want = [np.stack(t) for t in zip(*want)]
    hm, boxes, inds, mask, gt7 = (t.numpy() for t in got)
    assert hm.shape == (B, 3, 16, 16) and boxes.shape == (B, 12, width)
    np.testing.assert_array_max_ulp(hm, want[0], maxulp=HM_ULP)
    np.testing.assert_array_equal(hm == 1.0, want[0] == 1.0)
    assert (hm == 1.0).sum() >= 10
    np.testing.assert_array_equal(inds, want[2])
    np.testing.assert_array_equal(mask, want[3])
    np.testing.assert_array_equal(gt7, want[4])
    np.testing.assert_allclose(boxes, want[1], rtol=0, atol=TARGET_ATOL)
    assert mask[0, :7].all() and not mask[0, 7:].any()
    assert not mask[1, 5:].any()


def test_gaussian_is_the_same_bits_on_every_device():
    """The Gaussian of every (squared distance, radius) a heatmap meets
    (radii 2-12) is exp in float64 rounded once to fp32: the bits of
    numpy's float64 exp, which the card's float64 exp gives too."""
    r = np.arange(2, 13, dtype=np.float32)[:, None]
    d2 = np.arange(0, 2 * 12 ** 2 + 1, dtype=np.float32)[None]
    sigma = (2 * r + 1) / np.float32(6.0)
    arg = -d2 / (np.float32(2) * sigma ** 2)
    want = np.exp(arg.astype(np.float64)).astype(np.float32)
    got = center_head.gaussian(_t(d2), _t(sigma)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gaussian_focal_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(-2, 2, (B, 3, 16, 16)).astype(np.float32)
    gt = rng.uniform(0, 0.9, (B, 3, 16, 16)).astype(np.float32)
    gt[0, 1, 3, 4] = gt[1, 2, 9, 9] = 1.0
    got = float(center_head.gaussian_focal_loss(_t(pred), _t(gt)))
    want = float(jax.jit(jax_center.gaussian_focal_loss)(pred, gt))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------ residual backbone

@pytest.mark.parametrize('train', [False, True])
def test_res_backbone_matches_jax(train):
    """VoxelResBackBone8x on clustered frames with padded rows at every
    level, numpy-filled weights: every level within tolerance; in
    training the BatchNorms' statistics take the padded rows, which carry
    BN(0) through the residual adds as in the JAX package, and the running
    statistics land within STEP_ATOL + RTOL of flax's."""
    inp = _clustered_frames(np.random.default_rng(5))
    valid = inp['voxel_valid']
    inp['voxel_features'] = (np.random.default_rng(6).normal(
        size=valid.shape + (4,)) * valid[..., None]).astype(np.float32)
    assert all((~inp[k]).any() for k in ('voxel_valid', 'down2_valid',
                                         'down3_valid', 'down4_valid'))
    jm = JaxResBackBone(model_cfg=StaticConfig(JaxEDict({})),
                        input_channels=4)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False), inp)
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-1])),
                                 s.shape) if p[-1].key == 'kernel' else
                      rng.uniform(0.5, 1.5, s.shape)
                      if p[-1].key in ('scale', 'var') else
                      rng.normal(0, 0.1, s.shape)).astype(np.float32),
        dict(shapes))
    jout, mut = jax.jit(lambda v, b: jm.apply(
        v, b, train=train, mutable=['batch_stats']))(variables, inp)
    port = _Holder(backbone_3d=VoxelResBackBone8x(4))
    load_flax(port, {c: {'backbone_3d': t} for c, t in variables.items()})
    port.train(train)
    with torch.no_grad():
        out = port.backbone_3d({k: _t(v) for k, v in inp.items()})
    for name in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
        _close(out['multi_scale_3d_features'][name],
               jout['multi_scale_3d_features'][name], name)
    _close(out['encoded_voxel_features'], jout['encoded_voxel_features'],
           'encoded_voxel_features')
    assert out['multi_scale_3d_features']['x_conv4'].shape[-1] == 128
    if train:
        want = flax_to_torch({
            'params': {'backbone_3d': variables['params']},
            'batch_stats': {'backbone_3d': _np_tree(mut['batch_stats'])}})
        state = port.state_dict()
        stats = [n for n in want if n.endswith(('running_mean',
                                                'running_var'))]
        assert len(stats) == 2 * (1 + 8 * 2 + 3 + 1)
        for name in stats:
            np.testing.assert_allclose(state[name].numpy(),
                                       want[name].numpy(), rtol=RTOL,
                                       atol=STEP_ATOL, err_msg=name)


# ------------------------------------------------- the tiny CenterPoint

def _scenes(seed, width=8, n_points=1536):
    """B scenes in PCR: scans with clusters and (T, width) gt boxes of
    the three classes (velocities when 10 wide), the second frame with
    two boxes fewer."""
    pts, _ = synthetic_scene_batch(seed, B, n_points, pc_range=PCR,
                                   n_clusters=6)
    rng = np.random.default_rng(seed)
    return pts, [_gt(rng, 8, width, pad=0), _gt(rng, 6, width, pad=0)]


def _data_cfg(n_voxels=700):
    return EDict({
        'POINT_CLOUD_RANGE': list(PCR),
        'DATA_PROCESSOR': [
            {'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': list(VS),
             'MAX_POINTS_PER_VOXEL': 5,
             'MAX_NUMBER_OF_VOXELS': {'train': n_voxels, 'test': n_voxels}},
            {'NAME': 'build_sparse_conv_plan'}]})


def _cp_variables(jm, batch):
    """``_variables``' numpy fill of the CenterPoint tree, the head maps'
    output convs at 0.1 (sizes are exp of the 'dim' map) and the heatmap
    bias at the head's -2.19."""
    variables = _variables(jm, batch)
    for g, head in variables['params']['dense_head'].items():
        if not g.startswith('head_'):
            continue
        for name, layer in head.items():
            if name.endswith('_out') and name != 'hm_out':
                layer['kernel'] = layer['kernel'] * np.float32(0.1)
        head['hm_out']['bias'] = np.full_like(head['hm_out']['bias'], -2.19)
    return variables


def _mean_vfe_only(name, model_cfg, num_point_features, **geometry):
    """``build_vfe`` for the JAX package's CenterPoint: it hands every VFE
    the voxel size and range, which its MeanVFE does not take (a
    TypeError; the pillar VFEs do), so its voxel trunk builds only with
    them dropped. Nothing else of the JAX model changes."""
    kw = {} if name == 'MeanVFE' else geometry
    return jax_vfe.build_vfe(name, model_cfg=model_cfg,
                             num_point_features=num_point_features, **kw)


@pytest.fixture(autouse=True, scope='module')
def jax_centerpoint_builds():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_centerpoint, 'build_vfe', _mean_vfe_only)
        yield


def _models(cfg, batch):
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=3,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=FINAL, class_names=CLASSES)
    variables = _cp_variables(jm, {k: v for k, v in batch.items()
                                   if k != 'gt_boxes'})
    model = load_flax(build_detector(cfg, 3, device='cpu', voxel_size=VS,
                                     point_cloud_range=PCR,
                                     final_grid_zyx=FINAL,
                                     class_names=CLASSES), variables)
    return jm, variables, model


def _detections(boxes, scores, labels, valid, segments):
    """Each frame's kept detections of each NMS segment (a group's, or a
    class's, output slots), in slot order: (labels, boxes, scores)."""
    out = []
    for b in range(valid.shape[0]):
        for seg in np.split(np.arange(valid.shape[1]), segments):
            keep = seg[valid[b, seg]]
            out.append((labels[b, keep], boxes[b, keep], scores[b, keep]))
    return out


def hold_detections(out, jout, segments):
    """The head's detections against JAX's, segment by segment: labels
    identical, boxes and scores within tolerance. The JAX package's
    sort-free BEV IoU of two identical boxes is degenerate (their edges
    coincide, and it lands anywhere from 0 to far above 1), so its NMS may
    keep a box equal to one it kept before, which the port's
    (twice the overlap, above any threshold) and the reference's (1)
    suppress; the upstream decode makes such pairs, one pixel's box under
    two classes. Such repeats are dropped from JAX's lists before the
    comparison; returns how many."""
    got = _detections(*(out[k].detach().numpy() for k in HEAD_OUT),
                      segments)
    want = _detections(*(np.asarray(jout[k]) for k in HEAD_OUT), segments)
    repeats = 0
    for (gl, gb, gs), (wl, wb, ws) in zip(got, want):
        first = [i for i in range(len(wb))
                 if not any((wb[i] == wb[j]).all() for j in range(i))]
        repeats += len(wb) - len(first)
        np.testing.assert_array_equal(gl, wl[first])
        _close(gb, wb[first], 'boxes')
        _close(gs, ws[first], 'scores')
    return repeats


HEAD_OUT = ('final_boxes', 'final_scores', 'final_labels', 'final_valid')


def _serve(cfg, batch):
    """Each package's eval forward of the tiny CenterPoint on ``batch``."""
    jm, variables, model = _models(cfg, batch)
    jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    return model, variables, out, jout


@pytest.fixture(scope='module')
def serve_batch():
    pts, _ = _scenes(40)
    return voxel_batch(pts, _data_cfg())


_SERVED = {}


def _served(protocol, batch):
    """``_serve`` of ``_protocol(protocol)`` on ``serve_batch``, once a
    module (a test that edits the variables takes a copy)."""
    if protocol not in _SERVED:
        _SERVED[protocol] = _serve(_protocol(protocol), batch)
    return _SERVED[protocol]


def _protocol(name):
    cfg = zoo.tiny_centerpoint_voxel_cfg(FINAL)
    head = cfg.DENSE_HEAD
    if name != 'upstream':
        head.NAME = 'CenterHeadIoU'
        head.POST_PROCESSING.NMS_CONFIG.NMS_NAME = name
    return cfg


@pytest.mark.parametrize('protocol', ['upstream', 'class_specific_nms',
                                      'agnostic_nms'])
def test_tiny_centerpoint_serving_matches_jax(serve_batch, protocol):
    """The tiny CenterPoint's maps within tolerance and its detections:
    the upstream CenterHead decode (the top 48 (pixel, class) pairs of
    each group, agnostic NMS a group), and the CenterHeadIoU decode (the
    top 48 pixels by their best class) with class-specific or agnostic
    NMS; labels, valid masks and counts identical, boxes and the
    rectified scores within tolerance; both groups and every class
    detect."""
    model, variables, out, jout = _served(protocol, serve_batch)
    for g, (pd, jpd) in enumerate(zip(out['center_head_iou_ret'][
            'pred_dicts'], jout['center_head_iou_ret']['pred_dicts'])):
        assert set(pd) == set(jpd) == {'hm', 'center', 'center_z', 'dim',
                                       'rot', 'vel', 'iou'}
        for k in pd:
            _close(pd[k], np.asarray(jpd[k]).transpose(0, 3, 1, 2),
                   f'head {g} {k}')
    # NMS segments of 12 slots (NMS_POST_MAXSIZE): one a group, or one a
    # class with class-specific NMS
    n_segments = 3 if protocol == 'class_specific_nms' else 2
    hold_detections(out, jout, [12 * k for k in range(1, n_segments)])
    dets = head_detections(out)
    assert out['cls_preds_normalized'] is True
    assert dets['boxes'].shape == (B, 12 * n_segments, 9)
    head = model.dense_head
    labels = set(dets['labels'][dets['valid']].tolist())
    assert 1 in labels and labels & {2, 3}
    assert head.class_ids_each_head == ((0,), (1, 2))


def test_flax_to_torch_maps_every_centerpoint_key(serve_batch):
    """Every leaf of the tiny CenterPoint tree (the residual blocks, the
    shared conv, both groups' SeparateHeads in sorted order) lands on a
    port key and back; one group's heatmap stack where its rule puts it."""
    model, variables, _, _ = _served('upstream', serve_batch)
    sd = flax_to_torch(variables)
    assert set(sd) == set(model.state_dict())
    head = variables['params']['dense_head']['head_1']
    np.testing.assert_array_equal(
        sd['dense_head.heads_list.1.hm.0.0.weight'].numpy(),
        head['hm_conv0']['kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd['dense_head.heads_list.1.hm.1.bias'],
                                  head['hm_out']['bias'])
    np.testing.assert_array_equal(
        sd['backbone_3d.res2_b.conv2.1.running_var'].numpy(),
        variables['batch_stats']['backbone_3d']['res2_b']['conv2'][
            'BatchNorm_0']['var'])
    assert list(model.dense_head.heads_list[0].names) == sorted(
        ['hm', 'center', 'center_z', 'dim', 'rot', 'vel', 'iou'])


@pytest.mark.parametrize('where', ['head_output', 'head_layer',
                                   'res_block'])
def test_centerpoint_tree_raises_on_unmapped_flax_keys(serve_batch, where):
    """A head output without its stack, a head layer of no known kind and
    a residual block's third conv have no port key: the bridge raises."""
    variables = copy.deepcopy(_served('upstream', serve_batch)[1])
    params = variables['params']
    kernel = {'kernel': np.ones((3, 3, 4, 4), np.float32)}
    if where == 'head_output':
        params['dense_head']['head_0']['extra_out'] = kernel
    elif where == 'head_layer':
        params['dense_head']['head_0']['hm_gn0'] = kernel
    else:
        params['backbone_3d']['res1_a']['conv3'] = {'Dense_0': {
            'kernel': np.ones((3, 3), np.float32)}}
    with pytest.raises(KeyError, match='unmapped'):
        flax_to_torch(variables)


@pytest.mark.parametrize('missing', ['BACKBONE_3D'])
def test_centerpoint_without_head_groups_or_voxel_trunk_raises(missing):
    """A CenterPoint without BACKBONE_3D takes the pillar trunk
    (``tests/test_torch_pointpillar.py``), which needs a pillar VFE and
    PointPillarScatter: with the voxel trunk's MeanVFE and
    HeightCompression it raises, naming both. (A CenterHead without head
    groups is the plain CenterHead:
    ``test_centerpoint_with_the_plain_center_head_serves_as_jax``.)"""
    cfg = zoo.tiny_centerpoint_voxel_cfg(FINAL)
    cfg.pop(missing)
    with pytest.raises(ValueError, match='MeanVFE and MAP_TO_BEV '
                                         'HeightCompression'):
        build_detector(cfg, 3, device='cpu', voxel_size=VS,
                       point_cloud_range=PCR, final_grid_zyx=FINAL,
                       class_names=CLASSES)


def _plain_head_cfg():
    """The tiny CenterPoint with a DENSE_HEAD without head groups: the
    JAX package builds the plain CenterHead (its top 48 (pixel, class)
    pairs), whose boxes go through POST_PROCESSING's NMS."""
    cfg = zoo.tiny_centerpoint_voxel_cfg(FINAL)
    head = cfg.DENSE_HEAD
    for key in ('CLASS_NAMES_EACH_HEAD', 'SEPARATE_HEAD_CFG', 'NUM_HM_CONV',
                'USE_BIAS_BEFORE_NORM', 'POST_PROCESSING'):
        head.pop(key)
    head.POST_CONFIG = EDict({'MAX_OBJ_PER_SAMPLE': 48})
    head.LOSS_CONFIG.LOSS_WEIGHTS.code_weights = [1.0] * 8
    cfg.POST_PROCESSING = EDict({
        'SCORE_THRESH': 0.1, 'NMS_CONFIG': {
            'MULTI_CLASSES_NMS': False, 'NMS_THRESH': 0.2,
            'NMS_PRE_MAXSIZE': 48, 'NMS_POST_MAXSIZE': 12}})
    return cfg


def test_centerpoint_with_the_plain_center_head_serves_as_jax(serve_batch):
    """A CenterPoint without CLASS_NAMES_EACH_HEAD builds the plain
    CenterHead, as the JAX package does (``spsnet_tpu/models/detectors/
    centerpoint.py:70-81``): its maps, top-48 boxes and one-hot scores
    within tolerance, and ``post_processing``'s indices, counts and labels
    identical; every leaf of its tree maps onto a port key."""
    from spsnet_torch.models.dense_heads.center_head import CenterHead
    cfg = _plain_head_cfg()
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=3,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=FINAL, class_names=CLASSES)
    variables = _variables(jm, serve_batch)
    for name in ('center', 'dim'):
        layer = variables['params']['dense_head'][name]
        layer['kernel'] = layer['kernel'] * np.float32(0.1)
    model = build_detector(cfg, 3, device='cpu', voxel_size=VS,
                           point_cloud_range=PCR, final_grid_zyx=FINAL,
                           class_names=CLASSES)
    assert isinstance(model.dense_head, CenterHead)
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    post = StaticConfig(cfg.POST_PROCESSING)
    jout, jdets = jax.jit(lambda v, b: (lambda o: (
        o, jax_post_processing(o, post)))(jm.apply(v, b, train=False)))(
            variables, serve_batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in serve_batch.items()})
    for k in ('heatmap', 'center', 'center_z', 'dim', 'rot'):
        _close(out['center_head_ret'][k], np.asarray(
            jout['center_head_ret'][k]).transpose(0, 3, 1, 2), k)
    for k in ('batch_box_preds', 'batch_cls_preds'):
        _close(out[k], jout[k], k)
    dets = post_processing(out, cfg.POST_PROCESSING)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    _close(dets['boxes'], jdets['boxes'], 'boxes')
    assert int(dets['count'].min()) > 0


def test_heatmap_bias_starts_at_the_heads_value():
    model = build_detector(zoo.tiny_centerpoint_voxel_cfg(FINAL), 3,
                           device='cpu', voxel_size=VS, point_cloud_range=PCR,
                           final_grid_zyx=FINAL, class_names=CLASSES)
    for head in model.dense_head.heads_list:
        assert (head.hm[-1].bias == np.float32(-2.19)).all()
        assert (head.dim[-1].bias != np.float32(-2.19)).all()
