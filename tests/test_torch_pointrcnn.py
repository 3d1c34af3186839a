"""The port's PointRCNN serving path against the JAX package on the CPU.

The tiny PointRCNN (``tiny_pointrcnn_cfg``, the topology of
``pointrcnn.yaml``) serves two synthetic scans of 128 points: the
PointNet2MSG backbone (four D-FPS SA layers, four FP layers), the point
head, the proposal NMS, the RoI point pooling, the RoI head's SA stack and
towers, and the final NMS with the RoIs' labels. Flax variables from a
fixed key go through the weight bridge; inputs come from numpy seeds.
Sampled points, three-NN, NMS and pooling indices must be identical;
floats stay within ``RTOL`` / ``ATOL``: both packages run fp32 with sums
in another order (XLA:CPU against the CPU BLAS), ~1e-7 relative per layer.
The unit cases below hold the new ops to their JAX counterparts.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu import ops as jops
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors.detector3d import \
    class_agnostic_nms_batch as jax_nms_batch
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.roi_heads.roi_utils import \
    roipoint_pool3d as jax_roipoint_pool3d
from spsnet_tpu.ops import interpolate as jinterp
from spsnet_tpu.ops.pallas import fps as jfps
from spsnet_tpu.utils import box_coder as jax_box_coder
from spsnet_tpu.zoo import tiny_pointrcnn_cfg as jax_tiny_pointrcnn_cfg
from spsnet_torch import ops, zoo
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import (
    class_agnostic_nms_batch, post_processing)
from spsnet_torch.models.roi_heads.roi_utils import roipoint_pool3d
from spsnet_torch.ops import boxes as tboxes
from spsnet_torch.ops import interpolate
from spsnet_torch.ops.sampling import (FpsChunks, farthest_point_sample_plain,
                                       fps_seeding_active)
from spsnet_torch.utils import box_coder
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import load_flax

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, N = 2, 128
RTOL, ATOL = 1e-4, 1e-4
# squared distances of the |a|^2 + |b|^2 - 2ab form: XLA fuses the three
# terms with FMAs, the port rounds each op; the cancellation leaves ~1 ulp
# of |a|^2 (up to ~5e3 m^2 in a 70 m scan, ulp 4.9e-4) in absolute terms
D2_ATOL = 2e-3
# train mode: BatchNorm normalises with the batch's own statistics, whose
# 1/std amplifies the forward's differences (4.4e-4 measured on rcnn_reg)
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_vars(model, key, *args, **kwargs):
    variables = jax.jit(lambda k, *a: model.init(k, *a, **kwargs))(key, *args)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.fixture(scope='module')
def tiny():
    jcfg, cfg = jax_tiny_pointrcnn_cfg(), zoo.tiny_pointrcnn_cfg()
    points = synthetic_scan_batch(0, B, N)
    jm = jax_build_detector(jcfg, num_class=3)
    variables = _jax_vars(jm, jax.random.PRNGKey(0), {'points': points},
                          train=False)
    nms = jcfg.ROI_HEAD.NMS_CONFIG.TEST
    nms_kw = dict(score_thresh=-1e9, nms_thresh=float(nms.NMS_THRESH),
                  nms_pre=int(nms.NMS_PRE_MAXSIZE),
                  nms_post=int(nms.NMS_POST_MAXSIZE))

    def forward(v, pts):
        out, state = jm.apply(v, {'points': pts}, train=False,
                              capture_intermediates=True,
                              mutable=['intermediates'])
        ph = out['point_head_ret']
        props = jax_nms_batch(ph['point_box_preds'], ph['point_cls_preds'],
                              **nms_kw)
        stage1 = {k: out[k] for k in ('point_coords', 'point_features',
                                      'point_cls_scores')}
        pooled = jm.apply(v, stage1, props['boxes'],
                          method=lambda m, b, r: m.roi_head.roipool(b, r))
        return (out, state['intermediates'], props, pooled,
                jax_post_processing(out, StaticConfig(jcfg.POST_PROCESSING)))
    jax_out, inter, jax_props, jax_pooled, jax_dets = jax.jit(forward)(
        variables, points)

    model = build_detector(cfg, 3, device='cpu')
    load_flax(model, variables)
    with torch.no_grad():
        out = model({'points': torch.from_numpy(points)})
        ph = out['point_head_ret']
        props = class_agnostic_nms_batch(ph['point_box_preds'],
                                         ph['point_cls_preds'], **nms_kw)
        pooled = model.roi_head.roipool(out, out['rois'])
        # the RoI stage over the JAX package's pooled points: the same
        # input to both SA stacks
        refined = model.roi_head.refine(_t(jax_pooled))
    return {'jax_out': jax_out, 'inter': inter, 'jax_props': jax_props,
            'jax_pooled': np.asarray(jax_pooled), 'jax_dets': jax_dets,
            'out': out, 'props': props, 'pooled': pooled, 'refined': refined,
            'dets': post_processing(out, cfg.POST_PROCESSING),
            'model': model, 'points': points, 'jm': jm,
            'variables': variables}


def test_backbone_picks_and_three_nn_are_identical(tiny):
    """Every SA layer's centers are gathered by identical FPS picks, so
    they are bitwise equal; every FP layer's three neighbours are the same
    points, their squared distances within D2_ATOL."""
    out, sa = tiny['out'], tiny['inter']['backbone_3d']
    levels = [tiny['points'][..., :3]]
    for k in range(4):
        levels.append(np.asarray(sa[f'sa_{k}']['__call__'][0][0]))
        np.testing.assert_array_equal(out['sa_xyz'][k + 1].numpy(),
                                      levels[-1], err_msg=f'SA layer {k}')
        idx = out['sa_idx'][k + 1]
        np.testing.assert_array_equal(
            ops.gather_points(out['sa_xyz'][k], idx).numpy(), levels[-1])
    for i in range(4):
        jd, ji = jax.jit(jinterp.three_nn)(levels[i], levels[i + 1])
        d, idx = interpolate.three_nn(_t(levels[i]), _t(levels[i + 1]))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji),
                                      err_msg=f'FP layer {i}')
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                                   atol=D2_ATOL)


def test_point_head_within_tolerance(tiny):
    out, jax_out = tiny['out'], tiny['jax_out']
    ph, jph = out['point_head_ret'], jax_out['point_head_ret']
    for key in ('point_cls_preds', 'point_box_preds_raw', 'point_box_preds'):
        np.testing.assert_allclose(ph[key].numpy(), np.asarray(jph[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ('point_features', 'point_cls_scores'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jax_out[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_proposals_and_pooled_points_match(tiny):
    """Proposal NMS (no score threshold) keeps the same points in the same
    order; the RoIs and their pooled canonical points agree."""
    props, jprops = tiny['props'], tiny['jax_props']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(props[key].numpy(),
                                      np.asarray(jprops[key]), err_msg=key)
    np.testing.assert_allclose(tiny['out']['rois'].numpy(),
                               np.asarray(jprops['boxes']), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        tiny['out']['roi_valid'].numpy(),
        np.arange(props['boxes'].shape[1])[None] <
        np.asarray(jprops['count'])[:, None])
    np.testing.assert_allclose(tiny['pooled'].numpy(), tiny['jax_pooled'],
                               rtol=RTOL, atol=ATOL)


def test_roi_sa_picks_are_identical(tiny):
    """Over the same pooled points, the RoI head's two D-FPS layers pick
    what the JAX package's FPS picks; the port's own chain picks the same
    centers as the JAX forward (captured from its SA layers)."""
    pooled = tiny['jax_pooled']
    xyz = pooled[..., :3].reshape(-1, *pooled.shape[2:3], 3)
    _, _, picks = tiny['refined']
    roi = tiny['inter']['roi_head']
    own = tiny['pooled'].numpy()[..., :3].reshape(xyz.shape)
    for k, npoint in enumerate((16, 8)):
        want = np.asarray(jops.farthest_point_sample(jnp.asarray(xyz),
                                                     npoint))
        np.testing.assert_array_equal(picks[k].numpy(), want,
                                      err_msg=f'RoI SA layer {k}')
        xyz = np.take_along_axis(xyz, want[..., None].astype(np.int64), 1)
        own = np.take_along_axis(
            own, tiny['out']['roi_sa_idx'][k].numpy()[..., None], 1)
        np.testing.assert_allclose(
            own, np.asarray(roi[f'sa_{k}']['__call__'][0][0]), rtol=RTOL,
            atol=ATOL, err_msg=f'RoI SA layer {k} centers')
    assert picks[2] is None and tiny['out']['roi_sa_idx'][2] is None


def test_refined_boxes_and_detections_match(tiny):
    """rcnn_cls, rcnn_reg and the decoded boxes within tolerance; the final
    NMS keeps the same RoIs with the RoIs' labels."""
    out, jax_out = tiny['out'], tiny['jax_out']
    ret, jret = out['roi_head_ret'], jax_out['roi_head_ret']
    for key in ('rcnn_cls', 'rcnn_reg'):
        np.testing.assert_allclose(ret[key].numpy(), np.asarray(jret[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(out['batch_box_preds'].numpy(),
                               np.asarray(jax_out['batch_box_preds']),
                               rtol=RTOL, atol=ATOL)
    assert out['has_class_labels'] and bool(jax_out['has_class_labels'])
    dets, jax_dets = tiny['dets'], tiny['jax_dets']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(),
                                      np.asarray(jax_dets[key]), err_msg=key)
    np.testing.assert_allclose(dets['boxes'].numpy(),
                               np.asarray(jax_dets['boxes']), rtol=RTOL,
                               atol=ATOL)
    ok = dets['indices'] >= 0
    roi_labels = out['batch_roi_labels'].gather(
        1, dets['indices'].clamp(min=0))
    assert torch.equal(dets['labels'][ok], roi_labels[ok])


def test_roipoint_pool3d_matches_jax():
    """Pooling on one input in both packages, bit for bit: a RoI with more
    hits than slots, one with fewer (its slots past the last hit repeat
    the first), an empty one far away, a zero-size padding row, and a
    rotated one, with and without the pooling margin."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (2, 300, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 300, 4)).astype(np.float32)
    rois = np.array([[[0, 0, 0, 6, 6, 6, 0.3], [2, 2, 0, 2, 2, 2, 0.0],
                      [100, 100, 100, 1, 1, 1, 0.0], [0] * 7],
                     [[1, -1, 0, 3, 2, 4, 1.2], [0] * 7,
                      [-3, 3, 1, 1.5, 1.5, 1.5, -0.7],
                      [50, 0, 0, 2, 2, 2, 0.0]]], np.float32)
    for margin in (0.0, 0.5):
        width = (margin,) * 3
        want, want_empty = jax_roipoint_pool3d(
            jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(rois),
            num_sampled_points=16, pool_extra_width=width)
        got, empty = roipoint_pool3d(_t(pts), _t(feats), _t(rois), 16, width)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(empty.numpy(), np.asarray(want_empty))
        # the axis-aligned few-hit RoI: its hits in index order, then its
        # first hit again
        half = 1.0 + margin / 2
        local = pts[0] - rois[0, 1, :3]
        hits = np.flatnonzero((np.abs(local[:, :2]) < half + 1e-5).all(1)
                              & (np.abs(local[:, 2]) <= half))
        assert 0 < len(hits) < 16
        slots = got[0, 1, :, :3].numpy()
        np.testing.assert_array_equal(slots[:len(hits)], pts[0, hits])
        assert (slots[len(hits):] == pts[0, hits[0]]).all()
        # the far RoI is empty; the zero-size padding row too, unless a
        # margin gives it a size (as in the JAX package)
        assert empty[0].tolist() == [False, False, True, margin == 0.0]


CODERS = {
    'residual': ('ResidualCoder', {}, 7),
    'residual_sincos_extra': ('ResidualCoder',
                              {'encode_angle_by_sincos': True}, 9),
    'point_residual': ('PointResidualCoder', {
        'use_mean_size': True,
        'mean_size': [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]},
        7),
    'point_residual_no_mean': ('PointResidualCoder',
                               {'use_mean_size': False}, 7),
}


@pytest.mark.parametrize('name', sorted(CODERS))
def test_box_coders_match_jax(name):
    """Encode and decode of both new coders, against anchors (RoIs) or
    points with classes, as the JAX package computes them."""
    coder_name, kw, width = CODERS[name]
    rng = np.random.default_rng(len(name))
    n = 64
    gt = np.concatenate([rng.uniform(-20, 20, (n, 3)),
                         rng.uniform(0.5, 4, (n, 3)),
                         rng.uniform(-np.pi, np.pi, (n, 1)),
                         rng.normal(size=(n, width - 7))], -1).astype(
                             np.float32)
    ref = gt + rng.normal(scale=0.3, size=gt.shape).astype(np.float32)
    ref[:, 3:6] = np.abs(ref[:, 3:6]) + 0.1
    classes = rng.integers(1, 4, n)
    jc = jax_box_coder.build_box_coder(coder_name, **kw)
    tc = box_coder.build_box_coder(coder_name, **kw)
    assert tc.code_size == jc.code_size
    if coder_name == 'ResidualCoder':
        want = jc.encode(jnp.asarray(gt), jnp.asarray(ref))
        got = tc.encode(_t(gt), _t(ref))
        dec = (jc.decode(want, jnp.asarray(ref)), tc.decode(got, _t(ref)))
    else:
        want = jc.encode(jnp.asarray(gt), jnp.asarray(ref[:, :3]),
                         gt_classes=jnp.asarray(classes))
        got = tc.encode(_t(gt), _t(ref[:, :3]), gt_classes=_t(classes))
        dec = (jc.decode(want[:, :8], jnp.asarray(ref[:, :3]),
                         pred_classes=jnp.asarray(classes)),
               tc.decode(got[:, :8], _t(ref[:, :3]),
                         pred_classes=_t(classes)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dec[1].numpy(), np.asarray(dec[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dec[1][:, :6].numpy(), gt[:, :6], rtol=1e-4,
                               atol=1e-4)


def test_three_nn_and_interpolation_on_ties():
    """Duplicated known points and points at equal distance: the lowest
    index comes first, as ``jax.lax.top_k`` orders them; a known point on
    an unknown one has distance 0 and takes (almost) all the weight."""
    known = np.array([[[1, 0, 0], [0, 1, 0], [1, 0, 0], [-1, 0, 0],
                       [0, -1, 0], [0, 1, 0], [3, 3, 3]]], np.float32)
    unknown = np.array([[[0, 0, 0], [1, 0, 0], [0.5, 0.5, 0],
                         [2, 2, 2]]], np.float32)
    feats = np.random.default_rng(0).normal(size=(1, 7, 5)).astype(np.float32)
    jd, ji = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, idx = interpolate.three_nn(_t(unknown), _t(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx[0, 0].tolist() == [0, 1, 2] and idx[0, 1].tolist()[:2] == [0, 2]
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    w = interpolate.three_interpolate_weights(d)
    jw = jinterp.three_interpolate_weights(jd)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(
        interpolate.three_interpolate(_t(feats), idx, w).numpy(),
        np.asarray(jinterp.three_interpolate(jnp.asarray(feats), ji, jw)),
        rtol=1e-6, atol=1e-6)


def test_three_nn_blocks_change_no_value(monkeypatch):
    rng = np.random.default_rng(1)
    unknown = _t(rng.uniform(-30, 30, (2, 500, 3)).astype(np.float32))
    known = _t(rng.uniform(-30, 30, (2, 64, 3)).astype(np.float32))
    whole = interpolate.three_nn(unknown, known)
    monkeypatch.setattr(interpolate, '_BLOCK_ENTRIES', 2 * 64 * 37)
    blocked = interpolate.three_nn(unknown, known)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def _nms_boxes(rng, K):
    """(2, K, 7) boxes with touching, identical and zero-size ones."""
    boxes = np.concatenate([rng.uniform(-15, 15, (2, K, 3)),
                            rng.uniform(1, 5, (2, K, 3)),
                            rng.uniform(-np.pi, np.pi, (2, K, 1))],
                           -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]
    boxes[:, 3] = [1, 0, 0, 2, 2, 1, 0]        # touches box 4 at x = 2
    boxes[:, 4] = [3, 0, 0, 2, 2, 1, 0]
    boxes[:, 5] = [5, 5, 0, 0, 0, 0, 0]        # zero-size
    return boxes


@pytest.mark.parametrize('thresh', [0.0, 0.85])
def test_dense_overlap_mask_blocks_change_no_value(monkeypatch, thresh):
    """The dense NMS overlap mask in several blocks of rows is the one
    ``boxes_iou_bev_fast`` gives over all pairs at once."""
    K = 300
    boxes = _t(_nms_boxes(np.random.default_rng(4), K))
    whole = torch.triu(tboxes.boxes_iou_bev_fast(boxes, boxes) > thresh, 1)
    assert torch.equal(tboxes.dense_overlap_mask(boxes, thresh), whole)
    monkeypatch.setattr(tboxes, '_DENSE_PAIRS', 2 * K * 37)
    assert torch.equal(tboxes.dense_overlap_mask(boxes, thresh), whole)


@pytest.mark.parametrize('thresh', [0.0, 0.3, 0.85])
def test_candidate_overlap_mask_equals_the_dense_one_and_jax(monkeypatch,
                                                             thresh):
    """The NMS overlap mask over candidate pairs (circumscribed circles
    that meet), in several row blocks and pair chunks, is the dense mask
    bit for bit, at threshold 0 too (where a separated pair's IoU must
    compute to exactly 0); with it, NMS keeps what the JAX package keeps.
    The boxes include touching, identical and zero-size ones."""
    rng = np.random.default_rng(2)
    K = 300
    boxes = _nms_boxes(rng, K)
    scores = rng.uniform(size=(2, K)).astype(np.float32)
    dense = tboxes.dense_overlap_mask(_t(boxes), thresh)
    monkeypatch.setattr(tboxes, '_DENSE_PAIRS', 0)
    monkeypatch.setattr(tboxes, '_CANDIDATE_BLOCK', 2 * K * 37)
    monkeypatch.setattr(tboxes, '_PAIR_CHUNK', 500)
    assert torch.equal(tboxes.overlap_mask(_t(boxes), thresh), dense)
    keep, num = ops.nms_bev(_t(boxes), _t(scores), thresh, pre_maxsize=K,
                            post_maxsize=100)
    for b in range(2):
        want, want_num = jops.nms_bev(jnp.asarray(boxes[b]),
                                      jnp.asarray(scores[b]), thresh,
                                      pre_maxsize=K, post_maxsize=100)
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(want))
        assert int(num[b]) == int(want_num)


def test_class_agnostic_nms_batch_takes_given_labels():
    rng = np.random.default_rng(3)
    boxes = np.concatenate([rng.uniform(-10, 10, (2, 40, 3)),
                            rng.uniform(1, 4, (2, 40, 3)),
                            rng.uniform(-3, 3, (2, 40, 1))], -1).astype(
                                np.float32)
    logits = rng.normal(size=(2, 40, 1)).astype(np.float32)
    labels = rng.integers(1, 4, (2, 40)).astype(np.int32)
    kw = dict(score_thresh=0.3, nms_thresh=0.1, nms_pre=32, nms_post=16)
    want = jax_nms_batch(jnp.asarray(boxes), jnp.asarray(logits),
                         batch_label_preds=jnp.asarray(labels), **kw)
    got = class_agnostic_nms_batch(_t(boxes), _t(logits),
                                   batch_label_preds=_t(labels), **kw)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert (got['labels'][got['indices'] < 0] == 0).all()


@pytest.mark.parametrize('B_,N_,npoint,chunks', [(2, 512, 64, 4),
                                                 (1, 384, 96, 2)])
def test_chunked_fps_matches_the_jax_wrapper(B_, N_, npoint, chunks):
    """``farthest_point_sample_chunked`` against the JAX wrapper (its Pallas
    kernel in interpret mode) and against exact FPS of each slice; the
    ``FpsChunks`` option takes it only where the chunks divide N and
    npoint, and turns the prefix-nesting shortcut off."""
    xyz = synthetic_scan_batch(B_ + N_, B_, N_)[..., :3]
    want = np.asarray(jfps.farthest_point_sample_chunked(
        jnp.asarray(xyz), npoint, chunks, interpret=True))
    got = ops.farthest_point_sample_chunked(_t(xyz), npoint, chunks)
    np.testing.assert_array_equal(got.numpy(), want)
    nc, mc = N_ // chunks, npoint // chunks
    for s in range(chunks):
        part = farthest_point_sample_plain(_t(xyz[:, s * nc:(s + 1) * nc]),
                                           mc)
        assert torch.equal(got[:, s * mc:(s + 1) * mc], part + s * nc)
    opt = FpsChunks(chunks)
    assert torch.equal(ops.farthest_point_sample(_t(xyz), npoint,
                                                 seeding=opt), got)
    assert torch.equal(ops.farthest_point_sample(_t(xyz), npoint - 1,
                                                 seeding=opt),
                       farthest_point_sample_plain(_t(xyz), npoint - 1))
    assert fps_seeding_active(opt, npoint, allow_seed=True)
    with pytest.raises(ValueError):
        FpsChunks(1)


def test_pointrcnn_train_mode_without_gt_matches_jax(tiny):
    """Train mode without 'gt_boxes', as in the JAX package: neither head
    makes targets, the RoI head refines the proposals of NMS_CONFIG.TRAIN
    (16 a frame, TEST keeps 8) with BatchNorm on the batch's statistics,
    and 'batch_box_preds' stay the point head's."""
    jm, points = tiny['jm'], tiny['points']
    jax_out, _ = jax.jit(lambda v, p: jm.apply(
        v, {'points': p}, train=True, mutable=['batch_stats']))(
            tiny['variables'], points)
    model = copy.deepcopy(tiny['model']).train()
    out = model({'points': torch.from_numpy(points)})
    ret, jret = out['roi_head_ret'], jax_out['roi_head_ret']
    assert ret['targets'] is None and jret['targets'] is None
    assert 'targets' not in out['point_head_ret']
    assert 'targets' not in jax_out['point_head_ret']
    nms = zoo.tiny_pointrcnn_cfg().ROI_HEAD.NMS_CONFIG.TRAIN
    assert ret['rois'].shape[1] == nms.NMS_POST_MAXSIZE
    for key in ('rois', 'rcnn_cls', 'rcnn_reg', 'batch_box_preds'):
        np.testing.assert_allclose(ret[key].detach().numpy(),
                                   np.asarray(jret[key]), rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=key)
    for key in ('batch_box_preds', 'batch_cls_preds'):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(jax_out[key]), rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=key)
    assert out['batch_box_preds'] is out['point_head_ret']['point_box_preds']
