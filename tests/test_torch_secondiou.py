"""The port's SECOND-IoU against the JAX package on the CPU: the BEV
RoI-grid pool, ``SECONDHead``, ``second_head_loss``, the IoU rescoring of
every SCORE_TYPE, and the tiny SECOND-IoU serving and taking one train
step.

The pool is held to JAX's ``bev_roi_grid_pool`` and, as a check of its
geometry, to torch's own ``F.affine_grid`` + ``F.grid_sample`` (the
reference's composition, ``align_corners=False``, zero padding). The head
runs on a seeded 16 x 16 BEV map with seeded proposals; in training with
the JAX package's RoI draws (the key its head's ``make_rng`` gives,
through ``pointrcnn_head.draw_roi_sampling``) and its dropout masks (read
from its Dropout modules' outputs, ``capture_intermediates``, and handed
to the port's ``blocks.Dropout`` in call order). The tiny SECOND-IoU
(``zoo.tiny_secondiou_cfg`` on ``tests/test_pvrcnn.py``'s
``make_pv_batch``) takes one step through both packages'
``make_train_step`` at DP_RATIO 0 (the steps' dropout streams differ).
Index outputs must be identical; floats within the tolerances stated
below.
"""
import copy

import numpy as np
import jax
import pytest
import torch
import torch.nn.functional as F

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors.detector3d import \
    iou_rescore_post_processing as jax_rescore
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.roi_heads import second_head as jax_second_head
from spsnet_torch import ops, zoo
from spsnet_torch.config import EDict
from spsnet_torch.models import blocks, build_detector
from spsnet_torch.models.detectors import detector3d
from spsnet_torch.models.roi_heads import pointrcnn_head, second_head
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_pvrcnn import PCR as PV_PCR
from tests.test_pvrcnn import VS as PV_VS
from tests.test_pvrcnn import make_pv_batch
from tests.test_torch_pointpillar import _fill
from tests.test_torch_pointrcnn_train import _jax_draws
from tests.test_torch_pvrcnn import _Holder
from tests.test_torch_multihead_train import RPN_KEYS, hold_train_step
from tests.test_torch_pvrcnn_train import (_gt_near_proposals, _head_key,
                                           _one_step, _variables)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, C, HW = 2, 8, 16
PCR = (0, -12.8, -3, 25.6, 12.8, 1)
VS = (0.4, 0.4, 0.1)
DS = 4
# pooled features: bilinear weights from the same fp32 ops (XLA may take
# a division by a constant as a product with its reciprocal): ~1e-6 of the
# largest entry; the head's outputs and loss as the voxel detectors' tests
# hold them
POOL_ATOL = 1e-5
RTOL, ATOL, LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-4, 1e-4, 1e-3
SCORE_TYPES = ['iou', 'cls', 'weighted_iou_cls', 'num_pts_iou_cls',
               'score_by_class']


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _rois(rng, n, spread=1.0):
    """(B, n, 7) boxes over the 25.6 m map and past its edges, KITTI-like
    sizes times ``spread``, any heading."""
    r = np.zeros((B, n, 7), np.float32)
    r[..., 0] = rng.uniform(-2, 27.6, (B, n))
    r[..., 1] = rng.uniform(-14, 14, (B, n))
    r[..., 2] = rng.uniform(-2, 0, (B, n))
    r[..., 3:6] = rng.uniform([0.6, 0.5, 1.4], [4.5, 2.0, 1.8],
                              (B, n, 3)) * spread
    r[..., 6] = rng.uniform(-np.pi, np.pi, (B, n))
    return r


def _bev(seed):
    return np.random.default_rng(seed).normal(
        size=(B, HW, HW, C)).astype(np.float32)


# --------------------------------------------------------------- the pool

def test_bev_roi_grid_pool_matches_jax_and_grid_sample():
    """40 RoIs a frame (some past the map's edge, some at headings 0 and
    pi / 2) at G = 7: the port's pool within POOL_ATOL of the largest
    entry of JAX's and of ``F.affine_grid`` + ``F.grid_sample`` with the
    theta of the legacy (W - 1) factors; channel-major flatten; zero past
    the map."""
    rng = np.random.default_rng(0)
    rois = _rois(rng, 40)
    rois[:, :4, 6] = [0, np.pi / 2, -np.pi / 2, np.pi]
    rois[:, 4, 0] = 40.0                     # wholly outside: zeros
    bev = _bev(1)
    G = 7
    got = second_head.bev_roi_grid_pool(
        _t(rois), _t(bev.transpose(0, 3, 1, 2)), G, VS, PCR, DS)
    want = np.asarray(jax_second_head.bev_roi_grid_pool(
        rois, bev, G, VS, PCR, DS))
    assert got.shape == (B, 40, C * G * G)
    _close(got, want, 'pool vs JAX', rtol=0, atol=POOL_ATOL)
    assert (got[:, 4] == 0).all() and (got[:, :4] != 0).any()

    r = _t(rois).reshape(-1, 7)
    cell = [v * DS for v in VS[:2]]
    cx, cy = (r[:, 0] - PCR[0]) / cell[0], (r[:, 1] - PCR[1]) / cell[1]
    hx, hy = r[:, 3] / cell[0] / 2, r[:, 4] / cell[1] / 2
    x1, x2, y1, y2 = cx - hx, cx + hx, cy - hy, cy + hy
    W = H = HW
    sx, tx = (x2 - x1) / (W - 1), (x1 + x2 - (W - 1)) / (W - 1)
    sy, ty = (y2 - y1) / (H - 1), (y1 + y2 - (H - 1)) / (H - 1)
    cos, sin = torch.cos(r[:, 6]), torch.sin(r[:, 6])
    theta = torch.stack([torch.stack([sx * cos, -sx * sin, tx], -1),
                         torch.stack([sy * sin, sy * cos, ty], -1)], 1)
    grid = F.affine_grid(theta, (r.shape[0], C, G, G), align_corners=False)
    maps = _t(bev.transpose(0, 3, 1, 2)).repeat_interleave(40, 0)
    ref = F.grid_sample(maps, grid, mode='bilinear', padding_mode='zeros',
                        align_corners=False).reshape(B, 40, -1)
    _close(got, ref.numpy(), 'pool vs grid_sample', rtol=0, atol=POOL_ATOL)


# --------------------------------------------------------------- the head

def _head_cfg():
    cfg = copy.deepcopy(zoo.tiny_secondiou_cfg((2, 2, 2)).ROI_HEAD)
    cfg.ROI_GRID_POOL.DOWNSAMPLE_RATIO = DS
    cfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 24
    cfg.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 12
    cfg.TARGET_CONFIG.ROI_PER_IMAGE = 16
    return cfg


def _head_batch(seed, train):
    """Seeded proposals (60 a frame, three class logits), a BEV map and,
    in training, gt boxes near eight proposals of each frame (four of them
    0.6 m off, so that their IoU lies between CLS_BG_THRESH and
    CLS_FG_THRESH, where the roi_iou label has a gradient)."""
    rng = np.random.default_rng(seed)
    boxes = _rois(rng, 60)
    boxes[..., 0] = np.clip(boxes[..., 0], 1, 24)
    boxes[..., 1] = np.clip(boxes[..., 1], -11, 11)
    batch = {'batch_box_preds': boxes,
             'batch_cls_preds': rng.normal(size=(B, 60, 3)).astype(
                 np.float32),
             'spatial_features_2d': _bev(seed + 1)}
    if train:
        gt = np.zeros((B, 8, 8), np.float32)
        gt[..., :7] = boxes[:, :8] + rng.normal(0, 0.05, (B, 8, 7)).astype(
            np.float32)
        gt[:, ::2, 0] += np.float32(0.6)
        gt[..., 7] = rng.integers(1, 4, (B, 8))
        gt[1, 6:] = 0
        batch['gt_boxes'] = gt
    return batch


def _near_thresh(boxes, thresh):
    iou = torch.stack([ops.boxes.boxes_iou_bev_fast(f, f)
                       for f in _t(boxes)])
    return float((iou - thresh).abs().min())


def _head_pair(seed):
    cfg = _head_cfg()
    jm = jax_second_head.SECONDHead(
        model_cfg=StaticConfig(JaxEDict(copy.deepcopy(cfg))), num_class=1,
        voxel_size=VS, point_cloud_range=PCR, bev_stride=DS)
    batch = _head_batch(seed, False)
    shapes = jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), batch)
    variables = _fill(shapes, seed)
    head = second_head.SECONDHead(cfg, C, VS, PCR, DS)
    holder = _Holder(roi_head=head)
    sd = flax_to_torch({c: {'roi_head': t} for c, t in variables.items()})
    assert set(sd) == set(holder.state_dict())
    holder.load_state_dict(sd)
    return jm, variables, head


def test_second_head_eval_matches_jax():
    """Eval: the proposals (raw max logits, NMS_CONFIG.TEST) and their
    labels identical, the IoU logits within tolerance; the batch keys
    ``post_processing`` reads, 'has_class_labels' True for three class
    channels."""
    jm, variables, head = _head_pair(10)
    batch = _head_batch(11, False)
    assert _near_thresh(batch['batch_box_preds'], 0.7) > 1e-5
    jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                            batch)
    head.eval()
    tb = {k: _t(v) for k, v in batch.items()}
    tb['spatial_features_2d'] = tb['spatial_features_2d'].permute(0, 3, 1, 2)
    with torch.no_grad():
        out = head(tb)
    for key in ('batch_roi_labels',):
        np.testing.assert_array_equal(out[key].numpy(), jout[key])
    for key in ('batch_box_preds', 'batch_roi_scores', 'batch_cls_preds'):
        _close(out[key], jout[key], key)
    np.testing.assert_array_equal(out['batch_roi_scores'].numpy(),
                                  np.asarray(jout['batch_roi_scores']))
    assert out['batch_cls_preds'].shape == (B, 12, 1)
    assert out['iou_rescoring'] and out['has_class_labels'] is True
    assert out['cls_preds_normalized'] is False
    # raw logits kept as the RoI scores (not their sigmoid)
    assert (out['batch_roi_scores'] > 1).any()


def _dropout_masks(jm, variables, batch, rngs):
    """The JAX head's two Dropout masks in a train forward (shared_fc's
    after its first block, iou_layers' after its first), as kept / not
    kept (an entry the ReLU zeroed is 0 either way)."""
    _, state = jax.jit(lambda v, b: jm.apply(
        v, b, train=True, rngs=rngs, mutable=['batch_stats', 'intermediates'],
        capture_intermediates=lambda m, _: type(m).__name__ == 'Dropout'))(
            variables, batch)
    inter = state['intermediates']
    masks = [np.asarray(inter['shared_fc']['Dropout_0']['__call__'][0]),
             np.asarray(inter['iou_layers']['SharedMLP_0']['Dropout_0'][
                 '__call__'][0])]
    return [m != 0 for m in masks]


class _Replay:
    """``blocks.Dropout.forward`` with given keep masks in call order."""

    def __init__(self, masks):
        self.masks = list(masks)

    def __call__(self, module, x, generator=None):
        keep = _t(self.masks.pop(0))
        return torch.where(keep, x / (1 - module.p), 0.0)


def test_second_head_train_matches_jax_with_replayed_draws():
    """Training with gt: the proposals at NMS_CONFIG.TRAIN, then with the
    JAX package's RoI draws the sampled RoIs, their labels and IoU targets
    identical (roi_iou, foreground among them); with its dropout masks the
    IoU logits within tolerance; ``second_head_loss`` within LOSS_RTOL;
    the loss's gradients at every parameter and at the proposals' boxes
    (which reach the loss only through the IoU targets, as in JAX: the
    pool reads the RoIs detached) within GRAD_RTOL of each tensor's
    largest entry; none reaches the BEV map; the BN statistics as flax
    moves them."""
    jm, variables, head = _head_pair(12)
    batch = _head_batch(13, True)
    assert _near_thresh(batch['batch_box_preds'], 0.8) > 1e-5
    rngs = {'roi_sampling': jax.random.PRNGKey(5),
            'dropout': jax.random.PRNGKey(6)}
    key = jm.apply(variables, method=lambda m: m.make_rng('roi_sampling'),
                   rngs={'roi_sampling': rngs['roi_sampling']})
    loss_cfg = _head_cfg().LOSS_CONFIG

    masks = _dropout_masks(jm, variables, batch, rngs)

    def jloss(params, boxes):
        out, state = jm.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            dict(batch, batch_box_preds=boxes), train=True, rngs=rngs,
            mutable=['batch_stats'])
        loss, tb = jax_second_head.second_head_loss(
            out['second_head_ret'], StaticConfig(JaxEDict(copy.deepcopy(
                loss_cfg))))
        return loss, (out['second_head_ret'], state['batch_stats'])
    (jl, (jret, jstats)), (jgrad, jbox) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables['params'],
                                             batch['batch_box_preds'])
    assert all(0 < (~m).mean() < 1 for m in masks)

    head.train()
    tb = {k: _t(v) for k, v in batch.items()}
    tb['spatial_features_2d'] = tb['spatial_features_2d'].permute(
        0, 3, 1, 2).requires_grad_()
    tb['batch_box_preds'].requires_grad_()
    tb['rngs'] = {'roi_sampling': None, 'dropout': torch.Generator()}
    own, own_fwd = pointrcnn_head.draw_roi_sampling, blocks.Dropout.forward
    replay = _Replay(masks)
    pointrcnn_head.draw_roi_sampling = \
        lambda g, B_, R, M, d: _jax_draws(key, B_, R, M)
    blocks.Dropout.forward = lambda m, x, g=None: replay(m, x, g)
    try:
        out = head(tb)
    finally:
        pointrcnn_head.draw_roi_sampling = own
        blocks.Dropout.forward = own_fwd
    assert not replay.masks
    ret = out['second_head_ret']
    t, jt = ret['targets'], jret['targets']
    for field in ('roi_labels', 'gt_of_rois_src', 'reg_valid_mask'):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(jt, field)),
                                      err_msg=field)
    for field in ('rois', 'gt_iou_of_rois', 'rcnn_cls_labels', 'roi_scores'):
        _close(getattr(t, field), getattr(jt, field), field)
    assert (t.rcnn_cls_labels > 0).any() and (t.rcnn_cls_labels == 0).any()
    _close(ret['rcnn_iou'], jret['rcnn_iou'], 'rcnn_iou')
    loss, ltb = second_head.second_head_loss(ret, loss_cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert set(ltb) == {'rcnn_iou_loss'}
    loss.backward()
    assert tb['spatial_features_2d'].grad is None
    want = {n: g for n, g in flax_to_torch({'params': {
        'roi_head': jax.tree_util.tree_map(np.asarray, jgrad)}}).items()
        if not n.endswith('num_batches_tracked')}
    got = {f'roi_head.{n}': p.grad for n, p in head.named_parameters()}
    assert set(got) == set(want)
    got['boxes'], want['boxes'] = tb['batch_box_preds'].grad, _t(jbox)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
    stats = flax_to_torch({'params': {'roi_head': variables['params']},
                           'batch_stats': {'roi_head': jax.tree_util.
                                           tree_map(np.asarray, jstats)}})
    sd = _Holder(roi_head=head).state_dict()
    for name, w in stats.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(sd[name].numpy(), w.numpy(),
                                       rtol=RTOL, atol=1e-5, err_msg=name)


@pytest.mark.parametrize('kind', ['BinaryCrossEntropy', 'L2', 'smoothL1'])
def test_second_head_loss_matches_jax(kind):
    """Each IOU_LOSS on seeded logits against labels in [0, 1] with some
    ignored (-1): within LOSS_RTOL of JAX's, non-zero."""
    rng = np.random.default_rng(20)
    logits = rng.normal(size=(B, 32)).astype(np.float32)
    labels = rng.uniform(0, 1, (B, 32)).astype(np.float32)
    labels[:, ::5] = -1
    labels[0, 1] = 0.0
    logits[0, 2:6] = labels[0, 2:6] + np.float32([0.01, -0.05, 0.2, -1])
    cfg = EDict({'IOU_LOSS': kind, 'LOSS_WEIGHTS': {'rcnn_iou_weight': 0.5}})

    class T:
        rcnn_cls_labels = _t(labels)
    loss, tb = second_head.second_head_loss(
        {'rcnn_iou': _t(logits), 'targets': T}, cfg)

    class J:
        rcnn_cls_labels = labels
    jl, jtb = jax_second_head.second_head_loss(
        {'rcnn_iou': logits, 'targets': J}, StaticConfig(JaxEDict(cfg)))
    assert float(jl) > 0
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tb['rcnn_iou_loss']),
                               float(jtb['rcnn_iou_loss']), rtol=LOSS_RTOL)


# ------------------------------------------------------------ rescoring

def _rescore_batch(seed, kind):
    """RoIs (24 a frame, two padded in frame 0), their raw IoU logits, RPN
    logits and labels, and points of which clusters fall in some RoIs;
    for score_by_class, frame 1 holds labels 1 and 3 only and no padding
    (the reference's count of distinct labels zeroes class 3 there)."""
    rng = np.random.default_rng(seed)
    R = 24
    rois = _rois(rng, R)
    labels = rng.integers(1, 4, (B, R))
    rois[0, -2:] = 0
    labels[0, -2:] = 0
    if kind == 'score_by_class':
        labels[1] = np.where(labels[1] == 2, 3, labels[1])
    pts = rng.uniform([-2, -14, -2], [28, 14, 0], (B, 600, 3))
    for b in range(B):
        for k in range(8):
            n = int(rng.integers(0, 40))
            c = rois[b, k, :3]
            pts[b, 40 * k:40 * k + n] = c + rng.normal(0, 0.3, (n, 3)) * \
                [rois[b, k, 3] / 4, rois[b, k, 4] / 4, 0.2]
    return {'batch_box_preds': rois,
            'batch_cls_preds': rng.normal(size=(B, R, 1)).astype(np.float32),
            'batch_roi_scores': rng.normal(size=(B, R)).astype(np.float32),
            'batch_roi_labels': labels.astype(np.int32),
            'points': pts.astype(np.float32),
            'has_class_labels': True, 'cls_preds_normalized': False,
            'iou_rescoring': True}


def _post(kind):
    nms = {'NMS_THRESH': 0.3, 'NMS_PRE_MAXSIZE': 20, 'NMS_POST_MAXSIZE': 10,
           'MULTI_CLASSES_NMS': False}
    if kind != 'iou':
        nms['SCORE_TYPE'] = kind
    if kind == 'weighted_iou_cls':
        nms['SCORE_WEIGHTS'] = {'iou': 0.7, 'cls': 0.3}
    if kind == 'num_pts_iou_cls':
        nms['SCORE_THRESH'] = {'cls': 5, 'iou': 25}
    if kind == 'score_by_class':
        nms['SCORE_BY_CLASS'] = {'Car': 'iou', 'Pedestrian': 'cls',
                                 'Cyclist': 'iou'}
    return EDict({'SCORE_THRESH': 0.2, 'NMS_CONFIG': nms})


@pytest.mark.parametrize('kind', SCORE_TYPES)
def test_iou_rescoring_matches_jax(kind):
    """``post_processing`` of a rescoring batch (``iou_rescore_post_
    processing``) under each SCORE_TYPE: kept indices, labels and counts
    identical to JAX's, scores and the kept boxes' 'cls_scores' /
    'iou_scores' within 1e-6; the type's feature present (num_pts_iou_cls:
    boxes with points under, between and over the thresholds; score_by_
    class: frame 1's class-3 RoIs zeroed by the distinct-label count)."""
    batch = _rescore_batch(30 + SCORE_TYPES.index(kind), kind)
    assert _near_thresh(batch['batch_box_preds'], 0.3) > 1e-5
    post = _post(kind)
    names = ['Car', 'Pedestrian', 'Cyclist']
    dets = detector3d.post_processing(
        {k: _t(v) if isinstance(v, np.ndarray) else v
         for k, v in batch.items()}, post, class_names=names)
    jd = jax_rescore(batch, StaticConfig(JaxEDict(copy.deepcopy(post))),
                     class_names=names)
    for key in ('indices', 'labels', 'count'):
        np.testing.assert_array_equal(dets[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    for key in ('scores', 'cls_scores', 'iou_scores', 'boxes'):
        np.testing.assert_allclose(dets[key].numpy(), np.asarray(jd[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    assert (dets['count'] > 0).all()
    if kind == 'num_pts_iou_cls':
        n = detector3d._points_in_each_box(_t(batch['points']),
                                           _t(batch['batch_box_preds']))
        assert (n <= 5).any() and (n >= 25).any() and \
            ((n > 5) & (n < 25)).any()
    if kind == 'score_by_class':
        lab = dets['labels'][1][dets['indices'][1] >= 0]
        assert 3 not in lab.tolist() and \
            (batch['batch_roi_labels'][1] == 3).any()


# -------------------------------------------------------- the tiny model

@pytest.fixture(scope='module')
def tiny():
    batch, final_zyx = make_pv_batch(np.random.default_rng(0))
    batch = {k: np.array(v) for k, v in batch.items()}
    final_zyx = tuple(int(v) for v in final_zyx)
    cfg = zoo.tiny_secondiou_cfg(final_zyx)
    cfg.ROI_HEAD.DP_RATIO = 0.0
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                            voxel_size=PV_VS, point_cloud_range=PV_PCR,
                            final_grid_zyx=final_zyx)
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    model = load_flax(build_detector(cfg, 1, device='cpu', voxel_size=PV_VS,
                                     point_cloud_range=PV_PCR,
                                     final_grid_zyx=final_zyx), variables)
    batch = {k: _t(v) for k, v in batch.items()}
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    return {'jm': jm, 'variables': variables, 'model': model, 'cfg': cfg,
            'batch': batch, 'key': _head_key(jm, variables, 0)}


def test_tiny_secondiou_serves_as_jax(tiny):
    """The tiny SECOND-IoU's eval forward (RoIs, IoU logits, RoI scores and
    labels) and ``post_processing`` (the IoU rescoring) against JAX's:
    indices, labels and counts identical, scores within tolerance."""
    jm, variables, model = tiny['jm'], tiny['variables'], tiny['model']
    batch = {k: v for k, v in tiny['batch'].items() if k != 'gt_boxes'}
    post = tiny['cfg'].POST_PROCESSING
    jpost = StaticConfig(JaxEDict(copy.deepcopy(post)))
    jout, jd = jax.jit(lambda v, b: (lambda o: (o, jax_post_processing(
        o, jpost, class_names=['Car'])))(jm.apply(v, b, train=False)))(
            variables, {k: v.numpy() for k, v in batch.items()})
    with torch.no_grad():
        out = model(batch)
    for key in ('batch_box_preds', 'batch_cls_preds', 'batch_roi_scores'):
        _close(out[key], jout[key], key)
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jout['batch_roi_labels'])
    dets = detector3d.post_processing(out, post, class_names=['Car'])
    for key in ('indices', 'labels', 'count'):
        np.testing.assert_array_equal(dets[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    _close(dets['scores'], jd['scores'], 'scores')
    assert int(dets['count'].min()) > 0


@pytest.fixture(scope='module')
def iou_step(tiny):
    return _one_step(tiny['jm'], tiny['variables'], tiny['model'],
                     tiny['batch'], lambda g, B_, R, M, d: _jax_draws(
                         tiny['key'], B_, R, M))


def test_tiny_secondiou_train_step_matches_jax(iou_step):
    """One ``adam_onecycle`` step: the loss terms (the anchor head's and
    rcnn_iou_loss), every gradient (the IoU head's among them), the
    updated parameters and BN statistics, held by ``hold_train_step``."""
    hold_train_step(iou_step, RPN_KEYS | {'rcnn_iou_loss'})
    assert any(n.startswith('roi_head.iou_layers.') for n in
               iou_step['grads'])


def test_flax_to_torch_maps_every_secondiou_key(tiny):
    """Every leaf of the SECOND-IoU tree lands on a port key and back
    (``shared_fc_layer`` with a Dropout between its blocks, ``iou_layers``
    with one after its first block); an unknown RoI-head layer raises."""
    variables = copy.deepcopy(tiny['variables'])
    sd = flax_to_torch(variables)
    assert set(sd) == set(tiny['model'].state_dict())
    params = variables['params']['roi_head']
    np.testing.assert_array_equal(
        sd['roi_head.iou_layers.7.weight'].numpy(),
        params['iou_layers']['Dense_0']['kernel'].T)
    np.testing.assert_array_equal(
        sd['roi_head.shared_fc_layer.4.weight'].numpy(),
        params['shared_fc']['Dense_1']['kernel'].T)
    params['iou_extra'] = {'Dense_0': {'kernel': np.ones((3, 3),
                                                         np.float32)}}
    with pytest.raises(KeyError, match='unmapped'):
        flax_to_torch(variables)
