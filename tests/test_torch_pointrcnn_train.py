"""The port's PointRCNN training against the JAX package on the CPU.

The modules of the two-stage train path one by one on numpy inputs (the
exact rotated and 3D IoU, the RoI matching and subsampling, the RoI
targets, both heads' targets and losses), the RoI head's train branch on
the same stage-1 inputs with the gradient that reaches the proposals, and
one ``adam_onecycle`` step of the tiny PointRCNN (``tiny_pointrcnn_cfg``,
B = 2 scenes of 128 points) through each package's ``make_train_step``
from the same flax variables. The RoI draws are the JAX package's: the
port's ``draw_roi_sampling`` is replaced by the numbers JAX draws from the
key its head sees (``fold_in(PRNGKey(17), step)`` through flax's
``make_rng('roi_sampling')``, then ``split(key, B)`` and ``split(k, 3)``).
Index outputs must be identical; floats stay within the tolerances stated
below. Then the step's generators: dropout masks, and the RoIs a resumed
``Trainer`` draws.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.dense_heads import point_head_box as jax_phb
from spsnet_tpu.models.dense_heads import target_assign as jax_assign
from spsnet_tpu.models.roi_heads import pointrcnn_head as jax_rcnn
from spsnet_tpu.models.roi_heads import roi_utils as jax_roi
from spsnet_tpu.ops import boxes as jax_boxes
from spsnet_tpu.runtime import optimization as jax_optim
from spsnet_tpu.runtime.trainer import TrainState
from spsnet_tpu.runtime.trainer import make_train_step as jax_make_train_step
from spsnet_tpu.utils import box_coder as jax_box_coder
from spsnet_tpu.utils import box_utils as jax_box_utils
from spsnet_tpu.zoo import tiny_pointrcnn_cfg as jax_tiny_cfg
from spsnet_torch import ops
from spsnet_torch.config import EDict
from spsnet_torch.models import build_detector
from spsnet_torch.models.blocks import MLPHead
from spsnet_torch.models.dense_heads import point_head_box, target_assign
from spsnet_torch.models.roi_heads import pointrcnn_head, roi_utils
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.trainer import Trainer, make_train_step, step_rngs
from spsnet_torch.utils import box_coder, box_utils
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from spsnet_torch.zoo import tiny_pointrcnn_cfg

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, N, SEED = 2, 128, 3
SCENE_SCALE = 0.1
OPTIM = {'BATCH_SIZE_PER_GPU': B, 'NUM_EPOCHS': 2,
         'OPTIMIZER': 'adam_onecycle', 'LR': 0.01, 'WEIGHT_DECAY': 0.01,
         'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
         'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [1, 2], 'LR_DECAY': 0.1,
         'LR_CLIP': 0.0000001, 'GRAD_NORM_CLIP': 10}
# IoUs: the port takes the shoelace terms about the centroid and stays
# within EXACT_ATOL (m^2, and IoU) of its own float64 result (3.5e-6
# measured); the JAX package takes them about the origin, where 24 products
# of up to ~150 m^2 cancel (3.5e-5 m^2 measured within 10 m of it)
EXACT_ATOL, JAX_ATOL = 1e-5, 1e-4
# features, predictions and loss terms of the tiny model: fp32 sums in
# another order (XLA:CPU against the CPU BLAS), ~1e-7 relative a layer,
# grown by BatchNorm's 1/std in training
RTOL, ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-4
# gradients, per tensor against its largest entry: BatchNorm's 1/std
# carries the forward's differences back through every layer
GRAD_RTOL = 1e-3
# parameters and BN running stats after one step: Adam's first update is
# lr * sign(g) wherever |g| >> eps, so gradient differences barely reach it
# (lr 1e-3 at step 0), but for the slack of ``_first_step_slack``
STEP_ATOL = 1e-5
ADAM_EPS = 1e-8


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _boxes(rng, n, pad=0):
    """(n, 8) boxes in a 20 m square, headings in [-4, 4], classes 1..3,
    the last ``pad`` rows zero padding."""
    boxes = np.zeros((n, 8), np.float32)
    k = n - pad
    boxes[:k, 0:2] = rng.uniform(-10, 10, (k, 2))
    boxes[:k, 2] = rng.uniform(-2, 0, k)
    boxes[:k, 3:6] = rng.uniform(0.5, 5, (k, 3))
    boxes[:k, 6] = rng.uniform(-4, 4, k)
    boxes[:k, 7] = rng.integers(1, 4, k)
    return boxes


def _jitter(rng, boxes, scale):
    """``boxes`` moved, resized and turned by ``scale`` relative amounts:
    RoIs around their gt, IoU spread over (0, 1]."""
    out = boxes.copy()
    n = boxes.shape[:-1]
    out[..., 0:3] += rng.normal(0, scale, n + (3,)) * boxes[..., 3:6]
    out[..., 3:6] *= np.exp(rng.normal(0, scale, n + (3,)))
    out[..., 6] += rng.normal(0, scale, n)
    return out.astype(np.float32)


# ------------------------------------------------------------ 3D IoU

def _iou_inputs():
    """Random boxes, and pairs at the edge cases: identical, contained,
    touching, turned by 90 degrees, zero-size padding, collinear edges."""
    rng = np.random.default_rng(0)
    a = _boxes(rng, 40)[:, :7]
    b = _boxes(rng, 32)[:, :7]
    b[:20] = _jitter(rng, a[:20, :8], 0.2)[:, :7]
    a[0] = b[0]                                     # identical
    b[1] = a[1]
    b[1, 3:6] *= 0.5                                # contained
    b[2] = a[2]
    b[2, 0] += a[2, 3] * np.cos(a[2, 6])            # touching along x
    b[2, 1] += a[2, 3] * np.sin(a[2, 6])
    b[3] = a[3]
    b[3, 6] += np.pi / 2                            # turned by 90 degrees
    b[4] = 0.0                                      # zero-size padding
    b[5] = [0, 0, 0, 2, 2, 1, 0]                    # collinear edges
    a[5] = [0.5, 0.5, 0, 1, 1, 1, 0]
    return a, b


@pytest.mark.parametrize('name', ['boxes_overlap_bev', 'boxes_iou_bev',
                                  'boxes_iou3d', 'boxes_iou3d_paired'])
def test_exact_iou_matches_jax(name):
    """Every pair of 40 x 32 boxes (the paired form: the first 32 pairs),
    random and at the edge cases: within EXACT_ATOL of the port's float64
    result and within JAX_ATOL of the JAX package's, but for the
    zero-size box, whose overlap is 0 in the port (as in the reference's
    CUDA) and the other box's area in the JAX package."""
    a, b = _iou_inputs()
    if name == 'boxes_iou3d_paired':
        a = a[:b.shape[0]]
    fn = getattr(ops, name)
    got = fn(_t(a), _t(b)).numpy()
    exact = fn(_t(a).double(), _t(b).double()).numpy()
    want = np.asarray(jax.jit(getattr(jax_boxes, name))(jnp.asarray(a),
                                                        jnp.asarray(b)))
    np.testing.assert_allclose(got, exact, rtol=0, atol=EXACT_ATOL)
    keep = np.ones(got.shape, bool)
    keep[..., 4] = False                            # the zero-size box
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=JAX_ATOL)
    assert (got[..., 4] == 0).all()
    if name in ('boxes_overlap_bev', 'boxes_iou_bev'):
        assert (want[..., 4] > 0).any()
    diag = got.diagonal() if got.ndim == 2 else got
    assert (diag[6:20] > 0).sum() >= 12 and diag[2] < EXACT_ATOL


EDGE_CASES = {
    # (a, b, BEV IoU, 3D IoU)
    'identical': ([1, 2, 0, 4, 2, 1.5, 0.3], [1, 2, 0, 4, 2, 1.5, 0.3],
                  1.0, 1.0),
    'contained': ([0, 0, 0, 4, 2, 2, 0.3], [0, 0, 0, 2, 1, 1, 0.3],
                  0.25, 0.125),
    'touching': ([0, 0, 0, 2, 2, 1, 0], [2, 0, 0, 2, 2, 1, 0], 0.0, 0.0),
    'turned_square': ([0, 0, 0, 2, 2, 1, 0], [0, 0, 0, 2, 2, 1, np.pi / 2],
                      1.0, 1.0),
    'turned_rectangle': ([0, 0, 0, 4, 2, 1, 0],
                         [0, 0, 0, 4, 2, 1, np.pi / 2], 1 / 3, 1 / 3),
    'padding': ([0, 0, 0, 4, 2, 1, 0], [0] * 7, 0.0, 0.0),
    'collinear_edge': ([0, 0, 0, 2, 2, 1, 0], [1, 0.5, 0, 2, 1, 1, 0],
                       0.2, 0.2),
    'shared_edge_inside': ([0, 0, 0, 2, 2, 1, 0], [0, 0.5, 0, 2, 1, 1, 0],
                           0.5, 0.5),
}


@pytest.mark.parametrize('case', sorted(EDGE_CASES))
def test_exact_iou_edge_cases(case):
    """The analytic IoU of each edge case in both packages, but for the
    BEV IoU of the zero-size padding box, no IoU in the JAX package
    (ROADMAP Queue 3; its 3D IoU is 0 by the zero height). The sort-free
    IoU of the NMS
    double-counts the coincident edges of identical boxes."""
    a, b, bev, iou3d = EDGE_CASES[case]
    a, b = (np.asarray([x], np.float32) for x in (a, b))
    for fn, want in (('boxes_iou_bev', bev), ('boxes_iou3d', iou3d)):
        got = float(getattr(ops, fn)(_t(a), _t(b))[0, 0])
        jax_got = float(getattr(jax_boxes, fn)(a, b)[0, 0])
        assert got == pytest.approx(want, abs=EXACT_ATOL), fn
        if case == 'padding' and fn == 'boxes_iou_bev':
            assert jax_got > 1, fn
        else:
            assert jax_got == pytest.approx(want, abs=JAX_ATOL), fn
    if case == 'identical':
        assert float(ops.boxes_iou_bev_fast(_t(a), _t(b))[0, 0]) > 1.5


# ------------------------------------------------- RoI matching, sampling

def _roi_frame(seed):
    """(R, 7) RoIs (jittered gt, wider copies and far boxes), (R,) labels
    and valid mask, (T, 8) gt with padding rows."""
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, 10, pad=3)
    rois = np.concatenate([_jitter(rng, gt[:7], 0.1),
                           _jitter(rng, gt[:7], 0.4),
                           _boxes(rng, 18)])[:, :7]
    labels = np.concatenate([gt[:7, 7], gt[:7, 7],
                             rng.integers(1, 4, 18)]).astype(np.int64)
    labels[3] = labels[3] % 3 + 1                   # wrong class: no match
    rois[8] = rois[1]                               # a tie in IoU
    valid = np.ones(32, bool)
    valid[-4:] = False
    rois[-4:] = 0.0
    return rois, labels, valid, gt


def test_max_iou_with_same_class_matches_jax():
    """Own class only, padding gt never, clipped at 0, the first gt on
    ties: gt indices identical, IoUs within JAX_ATOL; the zero-size RoIs
    past a frame's proposals match nothing (0; in the JAX package they
    take a gt's area over 1e-6, and only a frame without one valid RoI
    samples them)."""
    rois, labels, valid, gt = _roi_frame(1)
    gt[5] = gt[4]                                   # duplicate gt: a tie
    iou, idx = roi_utils.max_iou_with_same_class(_t(rois), _t(labels), _t(gt))
    jiou, jidx = jax.jit(jax_roi.max_iou_with_same_class)(
        rois, labels.astype(np.int32), gt)
    iou, idx = iou.numpy(), idx.numpy()
    np.testing.assert_array_equal(idx[valid], np.asarray(jidx)[valid])
    np.testing.assert_allclose(iou[valid], np.asarray(jiou)[valid],
                               rtol=0, atol=JAX_ATOL)
    assert (iou[~valid] == 0).all() and (iou >= 0).all()
    assert (iou[valid] == 0).any() and (iou > 0.5).any()
    assert (idx[iou > 0] < 7).all()


def _jax_frame_draws(key, R, M):
    """The JAX package's draws of one frame (``subsample_rois``): uniform
    (R,) from k1, integers in [0, 2^30) from k2 and k3."""
    k1, k2, k3 = jax.random.split(key, 3)
    return roi_utils.RoiDraws(
        _t(jax.random.uniform(k1, (R,))),
        _t(jax.random.randint(k2, (M,), 0, 2 ** 30)).long(),
        _t(jax.random.randint(k3, (M,), 0, 2 ** 30)).long())


def _jax_draws(key, B_, R, M):
    """The draws of ``proposal_target_layer(key, ...)``: one
    ``_jax_frame_draws`` a frame of ``split(key, B)``."""
    frames = [_jax_frame_draws(k, R, M) for k in jax.random.split(key, B_)]
    return roi_utils.RoiDraws(*(torch.stack(t) for t in zip(*frames)))


def _target_cfg(**kw):
    return EDict(dict(tiny_pointrcnn_cfg().ROI_HEAD.TARGET_CONFIG,
                      ROI_PER_IMAGE=24, **kw))


SUBSAMPLE_BRANCHES = {
    # IoUs by pool: fg >= 0.55, hard in [0.1, 0.55), easy < 0.1
    'mixed': [0.9] * 5 + [0.3] * 8 + [0.05] * 15,
    'fg_only': [0.7] * 6 + [0.95] * 4,
    'no_fg': [0.3] * 6 + [0.01] * 20,
    'hard_only': [0.8] * 3 + [0.2] * 9,
    'easy_only': [0.6] * 20 + [0.0] * 7,
    'no_valid': [],
}


@pytest.mark.parametrize('branch', sorted(SUBSAMPLE_BRANCHES))
def test_subsample_rois_matches_jax(branch):
    """``subsample_rois`` with the JAX package's draws in each branch:
    indices identical, and each slot in the pool its branch gives it."""
    R = 32
    rng = np.random.default_rng(2)
    ious = np.zeros(R, np.float32)
    vals = np.asarray(SUBSAMPLE_BRANCHES[branch], np.float32)
    perm = rng.permutation(R)[:len(vals)]
    ious[perm] = vals + rng.uniform(0, 0.01, len(vals)).astype(np.float32)
    valid = np.zeros(R, bool)
    valid[perm] = True
    cfg = _target_cfg()
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda k, m, v: jax_roi.subsample_rois(
        k, m, v, cfg))(key, ious, valid))
    got = roi_utils.subsample_rois(_t(ious), _t(valid),
                                   _jax_frame_draws(key, R, 24), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    picked = ious[got.numpy()]
    if branch == 'mixed':
        assert (picked[:5] >= 0.55).all() and (picked[5:] < 0.55).all()
    elif branch == 'fg_only':
        assert (picked >= 0.55).all() and valid[got.numpy()].all()
    elif branch == 'no_valid':
        assert (got == got[0]).all()
    else:
        assert valid[got.numpy()].all()


def _targets_inputs(seed):
    """B frames of ``_roi_frame`` as batched arrays."""
    frames = [_roi_frame(seed + b) for b in range(B)]
    return [np.stack(x) for x in zip(*frames)]


@pytest.mark.parametrize('score_type', ['cls', 'roi_iou'])
def test_proposal_target_layer_matches_jax(score_type):
    """Every field of the RoI targets, with the JAX package's draws: the
    sampled RoIs, labels, scores and gt identical (gathers of the same
    indices), the gt in each RoI's frame and the labels within tolerance
    (a rotation by the RoI's heading; libm's sin and cos against XLA's)."""
    rois, labels, valid, gt = _targets_inputs(3)
    scores = np.random.default_rng(4).uniform(size=labels.shape).astype(
        np.float32)
    cfg = _target_cfg(CLS_SCORE_TYPE=score_type)
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda k, *a: jax_roi.proposal_target_layer(k, *a, cfg))(
        key, rois, scores, labels.astype(np.int32), valid, gt)
    got = roi_utils.proposal_target_layer(
        _jax_draws(key, B, rois.shape[1], 24), _t(rois), _t(scores),
        _t(labels), _t(valid), _t(gt), cfg)
    for field in ('rois', 'roi_labels', 'roi_scores', 'gt_of_rois_src',
                  'reg_valid_mask'):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ('gt_iou_of_rois', 'rcnn_cls_labels'):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=JAX_ATOL, err_msg=field)
    np.testing.assert_allclose(got.gt_of_rois.numpy(),
                               np.asarray(want.gt_of_rois), rtol=1e-5,
                               atol=1e-5)
    assert got.reg_valid_mask.any() and (~got.reg_valid_mask).any()
    assert got.gt_of_rois[..., 6].abs().max() <= np.pi / 2 + 1e-6
    if score_type == 'cls':
        assert set(got.rcnn_cls_labels.unique().tolist()) <= {-1.0, 0.0, 1.0}


# ------------------------------------------------------ the heads' losses

def _point_coder(mod):
    cfg = tiny_pointrcnn_cfg().POINT_HEAD.TARGET_CONFIG
    return mod.build_box_coder(cfg.BOX_CODER, **dict(cfg.BOX_CODER_CONFIG))


def test_point_head_targets_and_loss_match_jax():
    """``assign_targets_iassd`` as the point head calls it (the ignore band
    of GT_EXTRA_WIDTH, ``PointResidualCoder`` box labels) and
    ``point_head_box_loss`` on the same predictions: labels identical,
    box labels and both terms within tolerance."""
    rng = np.random.default_rng(7)
    gt = np.stack([_boxes(rng, 8, pad=2) for _ in range(B)])
    local = rng.uniform(-0.65, 0.65, (B, 200, 3)).astype(np.float32)
    pick = rng.integers(0, 6, (B, 200))
    box = np.take_along_axis(gt, pick[..., None], 1)
    c, s = np.cos(box[..., 6]), np.sin(box[..., 6])
    lx, ly = local[..., 0] * box[..., 3], local[..., 1] * box[..., 4]
    pts = np.stack([lx * c - ly * s + box[..., 0], lx * s + ly * c +
                    box[..., 1], local[..., 2] * box[..., 5] + box[..., 2]],
                   -1).astype(np.float32)
    cls_preds = rng.normal(size=(B, 200, 3)).astype(np.float32)
    box_preds = rng.normal(0, 0.5, (B, 200, 8)).astype(np.float32)
    head = tiny_pointrcnn_cfg().POINT_HEAD
    ext = head.TARGET_CONFIG.GT_EXTRA_WIDTH

    targets = target_assign.assign_targets_iassd(
        _t(pts), _t(gt), box_utils.enlarge_box3d(_t(gt), ext),
        set_ignore_flag=True, ret_box_labels=True,
        box_coder=_point_coder(box_coder), num_class=3)
    loss, tb = point_head_box.point_head_box_loss(
        {'targets': targets, 'point_cls_preds': _t(cls_preds),
         'point_box_preds_raw': _t(box_preds)}, head.LOSS_CONFIG, 3)

    def jax_loss(pts, gt, cls_preds, box_preds):
        t = jax_assign.assign_targets_iassd(
            pts, gt, jax_box_utils.enlarge_box3d(gt, ext),
            set_ignore_flag=True, ret_box_labels=True,
            box_coder=_point_coder(jax_box_coder), num_class=3)
        return t, jax_phb.point_head_box_loss(
            {'targets': t, 'point_cls_preds': cls_preds,
             'point_box_preds_raw': box_preds}, head.LOSS_CONFIG, 3)
    jt, (jloss, jtb) = jax.jit(jax_loss)(pts, gt, cls_preds, box_preds)
    np.testing.assert_array_equal(targets.cls_labels.numpy(),
                                  np.asarray(jt.cls_labels))
    assert (targets.cls_labels == -1).any() and (targets.cls_labels > 0).any()
    np.testing.assert_allclose(targets.box_labels.numpy(),
                               np.asarray(jt.box_labels), rtol=1e-5,
                               atol=1e-5)
    assert set(tb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


def test_pointrcnn_head_loss_matches_jax():
    """``pointrcnn_head_loss`` term by term on the same RoI targets (made
    by each package from the same draws) and predictions, every term
    non-zero."""
    rois, labels, valid, gt = _targets_inputs(9)
    cfg = tiny_pointrcnn_cfg().ROI_HEAD
    tcfg = _target_cfg()
    M = tcfg.ROI_PER_IMAGE
    rng = np.random.default_rng(10)
    rcnn_cls = rng.normal(size=(B, M, 1)).astype(np.float32)
    rcnn_reg = rng.normal(0, 0.2, (B, M, 7)).astype(np.float32)
    preds = _jitter(rng, gt[:, :1].repeat(M, 1), 0.1)[..., :7]
    key = jax.random.PRNGKey(11)

    def jax_loss(key, rois, labels, valid, gt, rcnn_cls, rcnn_reg, preds):
        t = jax_roi.proposal_target_layer(key, rois, labels * 0.0, labels,
                                          valid, gt, tcfg)
        ret = {'targets': t, 'rcnn_cls': rcnn_cls, 'rcnn_reg': rcnn_reg,
               'batch_box_preds': preds}
        return jax_rcnn.pointrcnn_head_loss(
            ret, cfg.LOSS_CONFIG, jax_box_coder.build_box_coder(
                cfg.TARGET_CONFIG.BOX_CODER))
    jloss, jtb = jax.jit(jax_loss)(key, rois, labels.astype(np.int32), valid,
                                   gt, rcnn_cls, rcnn_reg, preds)
    t = roi_utils.proposal_target_layer(
        _jax_draws(key, B, rois.shape[1], M), _t(rois), _t(labels) * 0.0,
        _t(labels), _t(valid), _t(gt), tcfg)
    loss, tb = pointrcnn_head.pointrcnn_head_loss(
        {'targets': t, 'rcnn_cls': _t(rcnn_cls), 'rcnn_reg': _t(rcnn_reg),
         'batch_box_preds': _t(preds)}, cfg.LOSS_CONFIG,
        box_coder.build_box_coder(cfg.TARGET_CONFIG.BOX_CODER))
    assert set(tb) == set(jtb) == {'rcnn_loss_cls', 'rcnn_loss_reg',
                                   'rcnn_loss_corner', 'rcnn_loss'}
    for k in jtb:
        assert float(jtb[k]) > 0, k
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


# ------------------------------------- the tiny model: variables, scenes

def _variables(jm, points):
    """Flax variables of ``jm`` from numpy (the tree of ``init`` by
    ``eval_shape``, no compile): He-normal kernels, N(0, 0.1) biases, BN
    scales in [0.5, 1.5] and running statistics off their identity."""
    shapes = jax.eval_shape(lambda p: jm.init(jax.random.PRNGKey(0),
                                              {'points': p}, train=False),
                            points)
    rng = np.random.default_rng(SEED)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            v = rng.normal(0, np.sqrt(2.0 / shape[0]), shape)
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    # the box outputs of both heads at 1e-2 (the reference initializes the
    # RoI head's with std 0.001): at full scale the exp of their size
    # channels makes boxes of up to ~700 m, whose differences between the
    # packages grow with them
    params = variables['params']
    for head, tower in (('point_head', 'box_layers'),
                        ('roi_head', 'reg_layers')):
        out = params[head][tower]['Dense_0']
        for leaf in ('kernel', 'bias'):
            out[leaf] = out[leaf] * np.float32(1e-2)
    return variables


def _gt_at_proposals(model, batch):
    """Each scene's gt boxes plus three boxes near the RoIs a train-mode
    forward of (a copy of) ``model`` proposes, with their labels, so that
    the step samples foreground RoIs and the regression and corner terms
    are not zero (the proposals do not depend on the gt)."""
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        out = probe.roi_head.proposal_layer(probe.point_head(
            probe.backbone_3d(dict(batch))))
    rois, _, labels, _ = out
    extra = torch.cat([rois[:, :3], labels[:, :3, None].float()], dim=-1)
    rng = np.random.default_rng(12)
    extra = _t(_jitter(rng, extra.numpy(), 0.02))
    return torch.cat([batch['gt_boxes'], extra], dim=1)


def _head_key(jm, variables, step):
    """The key the JAX RoI head's ``make_rng('roi_sampling')`` gives at
    ``step``."""
    return jm.apply(variables, method=lambda m: m.roi_head.make_rng(
        'roi_sampling'), rngs={'roi_sampling': jax.random.fold_in(
            jax.random.PRNGKey(17), step)})


@pytest.fixture(scope='module')
def tiny():
    jm = jax_build_detector(jax_tiny_cfg(), num_class=3)
    pts, gt = synthetic_scene_batch(SEED, B, N)
    # a tenth of KITTI's range: at 70 m the two packages' three-NN squared
    # distances differ by ~1 ulp of |a|^2 (4.9e-4 m^2; XLA fuses them into
    # FMAs), which moves the FP features by ~1e-4 relative
    pts[..., :3] *= SCENE_SCALE
    gt[..., :6] *= SCENE_SCALE
    variables = _variables(jm, pts)
    model = load_flax(build_detector(tiny_pointrcnn_cfg(), 3, device='cpu'),
                      variables)
    batch = {'points': _t(pts), 'gt_boxes': _t(gt)}
    batch['gt_boxes'] = _gt_at_proposals(model, batch)
    key = _head_key(jm, variables, 0)
    return {'jm': jm, 'variables': variables, 'model': model,
            'batch': batch, 'key': key}


@pytest.fixture
def jax_draws(tiny, monkeypatch):
    """The port's RoI draws replaced by the JAX package's at step 0."""
    def draws(generator, B_, R, M, device):
        assert isinstance(generator, torch.Generator)
        return _jax_draws(tiny['key'], B_, R, M)
    monkeypatch.setattr(pointrcnn_head, 'draw_roi_sampling', draws)


# ---------------------------------------- the RoI head's train branch

@pytest.fixture(scope='module')
def roi_stage(tiny):
    """The RoI head of each package in training on the same stage-1
    inputs (the port's train-mode backbone and point head), with the same
    draws; the gradient of the RoI loss with respect to the point head's
    boxes, the proposals' source."""
    jm, variables, model = tiny['jm'], tiny['variables'], tiny['model']
    model = copy.deepcopy(model).train()
    with torch.no_grad():
        s1 = model.point_head(model.backbone_3d(dict(tiny['batch'])))
    keys = ('point_coords', 'point_features', 'point_cls_scores',
            'batch_cls_preds', 'gt_boxes')
    stage1 = {k: s1[k].numpy() for k in keys}
    boxes = s1['batch_box_preds'].numpy()
    cfg = jax_tiny_cfg().ROI_HEAD
    jcoder = jax_box_coder.build_box_coder(cfg.TARGET_CONFIG.BOX_CODER)

    def jax_roi_loss(boxes, variables):
        out, _ = jm.apply(variables, dict(stage1, batch_box_preds=boxes),
                          method=lambda m, b: m.roi_head(b, train=True),
                          mutable=['batch_stats'],
                          rngs={'roi_sampling': jax.random.fold_in(
                              jax.random.PRNGKey(17), 0)})
        ret = out['roi_head_ret']
        loss, tb = jax_rcnn.pointrcnn_head_loss(ret, cfg.LOSS_CONFIG, jcoder)
        return loss, (tb, ret)
    (jloss, (jtb, jret)), jgrad = jax.jit(jax.value_and_grad(
        jax_roi_loss, has_aux=True))(boxes, variables)

    own = pointrcnn_head.draw_roi_sampling
    pointrcnn_head.draw_roi_sampling = \
        lambda g, B_, R, M, d: _jax_draws(tiny['key'], B_, R, M)
    try:
        box_in = _t(boxes).requires_grad_(True)
        batch = {k: _t(v) for k, v in stage1.items()}
        batch.update(batch_box_preds=box_in, cls_preds_normalized=False,
                     rngs=step_rngs(0))
        out = model.roi_head(batch)
    finally:
        pointrcnn_head.draw_roi_sampling = own
    loss, tb = pointrcnn_head.pointrcnn_head_loss(
        out['roi_head_ret'], tiny_pointrcnn_cfg().ROI_HEAD.LOSS_CONFIG,
        model.roi_head.box_coder)
    loss.backward()
    return {'jtb': jtb, 'jret': jret, 'jgrad': np.asarray(jgrad),
            'tb': tb, 'ret': out['roi_head_ret'], 'grad': box_in.grad,
            'out': out}


def test_roi_head_targets_match_jax(roi_stage):
    """The proposals (NMS_CONFIG.TRAIN), the sampled RoIs and their targets
    identical or within tolerance, foreground among them; rcnn_cls,
    rcnn_reg and every loss term within tolerance."""
    t, jt = roi_stage['ret']['targets'], roi_stage['jret']['targets']
    for field in ('roi_labels', 'gt_of_rois_src', 'reg_valid_mask'):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(jt, field)),
                                      err_msg=field)
    for field in ('rois', 'gt_of_rois', 'gt_iou_of_rois', 'rcnn_cls_labels'):
        np.testing.assert_allclose(getattr(t, field).detach().numpy(),
                                   np.asarray(getattr(jt, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    assert t.reg_valid_mask.any()
    nms = tiny_pointrcnn_cfg().ROI_HEAD.NMS_CONFIG
    assert roi_stage['out']['roi_valid'].shape[1] == \
        tiny_pointrcnn_cfg().ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE
    assert nms.TRAIN.NMS_POST_MAXSIZE != nms.TEST.NMS_POST_MAXSIZE
    for key in ('rcnn_cls', 'rcnn_reg', 'batch_box_preds'):
        np.testing.assert_allclose(roi_stage['ret'][key].detach().numpy(),
                                   np.asarray(roi_stage['jret'][key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for k, v in roi_stage['jtb'].items():
        assert float(v) > 0, k
        np.testing.assert_allclose(float(roi_stage['tb'][k].detach()),
                                   float(v), rtol=LOSS_RTOL, err_msg=k)


def test_gradient_through_the_rois_matches_jax(roi_stage):
    """The JAX package lets the RoIs carry gradient (its NMS gathers the
    point boxes without ``stop_gradient``), so the RoI loss reaches the
    point head's boxes: non-zero in both packages and equal within
    GRAD_RTOL of its largest entry."""
    want, got = roi_stage['jgrad'], roi_stage['grad'].numpy()
    scale = float(np.abs(want).max())
    assert scale > 0 and np.count_nonzero(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * scale)
    assert np.array_equal(got != 0, want != 0)


# ------------------------------------------------------ one train step

@pytest.fixture(scope='module')
def one_step(tiny):
    """One train step of each package from the same variables, scenes and
    RoI draws. The JAX optimizer is chained behind a transform that keeps
    the raw gradients as its state; the port's gradients come from a
    forward and backward of its own, its update from ``make_train_step``
    on a second copy. The share of the point head's box-layer gradient
    that comes through the RoIs, |g_rcnn| / (|g_rcnn| + |g_point|), is
    taken from the port's own backward of each stage's loss alone."""
    jm, variables, batch = tiny['jm'], tiny['variables'], tiny['batch']
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(keep, jax_optim.build_optimizer(EDict(OPTIM), 10, 2))
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    new_state, metrics = jax_make_train_step(jm, tx)(
        state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})

    own = pointrcnn_head.draw_roi_sampling
    pointrcnn_head.draw_roi_sampling = \
        lambda g, B_, R, M, d: _jax_draws(tiny['key'], B_, R, M)
    try:
        model = copy.deepcopy(tiny['model']).train()
        out = model(dict(batch, rngs=step_rngs(0)))
        loss, tb = model.loss(out)
        box_params = list(model.point_head.box_layers.parameters())
        via_rois = torch.autograd.grad(tb['rcnn_loss'], box_params,
                                       retain_graph=True)
        via_points = torch.autograd.grad(
            tb['point_loss_cls'] + tb['point_loss_box'], box_params,
            retain_graph=True)
        loss.backward()
        model2 = copy.deepcopy(tiny['model'])
        opt = optimization.build_optimizer(EDict(OPTIM), model2.parameters(),
                                           10, 2)
        loss2, tb2 = make_train_step(model2, opt)(batch)
    finally:
        pointrcnn_head.draw_roi_sampling = own

    def norm(gs):
        return float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))
    return {
        'jax_metrics': {k: float(v) for k, v in metrics.items()},
        'jax_grads': flax_to_torch({'params': _np_tree(
            new_state.opt_state[0])}),
        'jax_state': flax_to_torch({
            'params': _np_tree(new_state.params),
            'batch_stats': _np_tree(new_state.batch_stats)}),
        'init': flax_to_torch(variables),
        'tb': {k: float(v.detach()) for k, v in tb.items()},
        'loss': float(loss.detach()),
        'step_tb': {k: float(v) for k, v in tb2.items()},
        'step_loss': float(loss2),
        'grads': {n: p.grad for n, p in model.named_parameters()},
        'state': model2.state_dict(), 'opt': opt,
        'roi_share': norm(via_rois) / (norm(via_rois) + norm(via_points)),
    }


def test_train_step_loss_terms_match_jax(one_step):
    """The JAX package's tb keys, every term within LOSS_RTOL, the
    regression and corner terms among the non-zero ones."""
    jm = one_step['jax_metrics']
    assert set(jm) == {'loss', 'point_loss_cls', 'point_loss_box',
                       'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss_corner',
                       'rcnn_loss'}
    for tb, loss in ((one_step['tb'], one_step['loss']),
                     (one_step['step_tb'], one_step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert all(v > 0 for v in jm.values())


def test_train_step_gradients_match_jax(one_step):
    """Every parameter's gradient within GRAD_RTOL of its largest entry;
    the point head's box layers take a share of theirs through the RoIs
    (the RoI loss alone, port side)."""
    want = {k: v for k, v in one_step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(one_step['grads']) == set(want)
    for name, g in one_step['grads'].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
    assert 0 < one_step['roi_share'] < 1


def _first_step_slack(grads, jax_grads, lr, max_norm):
    """Per parameter entry, how far apart the first AdamW step of the two
    packages moves it from their gradients alone: lr * |u - u'|, u = c g /
    (|c g| + eps) for each package's gradient g and global-norm clip factor
    c. It vanishes where |g| >> eps; an entry whose gradient lies within the
    packages' difference of zero may move up to 2 lr apart."""
    def units(gs):
        norm = np.sqrt(sum(float((g.double() ** 2).sum())
                           for g in gs.values()))
        c = min(1.0, max_norm / norm)
        return {k: c * g.double() / (c * g.double().abs() + ADAM_EPS)
                for k, g in gs.items()}
    u = units(grads)
    v = units({k: jax_grads[k] for k in grads})
    return {k: (lr * (u[k] - v[k]).abs()).float() for k in u}


def test_train_step_updates_params_and_bn_stats_as_jax(one_step):
    """Parameters after the step within STEP_ATOL plus each entry's
    first-step slack; BN running means and variances, which move by a tenth
    of the batch's statistics, within STEP_ATOL + RTOL."""
    state, want, init = one_step['state'], one_step['jax_state'], \
        one_step['init']
    opt = one_step['opt']
    slack = _first_step_slack(one_step['grads'], one_step['jax_grads'],
                              opt.lr_fn(0), opt.max_norm)
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        diff = (state[name] - w).abs()
        bound = STEP_ATOL + slack.get(name, torch.zeros(()))
        if name.endswith(('running_mean', 'running_var')):
            bound = bound + RTOL * w.abs()
        assert (diff <= bound).all(), (
            f'{name}: {int((diff > bound).sum())} entries beyond the bound, '
            f'largest difference {float(diff.max()):.3e}')
        assert not torch.equal(state[name], init[name]), f'{name} unchanged'
    assert one_step['opt'].count == 1
    assert float(one_step['opt'].grad_norm) > 0


# ------------------------------------------------ the step's generators

def test_dropout_follows_the_step_generator():
    """At DP_RATIO 0.5 the towers' masks come from the step's 'dropout'
    generator: the same step seed gives the same output, another step
    another; eval mode is the identity, and so is p = 0, which draws
    nothing."""
    head = MLPHead(16, [32, 32], 4, dropout=0.5, dropout_idx=(0,))
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    head.train()
    a = head(x, step_rngs(3)['dropout'])
    b = head(x, step_rngs(3)['dropout'])
    c = head(x, step_rngs(4)['dropout'])
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match='generator'):
        head(x)
    head.eval()
    ref = head(x)
    assert torch.equal(head(x, step_rngs(3)['dropout']), ref)
    assert torch.equal(torch.nn.Sequential(*head)(x), ref)
    plain = MLPHead(16, [32], 4, dropout=0.0, dropout_idx=(0,)).train()
    gen = step_rngs(3)['dropout']
    before = gen.get_state()
    plain(x, gen)
    assert torch.equal(gen.get_state(), before)
    rngs = [step_rngs(s) for s in range(3)]
    seeds = {g.initial_seed() for r in rngs for g in r.values()}
    assert len(seeds) == 6


class _Scenes:
    """One batch of tiny scenes an epoch."""

    def __init__(self, epoch=0):
        self.epoch = epoch

    def __iter__(self):
        pts, gt = synthetic_scene_batch(300 + self.epoch, B, N)
        self.epoch += 1
        yield {'points': pts, 'gt_boxes': gt, 'frame_id': ['a', 'b']}


def _trainer(path):
    cfg = EDict({'MODEL': tiny_pointrcnn_cfg(),
                 'OPTIMIZATION': dict(OPTIM, NUM_EPOCHS=2)})
    model = build_detector(cfg.MODEL, 3, device='cpu',
                           generator=torch.Generator().manual_seed(1))
    return Trainer(cfg, model, path, total_iters_each_epoch=1)


def test_trainer_resumes_the_same_roi_draws(tmp_path, monkeypatch):
    """PointRCNN trains through the ``Trainer``: two epochs of one step
    straight through, and one epoch, a new trainer that resumes and the
    second epoch. Each step draws from its update count, so the resumed
    step draws the same RoIs and the weights end equal."""
    seen = []
    own = pointrcnn_head.draw_roi_sampling

    def recording(generator, *args):
        draws = own(generator, *args)
        seen.append(draws)
        return draws
    monkeypatch.setattr(pointrcnn_head, 'draw_roi_sampling', recording)
    straight = _trainer(tmp_path / 'a')
    assert straight.train(_Scenes()) == 2
    through = list(seen)
    seen.clear()
    first = _trainer(tmp_path / 'b')
    first.total_epochs = 1
    assert first.train(_Scenes()) == 1
    again = _trainer(tmp_path / 'b')
    assert again.maybe_resume() == 1 and again.optimizer.count == 1
    assert again.train(_Scenes(epoch=1), start_epoch=1) == 2
    assert len(through) == 2 and len(seen) == 2
    for a, b in zip(through, seen):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(through[0].rand, through[1].rand)
    for (name, a), b in zip(straight.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(a, b), name
