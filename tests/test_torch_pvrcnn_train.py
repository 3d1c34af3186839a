"""The port's PV-RCNN and SECOND training against the JAX package on the
CPU.

The modules of the voxel detectors' train path one by one on seeded numpy
inputs (the anchors' thresholds, the nearest-BEV IoU, the anchor targets,
``anchor_head_loss``, the point head's targets and loss, the BEV
backbone's and the sparse backbone's BatchNorm statistics), the RoI-grid
head's train branch on the same stage inputs with the JAX package's RoI
draws, and one ``adam_onecycle`` step of the tiny PV-RCNN
(``tiny_pvrcnn_cfg``, the two frames of ``tests/test_pvrcnn.py``'s
``make_pv_batch`` with gt boxes near their anchors) and of the tiny SECOND
through each package's ``make_train_step`` from the same flax variables.
The RoI draws are the JAX package's: the port's ``draw_roi_sampling`` is
replaced by the numbers JAX draws from the key its RoI head sees. Index
outputs must be identical; floats stay within the tolerances stated
below. Then the entry a user calls: ``voxel_batch(mode='train')`` with gt
boxes, ``build_detector_from_cfg`` and a ``Trainer`` that resumes.
"""
import contextlib
import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.backbones_2d.base_bev_backbone import \
    BaseBEVBackbone as JaxBEV
from spsnet_tpu.models.backbones_3d.spconv_backbone import \
    VoxelBackBone8x as JaxVoxelBackBone
from spsnet_tpu.models.dense_heads import anchor_head as jax_anchor_head
from spsnet_tpu.models.dense_heads import point_head_simple as jax_phs
from spsnet_tpu.models.dense_heads import target_assign as jax_assign
from spsnet_tpu.models.roi_heads import pointrcnn_head as jax_rcnn
from spsnet_tpu.runtime import optimization as jax_optim
from spsnet_tpu.runtime.trainer import TrainState
from spsnet_tpu.runtime.trainer import make_train_step as jax_make_train_step
from spsnet_tpu.utils import box_coder as jax_box_coder
from spsnet_tpu.utils import box_utils as jax_box_utils
from spsnet_torch import zoo
from spsnet_torch.config import EDict
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.data.processor.sparse_plan import (build_sparse_plan,
                                                     plan_final_grid)
from spsnet_torch.data.processor.voxelize import sparse_grid_zyx
from spsnet_torch.models import build_detector, build_detector_from_cfg
from spsnet_torch.models.backbones_2d.base_bev_backbone import \
    BaseBEVBackbone
from spsnet_torch.models.backbones_3d.spconv_backbone import (
    VoxelBackBone8x, sparse_gather)
from spsnet_torch.models.dense_heads import anchor_head, point_head_simple
from spsnet_torch.models.dense_heads import target_assign
from spsnet_torch.models.roi_heads import pointrcnn_head
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.trainer import Trainer, make_train_step, step_rngs
from spsnet_torch.utils import box_coder, box_utils
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_pvrcnn import PCR, VS, make_pv_batch
from tests.test_torch_pointrcnn_train import (_first_step_slack, _jax_draws,
                                              _np_tree)
from tests.test_torch_pvrcnn import _Holder, _second_cfg

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, SEED = 2, 4
OPTIM = {'BATCH_SIZE_PER_GPU': B, 'NUM_EPOCHS': 2,
         'OPTIMIZER': 'adam_onecycle', 'LR': 0.01, 'WEIGHT_DECAY': 0.01,
         'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
         'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [1, 2], 'LR_DECAY': 0.1,
         'LR_CLIP': 0.0000001, 'GRAD_NORM_CLIP': 10}
# the anchor IoU, its masks and maxima are elementwise fp32 ops in the same
# order in both packages: equal bit for bit op by op, within an ulp or two
# where XLA fuses them under jit; the residual coder's log (libm against
# XLA) may differ by an ulp
IOU_ATOL, REG_ATOL = 1e-6, 1e-5
# features, predictions and loss terms of the tiny models: fp32 sums in
# another order (XLA:CPU against the CPU BLAS and oneDNN), ~1e-7 relative a
# layer, grown by BatchNorm's 1/std in training
RTOL, ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-4
# gradients, per tensor against its largest entry (BatchNorm's 1/std
# carries the forward's differences back through every layer), and the
# RoI loss's gradient at the anchor head's box layer
GRAD_RTOL = 1e-3
# parameters after one step: Adam's first update is lr * sign(g) wherever
# |g| >> eps, but for the slack of ``_first_step_slack``; BN running
# statistics move by momentum times the batch's statistics
STEP_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, pad=0, classes=(1, 2, 3)):
    """(n, 8) boxes in a 20 m square with KITTI-like sizes, headings in
    [-pi, pi], classes drawn from ``classes``, the last ``pad`` rows
    zero."""
    boxes = np.zeros((n, 8), np.float32)
    k = n - pad
    boxes[:k, 0:2] = rng.uniform(-10, 10, (k, 2))
    boxes[:k, 2] = rng.uniform(-2, 0, k)
    boxes[:k, 3:6] = rng.uniform([0.6, 0.5, 1.4], [4.2, 1.8, 1.8], (k, 3))
    boxes[:k, 6] = rng.uniform(-np.pi, np.pi, k)
    boxes[:k, 7] = rng.choice(classes, k)
    return boxes


# ------------------------------------------------------------- anchors

def _kitti_agc(align_center=False):
    agc = [dict(c) for c in zoo.pv_rcnn_kitti_cfg().MODEL.DENSE_HEAD.
           ANCHOR_GENERATOR_CONFIG]
    for c in agc:
        c['align_center'] = align_center
    return agc


@pytest.mark.parametrize('align_center', [False, True])
def test_anchor_thresholds_are_identical_to_jax(align_center):
    """pv_rcnn.yaml's three classes: the anchors, each slot's class and its
    matched / unmatched thresholds (0.6 / 0.45 Car, 0.5 / 0.35 the
    others), exact."""
    args = (_kitti_agc(align_center), (1408, 1600, 40),
            (0, -40, -3, 70.4, 40, 1), 8)
    got = anchor_head.generate_anchors(*args)
    want = jax_anchor_head.generate_anchors(*args)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(got[2], np.float32([0.6] * 2 + [0.5] * 4))
    np.testing.assert_array_equal(got[3],
                                  np.float32([0.45] * 2 + [0.35] * 4))


def _heading_boxes(rng):
    """Boxes with headings at and within a few ulps of +-pi/4 and +-3 pi/4
    (where the envelope swaps dx and dy), at multiples of pi/2 and
    random."""
    quarter = np.float32(np.pi / 4)
    special = []
    for base in (quarter, -quarter, 3 * quarter, -3 * quarter):
        special += [base, np.nextafter(base, np.float32(10)),
                    np.nextafter(base, np.float32(-10)), base + 1e-3,
                    base - 1e-3]
    special += [0.0, np.pi / 2, -np.pi / 2, np.pi, 2 * np.pi - 1e-4]
    boxes = _boxes(rng, len(special) + 20)[:, :7]
    boxes[:len(special), 6] = np.float32(special)
    return boxes


def test_nearest_bev_iou_matches_jax():
    """The axis-aligned BEV IoU of boxes with headings at and around
    +-pi/4 and +-3pi/4 against random boxes and against themselves,
    within IOU_ATOL of the JAX package's; the envelope swap at pi/4 decided
    alike."""
    rng = np.random.default_rng(0)
    a = _heading_boxes(rng)
    b = np.concatenate([a[:10], _boxes(rng, 30)[:, :7]])
    b[:10, 0:2] += rng.normal(0, 0.3, (10, 2)).astype(np.float32)
    got = anchor_head.nearest_bev_iou(_t(a), _t(b)).numpy()
    want = np.asarray(jax.jit(jax_anchor_head.nearest_bev_iou)(a, b))
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    # op by op (no FMA contraction) the two packages agree bit for bit
    np.testing.assert_array_equal(
        got, np.asarray(jax_anchor_head.nearest_bev_iou(a, b)))
    env = anchor_head._aligned_bev_boxes(_t(a)).numpy()
    jenv = np.asarray(jax_anchor_head._aligned_bev_boxes(a))
    np.testing.assert_array_equal(env, jenv)
    assert (got > 0.1).sum() >= 10 and (got == 0).any()


def _assign_case(case):
    """(anchors (N, 7), classes, matched, unmatched thresholds, gt (B, T,
    8)) for one target-assignment case."""
    rng = np.random.default_rng({'force_match': 1, 'no_positive_overlap': 2,
                                 'padded_gt': 3, 'two_classes': 4,
                                 'iou_tie': 5}[case])
    xs, ys = np.meshgrid(np.arange(-8, 8.1, 1.0), np.arange(-8, 8.1, 1.0))
    n = xs.size
    anchors = np.zeros((n, 2, 2, 7), np.float32)
    sizes = np.float32([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73]])
    for c in range(2):
        for r, rot in enumerate((0.0, 1.57)):
            anchors[:, c, r, 0] = xs.ravel()
            anchors[:, c, r, 1] = ys.ravel()
            anchors[:, c, r, 2] = -1.0
            anchors[:, c, r, 3:6] = sizes[c]
            anchors[:, c, r, 6] = rot
    anchors = anchors.reshape(-1, 7)
    cls = np.tile(np.int32([1, 1, 2, 2]), n)
    matched = np.tile(np.float32([0.6, 0.6, 0.5, 0.5]), n)
    unmatched = np.tile(np.float32([0.45, 0.45, 0.35, 0.35]), n)
    gt = np.stack([_boxes(rng, 6, pad=1, classes=(1,)) for _ in range(B)])
    gt[..., 0:2] *= 0.7
    if case == 'force_match':
        # a thin box no anchor reaches 0.45 with: only the force match
        gt[0, 0] = [0.3, 0.2, -1.0, 1.0, 0.3, 1.5, 0.1, 1]
    elif case == 'no_positive_overlap':
        gt[0, 0] = [30.0, 30.0, -1.0, 3.9, 1.6, 1.5, 0.0, 1]
    elif case == 'padded_gt':
        gt[1, 2:] = 0.0
    elif case == 'two_classes':
        gt[:, ::2, 7] = 2
        gt[:, ::2, 3:6] = [0.8, 0.6, 1.7]
    elif case == 'iou_tie':
        # a 2 x 2 square on the anchors at (2, -3): their two rotations'
        # envelopes (3.9 x 1.6 and 1.6 x 3.9) meet it in the same IoU, in
        # the ignore band, so only the force match labels them; two copies
        # of a car on the anchor at (-2, 3), headings pi apart: every
        # anchor's IoU with both ties, and the first gt wins
        gt[0, 0] = [2.0, -3.0, -1.0, 2.0, 2.0, 1.5, 0.0, 1]
        gt[1, 0] = [-2.0, 3.0, -1.0, 3.9, 1.6, 1.56, 0.05, 1]
        gt[1, 1] = gt[1, 0]
        gt[1, 1, 6] += np.pi
    return anchors, cls, matched, unmatched, gt


@pytest.mark.parametrize('case', ['force_match', 'no_positive_overlap',
                                  'padded_gt', 'two_classes', 'iou_tie'])
def test_assign_anchor_targets_matches_jax(case):
    """``assign_anchor_targets`` over the batch against the JAX package's
    vmapped one: labels and matched gt identical, regression targets within
    REG_ATOL; the case's feature present (a label only a force match
    gives, a gt with no anchor, padding, anchors of two classes, a tie
    resolved to the first gt)."""
    anchors, cls, matched, unmatched, gt = _assign_case(case)
    coder = box_coder.build_box_coder('ResidualCoder')
    labels, reg, reg_w, gt_idx, force = anchor_head.assign_anchor_targets(
        _t(anchors), _t(cls), _t(matched), _t(unmatched), _t(gt), coder)
    jcoder = jax_box_coder.build_box_coder('ResidualCoder')
    # op by op: under jit XLA:CPU contracts the union's area_a + area_b
    # into an FMA, which moves an IoU by an ulp and breaks its exact ties
    # otherwise than the separately rounded ops of the port (and the card)
    jl, jr, jw, ja = jax.vmap(
        lambda g: jax_anchor_head.assign_anchor_targets(
            jnp.asarray(anchors), cls, matched, unmatched, g, jcoder, 2))(gt)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    fg = labels.numpy() > 0
    np.testing.assert_array_equal(gt_idx.numpy()[fg], np.asarray(ja)[fg])
    np.testing.assert_array_equal(reg_w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(reg.numpy(), np.asarray(jr), rtol=0,
                               atol=REG_ATOL)
    iou = anchor_head.nearest_bev_iou(_t(anchors), _t(gt[..., :7])).numpy()
    assert fg.any() and (labels.numpy() == 0).any()
    car = cls == 1
    if case == 'force_match':
        thin = gt_idx.numpy()[0] == 0
        assert (fg[0] & thin & force.numpy()[0]).sum() >= 1
        assert iou[0][car, 0].max() < 0.45
    elif case == 'no_positive_overlap':
        assert not (gt_idx.numpy()[0][fg[0]] == 0).any()
        assert iou[0][:, 0].max() == 0
    elif case == 'padded_gt':
        assert not (gt_idx.numpy()[1][fg[1]] >= 2).any()
    elif case == 'two_classes':
        assert set(np.unique(labels.numpy())) == {-1, 0, 1, 2}
    elif case == 'iou_tie':
        best = iou[0][car, 0] == iou[0][car, 0].max()
        assert best.sum() == 2 and 0.45 < iou[0][car, 0].max() < 0.6
        assert force.numpy()[0][car][best].all()
        assert (labels.numpy()[0][car][best] == 1).all()
        both = (iou[1][:, 0] == iou[1][:, 1]) & (iou[1][:, 0] > 0.6)
        assert both.sum() >= 1 and (gt_idx.numpy()[1][both] == 0).all()


@pytest.mark.parametrize('use_dir', [True, False])
def test_anchor_head_loss_matches_jax(use_dir):
    """``anchor_head_loss`` term by term on the targets of the two-class
    case and random predictions, with and without direction logits; every
    term non-zero and within LOSS_RTOL."""
    anchors, cls, matched, unmatched, gt = _assign_case('two_classes')
    coder = box_coder.build_box_coder('ResidualCoder')
    labels, reg, reg_w, _, _ = anchor_head.assign_anchor_targets(
        _t(anchors), _t(cls), _t(matched), _t(unmatched), _t(gt), coder)
    rng = np.random.default_rng(6)
    n = anchors.shape[0]
    preds = {'cls_preds': rng.normal(size=(B, n, 2)),
             'box_preds': rng.normal(0, 0.3, (B, n, 7)),
             'dir_preds': rng.normal(size=(B, n, 2)) if use_dir else None}
    preds = {k: None if v is None else v.astype(np.float32)
             for k, v in preds.items()}
    targets = {'box_cls_labels': labels.numpy(),
               'box_reg_targets': reg.numpy(), 'reg_weights': reg_w.numpy(),
               'anchors': anchors}
    head_cfg = zoo.pv_rcnn_kitti_cfg().MODEL.DENSE_HEAD
    loss_cfg = head_cfg.LOSS_CONFIG
    dirs = (int(head_cfg.NUM_DIR_BINS), float(head_cfg.DIR_OFFSET))
    loss, tb = anchor_head.anchor_head_loss(
        {k: None if v is None else _t(v)
         for k, v in {**preds, **targets}.items()}, loss_cfg, 2, *dirs)
    jloss, jtb = jax.jit(lambda r: jax_anchor_head.anchor_head_loss(
        r, StaticConfig(JaxEDict(loss_cfg)), 2,
        jax_box_coder.build_box_coder('ResidualCoder'), *dirs))(
        {**preds, **targets})
    keys = {'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss'} | (
        {'rpn_loss_dir'} if use_dir else set())
    assert set(tb) == set(jtb) == keys
    for k in keys:
        assert float(jtb[k]) > 0, k
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


# ------------------------------------------------------ the point head

def test_point_head_simple_targets_and_loss_match_jax():
    """The keypoints' binary targets (``assign_targets_iassd`` with the
    ignore band of GT_EXTRA_WIDTH) identical, ``point_head_simple_loss``
    within LOSS_RTOL; foreground, background and ignored keypoints all
    present."""
    rng = np.random.default_rng(7)
    gt = np.stack([_boxes(rng, 6, pad=1) for _ in range(B)])
    local = rng.uniform(-0.62, 0.62, (B, 300, 3)).astype(np.float32)
    pick = rng.integers(0, 5, (B, 300))
    box = np.take_along_axis(gt, pick[..., None], 1)
    c, s = np.cos(box[..., 6]), np.sin(box[..., 6])
    lx, ly = local[..., 0] * box[..., 3], local[..., 1] * box[..., 4]
    pts = np.stack([lx * c - ly * s + box[..., 0], lx * s + ly * c +
                    box[..., 1], local[..., 2] * box[..., 5] + box[..., 2]],
                   -1).astype(np.float32)
    cls_preds = rng.normal(size=(B, 300, 1)).astype(np.float32)
    head = zoo.pv_rcnn_kitti_cfg().MODEL.POINT_HEAD
    ext = head.TARGET_CONFIG.GT_EXTRA_WIDTH
    targets = target_assign.assign_targets_iassd(
        _t(pts), _t(gt), box_utils.enlarge_box3d(_t(gt), ext),
        set_ignore_flag=True, num_class=1, binary_label=True)
    loss, tb = point_head_simple.point_head_simple_loss(
        {'targets': targets, 'point_cls_preds': _t(cls_preds)},
        head.LOSS_CONFIG)

    def jax_loss(pts, gt, cls_preds):
        t = jax_assign.assign_targets_iassd(
            pts, gt, jax_box_utils.enlarge_box3d(gt, ext),
            set_ignore_flag=True, num_class=1, binary_label=True)
        return t, jax_phs.point_head_simple_loss(
            {'targets': t, 'point_cls_preds': cls_preds},
            StaticConfig(JaxEDict(head.LOSS_CONFIG)))
    jt, (jloss, jtb) = jax.jit(jax_loss)(pts, gt, cls_preds)
    np.testing.assert_array_equal(targets.cls_labels.numpy(),
                                  np.asarray(jt.cls_labels))
    assert set(np.unique(targets.cls_labels.numpy())) == {-1, 0, 1}
    assert set(tb) == set(jtb) == {'point_loss_cls'}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tb['point_loss_cls']),
                               float(jtb['point_loss_cls']), rtol=LOSS_RTOL)


# ------------------------------------------- BatchNorm in the backbones

def test_bev_batchnorm_running_stats_follow_flax():
    """A train-mode forward of a BEV backbone (a stride-2 level and a
    stride-2 deblock) on a small map moves every BatchNorm's running mean
    and variance as flax's ``nn.BatchNorm`` does, toward the biased
    variance: within STEP_ATOL of the JAX package's batch_stats, where
    ``nn.BatchNorm2d``'s unbiased rule lands further off than that."""
    cfg = JaxEDict({'LAYER_NUMS': [1, 1], 'LAYER_STRIDES': [1, 2],
                    'NUM_FILTERS': [6, 8], 'UPSAMPLE_STRIDES': [1, 2],
                    'NUM_UPSAMPLE_FILTERS': [5, 5]})
    x = np.random.default_rng(8).normal(1.0, 2.0, (2, 2, 4, 3)).astype(
        np.float32)
    jm = JaxBEV(model_cfg=StaticConfig(cfg), input_channels=3)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, f: jm.init(k, {'spatial_features': f}, train=False))(
            jax.random.PRNGKey(2), x)))
    out, mut = jax.jit(lambda v, f: jm.apply(
        v, {'spatial_features': f}, train=True, mutable=['batch_stats']))(
        variables, x)
    port = _Holder(backbone_2d=BaseBEVBackbone(cfg, 3))
    load_flax(port, {c: {'backbone_2d': t} for c, t in variables.items()})
    port.train()
    unbiased = copy.deepcopy(port)
    for m in unbiased.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.forward = torch.nn.BatchNorm2d.forward.__get__(m)
    feats = {'spatial_features': _t(x.transpose(0, 3, 1, 2))}
    got = port.backbone_2d(feats)['spatial_features_2d']
    unbiased.backbone_2d(feats)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(out['spatial_features_2d']).transpose(0, 3, 1, 2),
        rtol=RTOL, atol=ATOL)
    want = flax_to_torch({
        'params': {'backbone_2d': variables['params']},
        'batch_stats': {'backbone_2d': _np_tree(mut['batch_stats'])}})
    state, other = port.state_dict(), unbiased.state_dict()
    n_stats = 0
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            assert int(state[name]) == 1, name
            continue
        if not name.endswith(('running_mean', 'running_var')):
            continue
        np.testing.assert_allclose(state[name].numpy(), w.numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
        if name.endswith('running_var'):
            assert float((other[name] - w).abs().max()) > 10 * STEP_ATOL, \
                name
            n_stats += 1
    assert n_stats == 6


def test_batch_norm_on_the_cpu_normalises_large_batches_accurately():
    """``BatchNormLast`` in training on 442 368 rows (the RoI-grid pool of
    a PV-RCNN train step at B = 2) whose channel means lie up to 9x their
    spread: within 1e-6 relative L2 of a float64 BatchNorm (1.4e-7
    measured), where the CPU's ``F.batch_norm``, summing the statistics
    in fp32 row after row, is 6.3e-6 off; the running statistics follow
    the batch's biased variance."""
    from spsnet_torch.models.blocks import BatchNormLast
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(442368, 64, generator=gen) + \
        9 * torch.rand(1, 64, generator=gen)
    bn = BatchNormLast(64).train()
    with torch.no_grad():
        y = bn(x).double()
    x64 = x.double()
    var, mean = torch.var_mean(x64, dim=0, unbiased=False)
    want = (x64 - mean) / torch.sqrt(var + bn.eps)
    assert float((y - want).norm() / want.norm()) < 1e-6
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * var).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * mean).numpy(), rtol=1e-6, atol=1e-7)


def _clustered_frames(rng, V=64, n=40):
    """B frames of n voxels in a 6^3 block of the (64, 16, 16) grid of
    ``make_pv_batch``, padded to V rows, with their VoxelBackBone8x plan
    (the port's copy of the JAX package's): padded rows at every level."""
    grid = (64, 16, 16)
    frames = []
    for _ in range(B):
        base = rng.integers(0, 10, 3)
        coords = np.unique(base + rng.integers(0, 6, (3 * n, 3)), axis=0)
        coords = coords[rng.permutation(len(coords))[:n]]
        pad = np.zeros((V, 3), np.int64)
        pad[:n] = coords
        valid = np.arange(V) < n
        plan = build_sparse_plan(pad, valid, grid, max_voxels_per_level=V)
        plan.pop('final_grid')
        frames.append(dict(plan, voxel_coords=pad, voxel_valid=valid))
    return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


def test_sparse_backbone_bn_statistics_include_padded_rows():
    """The sparse backbone's BatchNorm normalises every one of a level's
    V rows, the padded ones (which read only the zero row) too, as the
    JAX package's ``SparseConv`` does: the running statistics after a
    train-mode forward of clustered frames (padded rows at every level)
    within STEP_ATOL of JAX's, and the first layer's running mean the
    average over all rows, not the valid rows' alone."""
    rng = np.random.default_rng(9)
    inp = _clustered_frames(rng)
    valid = inp['voxel_valid']
    for key in ('voxel_valid', 'down2_valid', 'down3_valid', 'down4_valid'):
        assert (~inp[key]).any(), f'no padded row in {key}'
    inp['voxel_features'] = (rng.normal(size=(B, valid.shape[1], 4)) *
                             valid[..., None]).astype(np.float32)
    jm = JaxVoxelBackBone(model_cfg=StaticConfig(JaxEDict({})),
                          input_channels=4)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(3),
                                                   inp)))
    jout, mut = jax.jit(lambda v, b: jm.apply(
        v, b, train=True, mutable=['batch_stats']))(variables, inp)
    port = _Holder(backbone_3d=VoxelBackBone8x(4))
    load_flax(port, {c: {'backbone_3d': t} for c, t in variables.items()})
    port.train()
    out = port.backbone_3d({k: _t(v) for k, v in inp.items()})
    np.testing.assert_allclose(
        out['encoded_voxel_features'].detach().numpy(),
        np.asarray(jout['encoded_voxel_features']), rtol=RTOL, atol=ATOL)
    want = flax_to_torch({
        'params': {'backbone_3d': variables['params']},
        'batch_stats': {'backbone_3d': _np_tree(mut['batch_stats'])}})
    state = port.state_dict()
    for name, w in want.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                       rtol=RTOL, atol=STEP_ATOL,
                                       err_msg=name)
    layer = port.backbone_3d.conv_input
    with torch.no_grad():
        g = sparse_gather(_t(inp['voxel_features']), _t(inp['subm1_table']))
        pre = layer[0](g.reshape(*g.shape[:2], -1))
    assert (pre[_t(~valid)] == 0).all()
    m = layer[1].momentum
    every = m * pre.reshape(-1, pre.shape[-1]).mean(0)
    only_valid = m * pre[_t(valid)].mean(0)
    np.testing.assert_allclose(state['backbone_3d.conv_input.1.running_mean'],
                               every.numpy(), rtol=RTOL, atol=1e-7)
    assert float((every - only_valid).abs().max()) > 100 * STEP_ATOL * m


# ------------------------------------- the tiny PV-RCNN: variables, batch

def _variables(jm, batch):
    """Flax variables of ``jm`` from numpy (the tree of ``init`` by
    ``eval_shape``, no compile): He-normal kernels, N(0, 0.1) biases, BN
    scales in [0.5, 1.5] and running statistics off their identity; the
    anchor head's box layer at 0.05 and the RoI head's box output at 1e-2
    (the exp of the size channels would otherwise make boxes many times
    their anchors', whose differences between the packages grow with
    them)."""
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False), batch)
    rng = np.random.default_rng(SEED)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            v = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        elif name == 'scale':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 2.0, shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, shape)
        return v.astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    params = variables['params']
    scaled = [(params['dense_head']['conv_box'], 0.05)] \
        if 'conv_box' in params.get('dense_head', {}) else []
    if 'reg_layers' in params.get('roi_head', {}):
        scaled.append((params['roi_head']['reg_layers']['Dense_0'], 1e-2))
    for layer, factor in scaled:
        for leaf in ('kernel', 'bias'):
            layer[leaf] = layer[leaf] * np.float32(factor)
    return variables


def _gt_near_proposals(model, batch):
    """Each frame's gt boxes plus three boxes near the proposals a
    train-mode forward of (a copy of) ``model`` makes at NMS_CONFIG.TRAIN
    (near their anchors), with their labels, so that anchors take positive
    and force-matched labels and the RoI loss's regression and corner
    terms are not zero (the proposals do not depend on the gt)."""
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        rois, _, labels, _ = pointrcnn_head.proposal_layer(
            probe.stage_one(dict(batch)),
            model.model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
    rng = np.random.default_rng(12)
    extra = rois[:, :3].numpy().copy()
    n = extra.shape[:-1]
    extra[..., 0:3] += rng.normal(0, 0.02, n + (3,)) * extra[..., 3:6]
    extra[..., 3:6] *= np.exp(rng.normal(0, 0.02, n + (3,)))
    extra[..., 6] += rng.normal(0, 0.02, n)
    extra = np.concatenate([extra, labels[:, :3, None].numpy()], -1)
    return torch.cat([batch['gt_boxes'], _t(extra.astype(np.float32))], 1)


def _head_key(jm, variables, step):
    """The key the JAX RoI head's ``make_rng('roi_sampling')`` gives at
    ``step``."""
    return jm.apply(variables, method=lambda m: m.roi_head.make_rng(
        'roi_sampling'), rngs={'roi_sampling': jax.random.fold_in(
            jax.random.PRNGKey(17), step)})


@pytest.fixture(scope='module')
def tiny():
    batch, final_zyx = make_pv_batch(np.random.default_rng(0))
    batch = {k: np.array(v) for k, v in batch.items()}
    final_zyx = tuple(int(v) for v in final_zyx)
    cfg = zoo.tiny_pvrcnn_cfg(final_zyx)
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=final_zyx)
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    model = load_flax(build_detector(cfg, 1, device='cpu', voxel_size=VS,
                                     point_cloud_range=PCR,
                                     final_grid_zyx=final_zyx), variables)
    batch = {k: _t(v) for k, v in batch.items()}
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    return {'jm': jm, 'variables': variables, 'model': model, 'cfg': cfg,
            'batch': batch, 'key': _head_key(jm, variables, 0),
            'final_zyx': final_zyx}


def _port_forward(tiny):
    """A train-mode forward of a copy of the port's model with the JAX
    package's RoI draws of step 0: (model, out, loss, tb)."""
    model = copy.deepcopy(tiny['model']).train()
    own = pointrcnn_head.draw_roi_sampling
    pointrcnn_head.draw_roi_sampling = \
        lambda g, B_, R, M, d: _jax_draws(tiny['key'], B_, R, M)
    try:
        out = model(dict(tiny['batch'], rngs=step_rngs(0)))
    finally:
        pointrcnn_head.draw_roi_sampling = own
    loss, tb = model.loss(out)
    return model, out, loss, tb


@pytest.fixture(scope='module')
def forward(tiny):
    """Each package's train-mode forward of the tiny PV-RCNN with the same
    variables and RoI draws: the targets of each head, the RoI head's
    outputs and loss terms, and the gradient of the RoI loss alone at the
    anchor head's box layer (the RoIs are its decoded boxes)."""
    jm, variables = tiny['jm'], tiny['variables']
    batch = {k: v.numpy() for k, v in tiny['batch'].items()}
    other = {k: v for k, v in variables.items() if k != 'params'}

    def rcnn_loss(params, batch):
        out, _ = jm.apply({'params': params, **other}, batch, train=True,
                          mutable=['batch_stats'],
                          rngs={'roi_sampling': jax.random.fold_in(
                              jax.random.PRNGKey(17), 0)})
        loss, tb = jm.apply({'params': params, **other}, out,
                            method='loss')
        ret = out['roi_head_ret']
        keep = {'anchor': out['anchor_head_ret'],
                'point': out['point_head_simple_ret']['targets'],
                'roi': {k: ret[k] for k in ('rcnn_cls', 'rcnn_reg', 'rois',
                                            'targets', 'batch_box_preds')}}
        return tb['rcnn_loss'], (loss, tb, keep)
    (_, (jloss, jtb, jkeep)), jgrad = jax.jit(jax.value_and_grad(
        rcnn_loss, has_aux=True))(variables['params'], batch)
    model, out, loss, tb = _port_forward(tiny)
    conv_box = list(model.dense_head.conv_box.parameters())
    grad = torch.autograd.grad(tb['rcnn_loss'], conv_box)
    return {'jloss': float(jloss), 'jtb': {k: float(v) for k, v in
                                           jtb.items()},
            'jkeep': jkeep, 'jgrad': jgrad['dense_head']['conv_box'],
            'loss': float(loss.detach()),
            'tb': {k: float(v.detach()) for k, v in tb.items()},
            'out': out, 'grad': grad}


def test_anchor_and_point_targets_in_the_train_forward_match_jax(forward):
    """The anchor head's labels identical (positives and force matches
    among them) and its regression targets within REG_ATOL; the
    keypoints' labels identical, foreground among them."""
    ret, jret = forward['out']['anchor_head_ret'], forward['jkeep']['anchor']
    labels = ret['box_cls_labels'].numpy()
    np.testing.assert_array_equal(labels, np.asarray(jret['box_cls_labels']))
    np.testing.assert_array_equal(ret['reg_weights'].numpy(),
                                  np.asarray(jret['reg_weights']))
    np.testing.assert_allclose(ret['box_reg_targets'].numpy(),
                               np.asarray(jret['box_reg_targets']), rtol=0,
                               atol=REG_ATOL)
    assert (labels > 0).any() and (labels == 0).any()
    t = forward['out']['point_head_simple_ret']['targets']
    np.testing.assert_array_equal(t.cls_labels.numpy(),
                                  np.asarray(forward['jkeep']['point']
                                             .cls_labels))
    assert (t.cls_labels > 0).any()


def test_roi_head_train_branch_matches_jax(forward):
    """With the JAX package's draws, the proposals at NMS_CONFIG.TRAIN
    within tolerance, the sampled RoIs' labels, gt and regression mask
    identical, foreground among them; rcnn_cls, rcnn_reg and the refined
    boxes within tolerance; every loss term of the step within
    LOSS_RTOL, the RoI loss's regression and corner terms non-zero."""
    ret, jret = forward['out']['roi_head_ret'], forward['jkeep']['roi']
    t, jt = ret['targets'], jret['targets']
    for field in ('roi_labels', 'gt_of_rois_src', 'reg_valid_mask'):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(jt, field)),
                                      err_msg=field)
    for field in ('rois', 'gt_of_rois', 'gt_iou_of_rois', 'rcnn_cls_labels'):
        np.testing.assert_allclose(getattr(t, field).detach().numpy(),
                                   np.asarray(getattr(jt, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    assert t.reg_valid_mask.any()
    cfg = zoo.tiny_pvrcnn_cfg((2, 2, 2)).ROI_HEAD
    assert t.rois.shape[1] == cfg.TARGET_CONFIG.ROI_PER_IMAGE
    for key in ('rcnn_cls', 'rcnn_reg', 'batch_box_preds'):
        np.testing.assert_allclose(ret[key].detach().numpy(),
                                   np.asarray(jret[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    jtb, tb = forward['jtb'], forward['tb']
    assert set(tb) == set(jtb)
    for k, v in jtb.items():
        np.testing.assert_allclose(tb[k], v, rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(forward['loss'], forward['jloss'],
                               rtol=LOSS_RTOL)
    assert jtb['rcnn_loss_reg'] > 0 and jtb['rcnn_loss_corner'] > 0


def test_roi_loss_gradient_at_conv_box_matches_jax(forward):
    """The JAX package lets the RoIs carry gradient (its NMS gathers the
    anchor head's decoded boxes without ``stop_gradient``), so the RoI loss
    alone reaches the anchor head's ``conv_box``: non-zero in both
    packages and equal within GRAD_RTOL of its largest entry."""
    jgrad = forward['jgrad']
    want = {'weight': np.asarray(jgrad['kernel']).transpose(3, 2, 0, 1),
            'bias': np.asarray(jgrad['bias'])}
    for name, got in zip(('weight', 'bias'), forward['grad']):
        w = want[name].reshape(got.shape)
        scale = float(np.abs(w).max())
        assert scale > 0 and got.abs().max() > 0, name
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


# ------------------------------------------------------ one train step

def _one_step(jm, variables, model, batch, draws=None, jax_float64=False):
    """One train step of each package from the same variables and batch
    (and, with ``draws``, the RoI draws of step 0 for the port). The JAX
    optimizer is chained behind a transform that keeps the raw gradients as
    its state; the port's gradients come from a forward and backward of
    its own, its update from ``make_train_step`` on a second copy. With
    ``jax_float64`` the JAX step runs on float64 copies of the variables
    and the batch (``jax.enable_x64``): the reference where JAX's fp32
    backward departs from the float64 gradient."""
    def cast(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if jax_float64 and
                           a.dtype == np.float32 else a)
    with jax.enable_x64(True) if jax_float64 else contextlib.nullcontext():
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda updates, state, params=None: (updates, updates))
        tx = optax.chain(keep, jax_optim.build_optimizer(EDict(OPTIM), 10,
                                                         2))
        params = jax.tree_util.tree_map(cast, variables['params'])
        state = TrainState(
            params=params,
            batch_stats=jax.tree_util.tree_map(cast,
                                               variables['batch_stats']),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        new_state, metrics = jax_make_train_step(jm, tx)(
            state, {k: cast(v.numpy()) for k, v in batch.items()})

    own = pointrcnn_head.draw_roi_sampling
    if draws is not None:
        pointrcnn_head.draw_roi_sampling = draws
    try:
        model1 = copy.deepcopy(model).train()
        loss, tb = model1.loss(model1(dict(batch, rngs=step_rngs(0))))
        loss.backward()
        model2 = copy.deepcopy(model)
        opt = optimization.build_optimizer(EDict(OPTIM), model2.parameters(),
                                           10, 2)
        loss2, tb2 = make_train_step(model2, opt)(batch)
    finally:
        pointrcnn_head.draw_roi_sampling = own
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
        'grads': {n: p.grad for n, p in model1.named_parameters()},
        'state': model2.state_dict(), 'opt': opt,
    }


@pytest.fixture(scope='module')
def pv_step(tiny):
    return _one_step(tiny['jm'], tiny['variables'], tiny['model'],
                     tiny['batch'], lambda g, B_, R, M, d: _jax_draws(
                         tiny['key'], B_, R, M))


@pytest.fixture(scope='module')
def second_step(tiny):
    """The tiny SECOND (the PV-RCNN's voxel stack and anchor head) on the
    same batch, without its points."""
    cfg = _second_cfg(tiny['final_zyx'])
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=1,
                            voxel_size=VS, point_cloud_range=PCR,
                            final_grid_zyx=tiny['final_zyx'])
    batch = {k: v for k, v in tiny['batch'].items() if k != 'points'}
    variables = _variables(jm, {k: v.numpy() for k, v in batch.items()
                                if k != 'gt_boxes'})
    model = load_flax(build_detector(cfg, 1, device='cpu', voxel_size=VS,
                                     point_cloud_range=PCR,
                                     final_grid_zyx=tiny['final_zyx']),
                      variables)
    return _one_step(jm, variables, model, batch)


STEP_KEYS = {
    'pv': {'loss', 'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
           'rpn_loss', 'point_loss_cls', 'rcnn_loss_cls', 'rcnn_loss_reg',
           'rcnn_loss_corner', 'rcnn_loss'},
    'second': {'loss', 'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
               'rpn_loss'}}


@pytest.mark.parametrize('which', ['pv', 'second'])
def test_train_step_loss_terms_match_jax(which, request):
    """The JAX package's tb keys, every term within LOSS_RTOL and non-zero
    (the anchor head's box and direction terms among them)."""
    step = request.getfixturevalue(f'{which}_step')
    jm = step['jax_metrics']
    assert set(jm) == STEP_KEYS[which]
    for tb, loss in ((step['tb'], step['loss']),
                     (step['step_tb'], step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert all(v > 0 for v in jm.values())


@pytest.mark.parametrize('which', ['pv', 'second'])
def test_train_step_gradients_match_jax(which, request):
    """Every parameter's gradient within GRAD_RTOL of its largest entry,
    none of them zero."""
    step = request.getfixturevalue(f'{which}_step')
    want = {k: v for k, v in step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(step['grads']) == set(want)
    for name, g in step['grads'].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


@pytest.mark.parametrize('which', ['pv', 'second'])
def test_train_step_updates_params_and_bn_stats_as_jax(which, request):
    """Parameters after the step within STEP_ATOL plus each entry's
    first-step slack; BN running means and variances (the BEV backbone's
    with flax's biased-variance rule, the sparse backbone's over padded
    rows) within STEP_ATOL + RTOL; every one of them moved."""
    step = request.getfixturevalue(f'{which}_step')
    state, want, init = step['state'], step['jax_state'], step['init']
    opt = step['opt']
    slack = _first_step_slack(step['grads'], step['jax_grads'],
                              opt.lr_fn(0), opt.max_norm)
    n_bev = 0
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        diff = (state[name] - w).abs()
        bound = STEP_ATOL + slack.get(name, torch.zeros(()))
        if name.endswith(('running_mean', 'running_var')):
            bound = bound + RTOL * w.abs()
            n_bev += name.startswith('backbone_2d')
        assert (diff <= bound).all(), (
            f'{name}: {int((diff > bound).sum())} entries beyond the bound, '
            f'largest difference {float(diff.max()):.3e}')
        assert not torch.equal(state[name], init[name]), f'{name} unchanged'
    assert n_bev == 6 and opt.count == 1


# ------------------------------------------- the entry a user calls

def _tiny_experiment(dp_ratio=0.0):
    """A full experiment config of the tiny PV-RCNN on ``make_pv_batch``'s
    geometry: DATA_CONFIG with the voxelization (train limit 96 voxels)
    and the plan, MODEL and OPTIMIZATION, as pv_rcnn.yaml lays them out."""
    data = EDict({
        'POINT_CLOUD_RANGE': list(PCR),
        'POINT_FEATURE_ENCODING': {
            'used_feature_list': ['x', 'y', 'z', 'intensity']},
        'DATA_PROCESSOR': [
            {'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': list(VS),
             'MAX_POINTS_PER_VOXEL': 5,
             'MAX_NUMBER_OF_VOXELS': {'train': 96, 'test': 160}},
            {'NAME': 'build_sparse_conv_plan', 'PLAN': 'backbone8x'}]})
    model = zoo.tiny_pvrcnn_cfg(plan_final_grid(sparse_grid_zyx(PCR, VS)))
    model.ROI_HEAD.DP_RATIO = dp_ratio
    return EDict({'CLASS_NAMES': ['Car'], 'DATA_CONFIG': data,
                  'MODEL': model, 'OPTIMIZATION': OPTIM})


def _scenes(seed, n_points=512):
    """B synthetic scenes in PCR: scans and their per-frame gt boxes, the
    second frame with two boxes fewer."""
    pts, gt = synthetic_scene_batch(seed, B, n_points, pc_range=PCR,
                                    n_clusters=6)
    return pts, [gt[0], gt[1][:4]]


def test_voxel_batch_carries_the_gt_boxes():
    """``voxel_batch(mode='train')`` takes the train voxel limit and
    collates the frames' gt boxes as (B, T, 8) float32, the shorter frame
    padded with zero rows; ``device_batch`` moves them with the rest."""
    from spsnet_torch.runtime.trainer import device_batch
    cfg = _tiny_experiment()
    pts, gt = _scenes(20)
    batch = voxel_batch(pts, cfg.DATA_CONFIG, mode='train', gt_boxes=gt)
    assert batch['gt_boxes'].shape == (B, 6, 8)
    assert batch['gt_boxes'].dtype == np.float32
    np.testing.assert_array_equal(batch['gt_boxes'][0], gt[0])
    np.testing.assert_array_equal(batch['gt_boxes'][1, :4], gt[1])
    assert (batch['gt_boxes'][1, 4:] == 0).all()
    assert batch['voxels'].shape[1] == 96
    assert batch['voxel_valid'].sum(1).max() == 96
    test = voxel_batch(pts, cfg.DATA_CONFIG)
    assert 'gt_boxes' not in test and test['voxels'].shape[1] == 160
    moved = device_batch(batch, 'cpu')
    assert torch.equal(moved['gt_boxes'], torch.from_numpy(
        batch['gt_boxes']))
    with pytest.raises(ValueError, match='gt box arrays'):
        voxel_batch(pts, cfg.DATA_CONFIG, mode='train', gt_boxes=gt[:1])


class _VoxelScenes:
    """One voxel batch of tiny scenes an epoch."""

    def __init__(self, cfg, epoch=0):
        self.cfg, self.epoch = cfg, epoch

    def __iter__(self):
        pts, gt = _scenes(300 + self.epoch)
        self.epoch += 1
        batch = voxel_batch(pts, self.cfg.DATA_CONFIG, mode='train',
                            gt_boxes=gt)
        yield dict(batch, frame_id=['a', 'b'])


def _trainer(cfg, path):
    model = build_detector_from_cfg(
        cfg, device='cpu', generator=torch.Generator().manual_seed(1))
    return Trainer(cfg, model, path, total_iters_each_epoch=1)


def test_trainer_resumes_the_same_roi_draws_and_dropout(tmp_path,
                                                        monkeypatch):
    """The tiny PV-RCNN experiment (DP_RATIO 0.3) trains through
    ``build_detector_from_cfg`` and the ``Trainer``: two epochs of one step
    straight through, and one epoch, a new trainer that resumes and the
    second epoch. Each step draws its RoIs and dropout masks from its
    update count, so the resumed step draws the same and the weights end
    equal."""
    cfg = _tiny_experiment(dp_ratio=0.3)
    seen = []
    own = pointrcnn_head.draw_roi_sampling

    def recording(generator, *args):
        draws = own(generator, *args)
        seen.append(draws)
        return draws
    monkeypatch.setattr(pointrcnn_head, 'draw_roi_sampling', recording)
    straight = _trainer(cfg, tmp_path / 'a')
    assert straight.train(_VoxelScenes(cfg)) == 2
    through = list(seen)
    seen.clear()
    first = _trainer(cfg, tmp_path / 'b')
    first.total_epochs = 1
    assert first.train(_VoxelScenes(cfg)) == 1
    again = _trainer(cfg, tmp_path / 'b')
    assert again.maybe_resume() == 1 and again.optimizer.count == 1
    assert again.train(_VoxelScenes(cfg, epoch=1), start_epoch=1) == 2
    assert len(through) == 2 and len(seen) == 2
    for a, b in zip(through, seen):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(through[0].rand, through[1].rand)
    for (name, a), b in zip(straight.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_pv_rcnn_yaml_trains_at_full_width_on_a_cropped_range():
    """pv_rcnn.yaml at its full channel widths through
    ``build_detector_from_cfg(cfg).train()`` and ``make_train_step`` on a
    ``voxel_batch(mode='train')`` with gt boxes, cut in scale: the
    cropped range of tests/test_torch_pvrcnn.py, 1000 voxels, 256
    keypoints, 64 / 16 proposals before / after the train NMS, 16 RoIs a
    frame, three of the gt boxes near proposals. The loss and every
    gradient finite, every parameter moved."""
    cfg = zoo.pv_rcnn_kitti_cfg()
    crop = (0, -6.4, -3, 12.8, 6.4, 1)
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
    step = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
            if p.NAME == 'transform_points_to_voxels'][0]
    step.MAX_NUMBER_OF_VOXELS.train = 1000
    cfg.MODEL.PFE.NUM_KEYPOINTS = 256
    cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 64
    cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 16
    cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
    pts, gt = synthetic_scene_batch(21, B, 2048, pc_range=crop,
                                    n_clusters=6)
    gt[:, :, 7] = np.arange(6) % 3 + 1
    batch = {k: torch.from_numpy(v) for k, v in voxel_batch(
        pts, cfg.DATA_CONFIG, mode='train', gt_boxes=list(gt)).items()}
    model = build_detector_from_cfg(cfg, device='cpu').train()
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = optimization.build_optimizer(cfg.OPTIMIZATION, model.parameters(),
                                       10, 2)
    loss, tb = make_train_step(model, opt)(batch)
    assert set(tb) == STEP_KEYS['pv'] - {'loss'}
    assert torch.isfinite(loss) and all(torch.isfinite(v) for v in
                                        tb.values())
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert not torch.equal(p.detach(), before[name]), name
