"""The port's IA-SSD train step against the JAX package on the CPU.

One ``adam_onecycle`` step of the tiny IA-SSD on two synthetic scenes with
gt boxes: the JAX package's ``make_train_step`` with flax variables from a
fixed key, and the port's ``make_train_step`` after ``load_flax`` of the same
variables. Both run fp32; the port's matmuls and reductions sum in another
order than XLA:CPU, so each float comparison states its tolerance. The parts
of the step (box ops, the coder, target assignment, losses, schedules,
clipping, checkpoints) are held one by one on numpy inputs as well.
"""
import os
import signal

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as fnn

from spsnet_tpu import ops as jops
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.dense_heads import iassd_head as jax_head
from spsnet_tpu.models.dense_heads import target_assign as jax_assign
from spsnet_tpu.ops import grouping as jax_grouping
from spsnet_tpu.runtime import optimization as jax_optim
from spsnet_tpu.runtime.trainer import TrainState
from spsnet_tpu.runtime.trainer import make_train_step as jax_make_train_step
from spsnet_tpu.utils import box_coder as jax_box_coder
from spsnet_tpu.utils import box_utils as jax_box_utils
from spsnet_tpu.utils import loss_utils as jax_loss_utils
from spsnet_tpu.utils.synthetic import synthetic_scene_batch as jax_scenes
from spsnet_tpu.zoo import tiny_iassd_cfg as jax_tiny_iassd_cfg
from spsnet_torch import ops
from spsnet_torch.config import EDict
from spsnet_torch.models import build_detector
from spsnet_torch.models.blocks import BatchNormLast
from spsnet_torch.models.dense_heads import iassd_head, target_assign
from spsnet_torch.ops.grouping import masked_pool
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.checkpoint import CheckpointManager
from spsnet_torch.runtime.trainer import Trainer, make_train_step
from spsnet_torch.utils import box_coder, box_utils, loss_utils
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from spsnet_torch.zoo import tiny_iassd_cfg

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

SEED, B, N = 0, 2, 512
ITERS, EPOCHS = 10, 2
OPTIM = {'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': EPOCHS,
         'OPTIMIZER': 'adam_onecycle', 'LR': 0.002, 'WEIGHT_DECAY': 0.01,
         'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
         'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [1, 2], 'LR_DECAY': 0.1,
         'LR_CLIP': 0.0000001, 'GRAD_NORM_CLIP': 10}
# loss terms: fp32 sums over ~20 layers in another order, ~1e-5 relative
# measured on the largest term (corner loss)
LOSS_RTOL = 5e-5
# gradients, per tensor against its largest entry: BatchNorm's 1/std
# carries the forward's ~1e-6 relative differences back through every layer
# (2.6e-4 measured on the first layer's weights)
GRAD_RTOL = 1e-3
# parameters and BN running stats after one step: Adam's first update is
# lr * sign(g) wherever |g| >> eps, so gradient differences barely reach it
# (1.3e-6 measured, lr 2e-4)
STEP_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree_to_torch(params, batch_stats=None):
    tree = {'params': _np_tree(params)}
    if batch_stats is not None:
        tree['batch_stats'] = _np_tree(batch_stats)
    return flax_to_torch(tree)


def test_synthetic_scenes_match_the_jax_package():
    pts, gt = synthetic_scene_batch(4, 2, 1000, n_clusters=5)
    jpts, jgt = jax_scenes(4, 2, 1000, n_clusters=5)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(gt, jgt)
    assert gt.shape == (2, 5, 8) and gt.dtype == np.float32


def _boxes(rng, b, t, pad):
    """(b, t, 8) boxes with headings and classes 1..3, the last ``pad`` rows
    of each frame zero padding."""
    boxes = np.zeros((b, t, 8), np.float32)
    n = t - pad
    boxes[:, :n, 0:2] = rng.uniform(-10, 10, (b, n, 2))
    boxes[:, :n, 2] = rng.uniform(-2, 0, (b, n))
    boxes[:, :n, 3:6] = rng.uniform(0.5, 5, (b, n, 3))
    boxes[:, :n, 6] = rng.uniform(-4, 4, (b, n))
    boxes[:, :n, 7] = rng.integers(1, 4, (b, n))
    return boxes


def _points_near(rng, boxes, m):
    """(b, m, 3) points, most of them inside or just outside some box, and
    the first one at the origin (which a padding row must not contain)."""
    b, t, _ = boxes.shape
    pick = rng.integers(0, max(t - 2, 1), (b, m))
    box = np.take_along_axis(boxes, pick[..., None], 1)
    local = rng.uniform(-0.7, 0.7, (b, m, 3)) * box[..., 3:6]
    c, s = np.cos(box[..., 6]), np.sin(box[..., 6])
    pts = np.stack([local[..., 0] * c - local[..., 1] * s + box[..., 0],
                    local[..., 0] * s + local[..., 1] * c + box[..., 1],
                    local[..., 2] + box[..., 2]], -1).astype(np.float32)
    pts[:, 0] = 0.0
    return pts


def test_points_in_boxes_matches_jax():
    """First containing box, xy margin 1e-5, padding rows never: index for
    index, overlapping boxes included."""
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 2, 12, pad=3)
    boxes[:, 1] = boxes[:, 0]          # inside box 0: box 0 must win
    boxes[:, 1, 3:6] *= 0.5
    pts = _points_near(rng, boxes, 400)
    got = ops.points_in_boxes(_t(pts), _t(boxes[..., :7])).numpy()
    want = np.asarray(jops.points_in_boxes(jnp.asarray(pts),
                                           jnp.asarray(boxes[..., :7])))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).mean() > 0.3 and (got == 1).sum() == 0
    assert (got[:, 0] == -1).all()


def _coder(mod):
    return mod.build_box_coder(
        'PointResidual_BinOri_Coder', angle_bin_num=12, use_mean_size=True,
        mean_size=[[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]])


def test_box_coder_encode_matches_jax():
    """The angle bin id exactly (an integer from fp32 arithmetic, headings
    on the bin edges included); the residuals within 1e-6 (the same fp32
    operations, libm's log against XLA's)."""
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 3, 40, pad=0)
    bin_inter = 2 * np.pi / 12
    boxes[0, :13, 6] = (np.arange(13) * bin_inter - np.pi).astype(np.float32)
    pts = _points_near(rng, boxes, 40)
    cls = boxes[..., 7].astype(np.int64)
    got = _coder(box_coder).encode(_t(boxes[..., :7]), _t(pts),
                                   _t(cls)).numpy()
    want = np.asarray(_coder(jax_box_coder).encode(
        jnp.asarray(boxes[..., :7]), jnp.asarray(pts),
        jnp.asarray(cls, jnp.int32)))
    np.testing.assert_array_equal(got[..., 6], want[..., 6])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_box_utils_match_jax():
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, 2, 6, pad=2)
    jb = jnp.asarray(boxes)
    np.testing.assert_allclose(
        box_utils.boxes_to_corners_3d(_t(boxes[0, :, :7])).numpy(),
        np.asarray(jax_box_utils.boxes_to_corners_3d(jb[0, :, :7])),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        box_utils.enlarge_box3d(_t(boxes), [0.2, 0.3, 0.4]).numpy(),
        np.asarray(jax_box_utils.enlarge_box3d(jb, [0.2, 0.3, 0.4])))
    for extra in ([0.5, 0.5, 0.5], [[0.1, 0.2, 0.3], [0.4, 0.5, 0.6],
                                    [0.7, 0.8, 0.9]]):
        np.testing.assert_array_equal(
            box_utils.enlarge_box3d_for_class(_t(boxes), extra).numpy(),
            np.asarray(jax_box_utils.enlarge_box3d_for_class(jb, extra)))


ASSIGN_VARIANTS = {
    'ignore_flag': dict(set_ignore_flag=True),
    'ex_gt': dict(set_ignore_flag=True, use_ex_gt_assign=True),
    'ex_gt_fg_pc_ignore': dict(set_ignore_flag=True, use_ex_gt_assign=True,
                               fg_pc_ignore=True),
    'plain': dict(set_ignore_flag=False),
}


@pytest.mark.parametrize('variant', sorted(ASSIGN_VARIANTS))
def test_assign_targets_and_centerness_match_jax(variant):
    """Labels, box indices, fg masks and the gathered boxes exactly; the
    encoded box labels within the coder's tolerance; the centerness within
    1e-5 (a cube root of products of ratios)."""
    rng = np.random.default_rng(4)
    gt = _boxes(rng, 2, 10, pad=3)
    pts = _points_near(rng, gt, 300)
    kw = dict(ASSIGN_VARIANTS[variant], ret_box_labels=True, num_class=3)
    got = target_assign.assign_targets_iassd(
        _t(pts), _t(gt), box_utils.enlarge_box3d(_t(gt), [1.0, 1.0, 1.0]),
        box_coder=_coder(box_coder), **kw)
    want = jax_assign.assign_targets_iassd(
        jnp.asarray(pts), jnp.asarray(gt),
        jax_box_utils.enlarge_box3d(jnp.asarray(gt), [1.0, 1.0, 1.0]),
        box_coder=_coder(jax_box_coder), **kw)
    for field in ('cls_labels', 'box_idxs', 'fg_mask', 'gt_box_of_points'):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.fg_mask.any() and (got.cls_labels == 0).any()
    np.testing.assert_allclose(got.box_labels.numpy(),
                               np.asarray(want.box_labels), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        target_assign.centerness_mask(_t(pts), got.cls_labels,
                                      got.gt_box_of_points,
                                      got.fg_mask).numpy(),
        np.asarray(jax_assign.centerness_mask(
            jnp.asarray(pts), want.cls_labels, want.gt_box_of_points,
            want.fg_mask)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('name', ['sigmoid_focal_loss', 'weighted_sigmoid_ce',
                                  'weighted_binary_ce', 'weighted_smooth_l1',
                                  'smooth_l1', 'get_corner_loss_lidar'])
def test_loss_functions_match_jax(name):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (4, 50, 3)).astype(np.float32)
    targets = (rng.uniform(size=(4, 50, 3)) > 0.6).astype(np.float32)
    weights = rng.uniform(size=(4, 50)).astype(np.float32)
    if name == 'weighted_smooth_l1':
        targets = rng.normal(size=(4, 50, 3)).astype(np.float32)
        targets[0, :5] = np.nan   # ignored
        args = (logits, targets, weights)
        kw = {'code_weights': [1.0, 2.0, 0.5]}
    elif name == 'smooth_l1':
        args, kw = (logits,), {'beta': 1.0}
    elif name == 'get_corner_loss_lidar':
        boxes = _boxes(rng, 2, 30, pad=0)[..., :7]
        args, kw = (boxes[0], boxes[1]), {}
    else:
        args, kw = (logits, targets, weights), {}
    got = getattr(loss_utils, name)(*map(_t, args), **kw).numpy()
    want = np.asarray(getattr(jax_loss_utils, name)(
        *map(jnp.asarray, args), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _head_inputs(seed, vote_type):
    """A forward's ``head_ret`` made from numpy: predictions and centers
    near the gt boxes, with targets assigned by each package."""
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, 2, 8, pad=2)
    gt[..., 7] = np.where(gt[..., 3] > 0, rng.integers(1, 4, gt.shape[:2]), 0)
    arrays = {
        'centers': _points_near(rng, gt, 64),
        'centers_origin': _points_near(rng, gt, 64),
        'ctr_offsets': rng.normal(0, 0.3, (2, 64, 3)).astype(np.float32),
        'center_cls_preds': rng.normal(size=(2, 64, 3)).astype(np.float32),
        'center_box_preds': rng.normal(0, 0.5, (2, 64, 30)).astype(np.float32),
        'xyz1': _points_near(rng, gt, 128), 'xyz2': _points_near(rng, gt, 96),
        'ins1': rng.normal(size=(2, 128, 3)).astype(np.float32),
        'ins2': rng.normal(size=(2, 96, 3)).astype(np.float32),
    }
    cfg = tiny_iassd_cfg().POINT_HEAD
    cfg.LOSS_CONFIG.LOSS_VOTE_TYPE = vote_type
    return gt, arrays, cfg


def _head_ret(gt, a, T, assign_mod, utils_mod, coder):
    """The head's ret dict in one package's tensors."""
    kw = dict(box_coder=coder, num_class=3)
    ext = utils_mod.enlarge_box3d(T(gt), [0.2, 0.2, 0.2])
    ret = {k: T(a[k]) for k in ('centers', 'centers_origin', 'ctr_offsets',
                                'center_cls_preds', 'center_box_preds')}
    ret['center_targets'] = assign_mod.assign_targets_iassd(
        ret['centers'], T(gt), ext, set_ignore_flag=True,
        ret_box_labels=True, **kw)
    ret['center_origin_targets'] = assign_mod.assign_targets_iassd(
        ret['centers_origin'], T(gt),
        utils_mod.enlarge_box3d(T(gt), [1.0, 1.0, 1.0]), set_ignore_flag=True,
        use_ex_gt_assign=True, ret_box_labels=True, **kw)
    half = utils_mod.enlarge_box3d(T(gt), [0.5, 0.5, 0.5])
    ret['encoder_xyz'] = [None, None, T(a['xyz1']), T(a['xyz2'])]
    ret['sa_ins_preds'] = [None, T(a['ins1']), T(a['ins2'])]
    ret['sa_targets'] = [None] + [
        assign_mod.assign_targets_iassd(
            T(a[f'xyz{i}']), T(gt), half, set_ignore_flag=(i == 0),
            use_ex_gt_assign=(i != 0), **kw) for i in (1, 2)]
    preds = ret['center_box_preds']
    cls = ret['center_cls_preds'].argmax(-1) + 1
    ret['point_box_preds'] = coder.decode(preds, ret['centers'],
                                          pred_classes=cls)
    return ret


@pytest.mark.parametrize('vote_type', ['none', 'ver1', 'ver2'])
def test_head_loss_matches_jax(vote_type):
    """``iassd_head_loss`` on the same predictions and targets, with each
    contextual vote loss: every term within 1e-5 relative."""
    gt, a, cfg = _head_inputs(6, vote_type)
    sml = cfg.LOSS_CONFIG.SAMPLE_METHOD_LIST
    coder, jcoder = _coder(box_coder), _coder(jax_box_coder)
    ret = _head_ret(gt, a, _t, target_assign, box_utils, coder)
    jret = _head_ret(gt, a, jnp.asarray, jax_assign, jax_box_utils, jcoder)
    loss, tb = iassd_head.iassd_head_loss(ret, cfg.LOSS_CONFIG, 3, coder,
                                          sample_method_list=sml)
    jloss, jtb = jax.jit(lambda r: jax_head.iassd_head_loss(
        r, cfg.LOSS_CONFIG, 3, jcoder, sample_method_list=sml))(jret)
    assert set(tb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(tb['center_origin_loss_reg']) > 0


def test_masked_pool_gradient_splits_ties_as_jax():
    """A ball query pads a group with its first hit, so pooled maxima tie:
    the gradient is shared equally among the tied entries in both."""
    rng = np.random.default_rng(7)
    h = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    h[:, :, 3:] = h[:, :, :1]           # padding slots repeat the first
    valid = rng.uniform(size=(2, 5, 6)) > 0.2
    w = rng.normal(size=(2, 5, 4)).astype(np.float32)
    for v in (None, valid):
        x = _t(h).requires_grad_(True)
        (masked_pool(x, None if v is None else _t(v)) * _t(w)).sum().backward()
        want = jax.grad(lambda y: (jax_grouping.masked_pool(
            y, None if v is None else jnp.asarray(v)) * w).sum())(
                jnp.asarray(h))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_batchnorm_running_stats_follow_flax():
    """In training the running variance moves toward the biased batch
    variance, as flax's does (torch's own update takes the unbiased one)."""
    rng = np.random.default_rng(8)
    x = rng.normal(2.0, 3.0, (4, 7, 5)).astype(np.float32)
    bn = BatchNormLast(5).train()
    y = bn(_t(x))
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jy, mut = flax_bn.apply(variables, jnp.asarray(x), mutable=['batch_stats'])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    stats = mut['batch_stats']
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats['mean']), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats['var']), rtol=1e-6)


@pytest.fixture(scope='module')
def one_step():
    """One train step of each package from the same variables and scenes.

    The JAX optimizer is chained behind a transform that keeps the raw
    gradients as its state, so one jitted ``make_train_step`` gives the
    loss terms, the gradients and the updated state. The port's gradients
    come from a forward and backward of its own (its ``step`` clips them in
    place), its update from ``make_train_step`` on a second copy."""
    pts, gt = synthetic_scene_batch(SEED, B, N)
    jax_model = jax_build_detector(jax_tiny_iassd_cfg(), num_class=3)
    variables = _np_tree(dict(jax.jit(lambda key, p: jax_model.init(
        key, {'points': p}, train=False))(jax.random.PRNGKey(SEED), pts)))
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(keep, jax_optim.build_optimizer(EDict(OPTIM), ITERS,
                                                     EPOCHS))
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    new_state, metrics = jax_make_train_step(jax_model, tx)(
        state, {'points': jnp.asarray(pts), 'gt_boxes': jnp.asarray(gt)})

    batch = {'points': _t(pts), 'gt_boxes': _t(gt)}
    model = load_flax(build_detector(tiny_iassd_cfg(), 3, device='cpu'),
                      variables).train()
    out = model(batch)
    loss, tb = model.loss(out)
    loss.backward()
    model2 = load_flax(build_detector(tiny_iassd_cfg(), 3, device='cpu'),
                       variables)
    opt = optimization.build_optimizer(EDict(OPTIM), model2.parameters(),
                                       ITERS, EPOCHS)
    loss2, tb2 = make_train_step(model2, opt)(batch)
    return {
        'jax_metrics': {k: float(v) for k, v in metrics.items()},
        'jax_grads': _tree_to_torch(new_state.opt_state[0]),
        'jax_state': _tree_to_torch(new_state.params, new_state.batch_stats),
        'init': flax_to_torch(variables),
        'tb': {k: float(torch.as_tensor(v).detach()) for k, v in tb.items()},
        'loss': float(loss.detach()),
        'step_tb': {k: float(v) for k, v in tb2.items()}, 'step_loss':
            float(loss2),
        'grads': {n: p.grad for n, p in model.named_parameters()},
        'state': model2.state_dict(), 'opt': opt,
    }


def test_train_step_loss_terms_match_jax(one_step):
    jm = one_step['jax_metrics']
    for tb, loss in ((one_step['tb'], one_step['loss']),
                     (one_step['step_tb'], one_step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert jm['center_pos_num'] > 0 and all(np.isfinite(list(jm.values())))


def test_train_step_gradients_match_jax(one_step):
    want = {k: v for k, v in one_step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(one_step['grads']) == set(want)
    for name, g in one_step['grads'].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_adam_onecycle_step_updates_params_and_bn_stats_as_jax(one_step):
    """Parameters, BN running means and variances after the step; the
    global norm is above the clip (10), so the clipped branch ran."""
    gnorm = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in one_step['jax_grads'].values()))
    assert gnorm > OPTIM['GRAD_NORM_CLIP']
    state, want, init = one_step['state'], one_step['jax_state'], \
        one_step['init']
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(state[name].numpy(), w.numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
        assert not torch.equal(state[name], init[name]), f'{name} unchanged'
    assert one_step['opt'].count == 1


def test_onecycle_and_step_decay_schedules_match_optax():
    """LR and beta1 at 20 steps across the cycle, and the step-decay LR of
    adam/sgd, against the JAX package's schedules, which evaluate the
    cosine in fp32 (2.5e-5 relative measured)."""
    total = 200
    steps = np.linspace(0, total + 10, 20).astype(int)
    lr, mom = optimization.onecycle_schedules(total, 0.01, [0.95, 0.85], 10,
                                              0.4)
    jlr, jmom = jax_optim.onecycle_schedules(total, 0.01, [0.95, 0.85], 10,
                                             0.4)
    np.testing.assert_allclose([lr(s) for s in steps],
                               [float(jlr(s)) for s in steps], rtol=1e-4)
    np.testing.assert_allclose([mom(s) for s in steps],
                               [float(jmom(s)) for s in steps], rtol=1e-6)
    assert max(lr(s) for s in steps) == pytest.approx(0.01, rel=1e-2)
    decay = optimization.step_decay_schedule(EDict(OPTIM), 10)
    jdecay = jax_optim.step_decay_schedule(EDict(OPTIM), 10)
    np.testing.assert_allclose([decay(s) for s in steps],
                               [float(jdecay(s)) for s in steps], rtol=1e-6)


@pytest.mark.parametrize('name', ['adam_onecycle', 'adam', 'sgd'])
def test_optimizers_match_optax_over_three_steps(name):
    """Three clipped steps of each optimizer on fixed gradients (the
    second above the clip norm, the others below), against the JAX
    package's optax chain."""
    rng = np.random.default_rng(9)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(4,)).astype(np.float32)]
    grads = [[rng.normal(0, s, p.shape).astype(np.float32) for p in p0]
             for s in (0.5, 20.0, 1.0)]
    cfg = EDict(dict(OPTIM, OPTIMIZER=name))
    params = [torch.nn.Parameter(_t(p.copy())) for p in p0]
    opt = optimization.build_optimizer(cfg, params, 2, 2)
    tx = jax_optim.build_optimizer(cfg, 2, 2)
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = _t(gi.copy())
        opt.step()
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, w in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(10)
    for scale in (0.1, 10.0):
        g = [rng.normal(0, scale, (6, 7)).astype(np.float32),
             rng.normal(0, scale, (3,)).astype(np.float32)]
        got = [_t(x.copy()) for x in g]
        norm = optimization.clip_by_global_norm_(got, 5.0)
        want, _ = optax.clip_by_global_norm(5.0).update(
            [jnp.asarray(x) for x in g], None)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        assert (float(norm) >= 5.0) == (scale == 10.0)


def test_checkpoint_ring_buffer_keeps_the_newest(tmp_path):
    ckpt = CheckpointManager(tmp_path / 'ckpt', max_to_keep=2)
    assert ckpt.restore() == (None, None)
    for step in (1, 2, 3, 4):
        ckpt.save(step, {'x': torch.full((2,), float(step))})
    assert ckpt.all_steps() == [3, 4]
    state, step = ckpt.restore()
    assert step == 4 and torch.equal(state['x'], torch.full((2,), 4.0))
    assert ckpt.restore(3)[0]['x'][0] == 3.0
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path / 'other', max_to_keep=0)


class _Scenes:
    """Batches of synthetic scenes; sends ``signum`` to this process while
    handing out batch ``signal_at``."""

    def __init__(self, n, signal_at=None, signum=signal.SIGUSR1):
        self.n, self.signal_at, self.signum = n, signal_at, signum

    def __iter__(self):
        for i in range(self.n):
            pts, gt = synthetic_scene_batch(100 + i, 2, 256)
            if i == self.signal_at:
                # the trainer's handler, never the default that would end
                # the process
                assert signal.getsignal(self.signum) not in (
                    signal.SIG_DFL, signal.SIG_IGN, None)
                os.kill(os.getpid(), self.signum)
            yield {'points': pts, 'gt_boxes': gt, 'frame_id': ['a', 'b']}


def _trainer(tmp_path):
    cfg = EDict({'OPTIMIZATION': dict(OPTIM, NUM_EPOCHS=3,
                                      MAX_CKPT_SAVE_NUM=2)})
    model = build_detector(tiny_iassd_cfg(), 3, device='cpu',
                           generator=torch.Generator().manual_seed(1))
    return Trainer(cfg, model, tmp_path, total_iters_each_epoch=1)


def test_trainer_saves_each_epoch_and_resumes(tmp_path):
    """Three epochs of one step: checkpoints 2 and 3 are kept, and a new
    trainer resumes the model, the optimizer state and the step count."""
    trainer = _trainer(tmp_path)
    assert trainer.maybe_resume() == 0
    assert trainer.train(_Scenes(1)) == 3
    assert trainer.ckpt.all_steps() == [2, 3]
    again = _trainer(tmp_path)
    assert again.maybe_resume() == 3
    assert again.optimizer.count == trainer.optimizer.count == 3
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(a, b), name
    moments = [s['exp_avg'] for s in again.optimizer.inner.state.values()]
    assert moments and all(torch.isfinite(m).all() for m in moments)


@pytest.mark.parametrize('signum', [signal.SIGTERM, signal.SIGUSR1])
def test_trainer_stops_on_signal_without_a_checkpoint(tmp_path, signum):
    """A stop signal ends the loop at the next step boundary; the epoch is
    not saved, so a resume redoes it. The old handler comes back."""
    before = signal.getsignal(signum)
    trainer = _trainer(tmp_path)
    assert trainer.train(_Scenes(2, signal_at=1, signum=signum)) == 0
    assert trainer.ckpt.all_steps() == []
    assert trainer.optimizer.count == 2
    assert signal.getsignal(signum) == before
