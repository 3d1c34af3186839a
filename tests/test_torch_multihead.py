"""The port's grouped multi-head RPN (``AnchorHeadMulti``), its anchor
targets with velocity gt and ``multi_classes_nms_batch`` against the JAX
package on the CPU.

Two head configurations on a seeded 16 x 16 BEV map: KITTI's
``second_multihead.yaml`` topology (a shared conv, one 1 x 1 head a class)
and nuScenes' ``cbgs_pp_multihead.yaml`` topology (SEPARATE_REG_CONFIG
branches with a middle conv, a head of two classes, the code of size 9
with (sin, cos) headings and velocities), their flax variables filled
from numpy and copied through the weight bridge. The JAX module runs op by
op (not jitted): under jit XLA:CPU contracts the nearest-BEV IoU's union
into an FMA, which moves IoU ties otherwise than the port. Index outputs
(anchor labels, matched gt, NMS keeps, labels, counts) must be identical;
floats within the tolerances stated below.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models.dense_heads import anchor_head as jax_anchor_head
from spsnet_tpu.models.detectors.detector3d import \
    multi_classes_nms_batch as jax_multi_nms
from spsnet_tpu.utils import box_coder as jax_box_coder
from spsnet_torch import ops, zoo
from spsnet_torch.models.dense_heads import anchor_head
from spsnet_torch.models.detectors import detector3d
from spsnet_torch.utils import box_coder
from spsnet_torch.utils.weights import flax_to_torch
from tests.test_torch_pointpillar import _fill, _gt
from tests.test_torch_pvrcnn import _Holder
from tests.test_torch_pvrcnn_train import REG_ATOL, _assign_case

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, C_IN, HW = 2, 16, 16
PCR = (0, -12.8, -3, 25.6, 12.8, 1)
GRID = (64, 64, 1)
# head outputs, decoded boxes: the same convolutions summed in another
# order (XLA:CPU against oneDNN), relative plus a share of each tensor's
# largest entry; BatchNorm's 1/std in training
RTOL, ATOL = 1e-4, 1e-4
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3
WHICH = ['kitti', 'nuscenes']


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _head_cfg(which):
    """The DENSE_HEAD of the tiny multi-head config ``which`` with its
    anchors at stride 4 (a 16 x 16 map on GRID)."""
    cfg = copy.deepcopy(
        zoo.tiny_second_multihead_cfg((2, 2, 2)).DENSE_HEAD
        if which == 'kitti' else
        zoo.tiny_pointpillar_multihead_cfg().DENSE_HEAD)
    for a in cfg.ANCHOR_GENERATOR_CONFIG:
        a['feature_map_stride'] = 4
    return cfg


def _velocity_gt(rng, n):
    """``_gt`` boxes of the KITTI classes with a velocity (vx, vy) before
    the class: (n, 10)."""
    g = _gt(rng, n)
    vel = rng.normal(0, 2, (n, 2)).astype(np.float32)
    return np.concatenate([g[:, :7], vel, g[:, 7:]], axis=1)


def _heads(which, seed=0):
    """The JAX and port heads of ``which`` with the same numpy-filled
    variables (the box convolutions' kernels at 0.1, sizes being exp of
    their output), and the variables."""
    cfg = _head_cfg(which)
    jm = jax_anchor_head.AnchorHeadMulti(
        model_cfg=StaticConfig(JaxEDict(copy.deepcopy(cfg))), num_class=3,
        grid_size=GRID, point_cloud_range=PCR)
    x = np.zeros((B, HW, HW, C_IN), np.float32)
    shapes = jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), {'spatial_features_2d': x})
    variables = _fill(shapes, seed)
    for name, layer in variables['params'].items():
        if name.endswith(('_box', '_reg', '_size', '_height', '_velo')):
            layer['kernel'] = layer['kernel'] * np.float32(0.1)
    head = anchor_head.AnchorHeadMulti(cfg, 3, C_IN, GRID, PCR)
    holder = _Holder(dense_head=head)
    sd = flax_to_torch({c: {'dense_head': t} for c, t in variables.items()})
    assert set(sd) == set(holder.state_dict())
    holder.load_state_dict(sd)
    return jm, variables, head


def _bev(seed):
    return np.random.default_rng(seed).normal(
        size=(B, HW, HW, C_IN)).astype(np.float32)


@pytest.mark.parametrize('coder', ['sincos9', 'plain7'])
def test_velocity_gt_targets_match_jax(coder):
    """The velocity repair: gt of shape (B, T, 10) (``_assign_case``'s two
    classes with a velocity before the class) against anchors of 7
    columns gives (B, N, 6 + angle + 2) targets equal to JAX's, whose
    anchors are zero-padded to the box width: the velocity channels are
    the gt's velocity on the foreground (the code of size 9 with sin / cos
    headings: (B, N, 10)); labels and matched gt identical."""
    anchors, cls, matched, unmatched, gt8 = _assign_case('two_classes')
    rng = np.random.default_rng(9)
    gt = np.concatenate([gt8[..., :7], rng.normal(0, 2, gt8.shape[:2] + (
        2,)).astype(np.float32), gt8[..., 7:]], axis=-1)
    gt[gt8[..., 3] == 0] = 0
    kw = {'code_size': 9, 'encode_angle_by_sincos': True} \
        if coder == 'sincos9' else {}
    port_coder = box_coder.build_box_coder('ResidualCoder', **kw)
    labels, reg, reg_w, gt_idx, _ = anchor_head.assign_anchor_targets(
        _t(anchors), _t(cls), _t(matched), _t(unmatched), _t(gt),
        port_coder)
    jl, jr, jw, ja = jax.vmap(
        lambda g: jax_anchor_head.assign_anchor_targets(
            jnp.asarray(anchors), cls, matched, unmatched, g,
            jax_box_coder.build_box_coder('ResidualCoder', **kw), 2))(gt)
    width = 10 if coder == 'sincos9' else 9
    assert reg.shape == (B, anchors.shape[0], width) == np.shape(jr)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    fg = labels.numpy() > 0
    assert fg.any()
    np.testing.assert_array_equal(gt_idx.numpy()[fg], np.asarray(ja)[fg])
    np.testing.assert_array_equal(reg_w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(reg.numpy(), np.asarray(jr), rtol=0,
                               atol=REG_ATOL)
    vel = np.take_along_axis(gt[..., 7:9], gt_idx.numpy()[..., None], 1)
    np.testing.assert_array_equal(reg.numpy()[..., -2:][fg], vel[fg])


@pytest.mark.parametrize('which', WHICH)
def test_anchor_head_multi_forward_matches_jax(which):
    """The eval forward: the class logits (each group's classes at their
    columns, -1e9 elsewhere, exactly), the box and direction predictions
    in the anchor-major order of the groups, the anchors, their classes
    and thresholds (exact), and the decoded boxes with the direction
    correction within tolerance."""
    jm, variables, head = _heads(which)
    x = _bev(1)
    jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, {'spatial_features_2d': x})
    head.eval()
    with torch.no_grad():
        out = head({'spatial_features_2d': _t(x.transpose(0, 3, 1, 2))})
    ret, jret = out['anchor_head_ret'], jout['anchor_head_ret']
    np.testing.assert_array_equal(ret['anchors'].numpy(), jret['anchors'])
    for key in ('cls_preds', 'box_preds', 'dir_preds'):
        _close(ret[key], jret[key], key)
    _close(out['batch_box_preds'], jout['batch_box_preds'], 'decoded')
    code = 10 if which == 'nuscenes' else 7
    assert ret['box_preds'].shape[-1] == code
    assert out['batch_box_preds'].shape[-1] == code - (which == 'nuscenes')
    # the -1e9 columns: another group's class
    cls = out['batch_cls_preds']
    n = [h.A * HW * HW for h in head.rpn_heads]
    starts = np.cumsum([0] + n)
    for g in range(len(head.rpn_heads)):
        cols = getattr(head, f'columns{g}').tolist()
        rows = cls[:, starts[g]:starts[g + 1]]
        others = [k for k in range(3) if k not in cols]
        assert (rows[..., others] == -1e9).all()
        assert (rows[..., cols] > -1e3).all()
        assert (head.anchor_cls[starts[g]:starts[g + 1]] - 1).unique(
            ).tolist() == sorted(cols)
    jac = jnp.concatenate([jnp.repeat(m['gids'], HW * HW)
                           for m in jm.bind(variables).head_meta])
    np.testing.assert_array_equal(head.anchor_cls.numpy(), np.asarray(jac))


def _train_batch(which, seed):
    rng = np.random.default_rng(seed)
    gt = np.stack([(_velocity_gt if which == 'nuscenes' else _gt)(rng, 6)
                   for _ in range(B)])
    gt[1, 4:] = 0
    return {'spatial_features_2d': _bev(seed), 'gt_boxes': gt}


@pytest.mark.parametrize('which', WHICH)
def test_anchor_head_multi_targets_loss_and_gradients_match_jax(which):
    """The train forward with gt (10 columns for the nuScenes topology):
    labels identical (positives among them), regression targets within
    REG_ATOL; ``anchor_head_loss`` on the head's ret (the JAX
    ``SECONDNet.loss``) term by term within LOSS_RTOL, every term
    non-zero and finite at the -1e9 logits; the gradients of the loss at
    every parameter of the head and at the BEV map within GRAD_RTOL of
    each tensor's largest entry, zero at the -1e9 entries; the BN running
    statistics as flax moves them."""
    jm, variables, head = _heads(which, seed=2)
    batch = _train_batch(which, 3)
    cfg = _head_cfg(which)
    loss_cfg = cfg.LOSS_CONFIG
    dirs = (int(cfg.NUM_DIR_BINS), float(cfg.DIR_OFFSET))

    def jax_loss(params, x):
        out, mut = jm.apply({'params': params,
                             'batch_stats': variables['batch_stats']},
                            dict(batch, spatial_features_2d=x), train=True,
                            mutable=['batch_stats'])
        ret = out['anchor_head_ret']
        loss, tb = jax_anchor_head.anchor_head_loss(
            ret, StaticConfig(JaxEDict(copy.deepcopy(loss_cfg))), 3,
            jm.bind(variables).box_coder, *dirs)
        return loss, (tb, ret, mut)
    (jloss, (jtb, jret, jmut)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(
            variables['params'], batch['spatial_features_2d'])

    head.train()
    x = _t(batch['spatial_features_2d'].transpose(0, 3, 1, 2))
    x.requires_grad_()
    out = head({'spatial_features_2d': x, 'gt_boxes': _t(batch['gt_boxes'])})
    ret = out['anchor_head_ret']
    ret['cls_preds'].retain_grad()
    loss, tb = anchor_head.anchor_head_loss(ret, loss_cfg, 3, *dirs)
    loss.backward()

    labels = ret['box_cls_labels'].numpy()
    np.testing.assert_array_equal(labels, np.asarray(jret['box_cls_labels']))
    assert (labels > 0).sum() >= 4 and (labels == 0).any()
    assert ret['box_reg_targets'].shape[-1] == (10 if which == 'nuscenes'
                                                else 7)
    np.testing.assert_allclose(ret['box_reg_targets'].numpy(),
                               np.asarray(jret['box_reg_targets']), rtol=0,
                               atol=REG_ATOL)
    assert set(tb) == set(jtb)
    for k, v in jtb.items():
        assert np.isfinite(float(v)) and float(v) > 0, k
        np.testing.assert_allclose(float(tb[k].detach()), float(v),
                                   rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    masked = ret['cls_preds'] == -1e9
    assert masked.any()
    assert (ret['cls_preds'].grad[masked] == 0).all()
    want = flax_to_torch({'params': {'dense_head': jax.tree_util.tree_map(
        np.asarray, jgp)}})
    got = {f'dense_head.{n}': p.grad for n, p in head.named_parameters()}
    want = {n: g for n, g in want.items() if n in got}
    assert set(got) == set(want)
    want['x'] = _t(np.asarray(jgx).transpose(0, 3, 1, 2))
    got['x'] = x.grad
    for name, g in got.items():
        scale = float(want[name].abs().max())
        assert scale > 0 and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
    stats = flax_to_torch({'params': {'dense_head': variables['params']},
                           'batch_stats': {'dense_head': jax.tree_util.
                                           tree_map(np.asarray, jmut[
                                               'batch_stats'])}})
    sd = _Holder(dense_head=head).state_dict()
    n_stats = 0
    for name, w in stats.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(sd[name].numpy(), w.numpy(),
                                       rtol=RTOL, atol=1e-5, err_msg=name)
            n_stats += 1
    assert n_stats >= 2


@pytest.mark.parametrize('which', WHICH)
def test_flax_to_torch_maps_every_multihead_key(which):
    """Every leaf of the head's tree lands on a port key and back (the
    shared conv and BN, each group's cls / box / dir convs, the middle
    convs and BNs of each SEPARATE_REG_CONFIG branch and its output conv
    after them); a layer of no known kind raises."""
    _, variables, head = _heads(which)
    tree = {c: {'dense_head': t} for c, t in variables.items()}
    sd = flax_to_torch(tree)
    assert set(sd) == set(_Holder(dense_head=head).state_dict())
    params = variables['params']
    if which == 'nuscenes':
        np.testing.assert_array_equal(
            sd['dense_head.rpn_heads.1.conv_box.conv_velo.3.weight'].numpy(),
            params['head1_velo']['kernel'].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            sd['dense_head.rpn_heads.0.conv_cls.1.running_var'].numpy(),
            variables['batch_stats']['head0_cls_mid0_bn']['var'])
    else:
        np.testing.assert_array_equal(
            sd['dense_head.rpn_heads.2.conv_dir_cls.weight'].numpy(),
            params['head2_dir']['kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd['dense_head.shared_conv.0.weight'].numpy(),
        params['shared_conv']['kernel'].transpose(3, 2, 0, 1))
    params['head0_cls_mid0_proj'] = {
        'kernel': np.ones((1, 1, 3, 3), np.float32)}
    with pytest.raises(KeyError, match='unmapped'):
        flax_to_torch(tree)


# ------------------------------------------------------ multi-class NMS

def _per_class_loop(boxes, logits, thresh, nms_thresh, pre, post):
    """The reference's per-class loop in the port's own ops: ``nms_bev``
    over all M boxes of each class, the survivors merged by
    ``topk_desc``: (indices, scores, labels, count)."""
    scores = torch.sigmoid(logits)
    B_, M, C = scores.shape
    idx, sc, lab = [], [], []
    for c in range(C):
        s = scores[..., c]
        keep, _ = ops.nms_bev(boxes[..., :7], s, nms_thresh,
                              pre_maxsize=pre, post_maxsize=post,
                              valid=s > thresh)
        ok = keep >= 0
        idx.append(keep)
        sc.append(torch.where(ok, s.gather(1, keep.clamp(min=0)), -1.0))
        lab.append(torch.where(ok, c + 1, 0))
    idx, sc, lab = (torch.cat(t, 1) for t in (idx, sc, lab))
    top, order = ops.boxes.topk_desc(sc, post)
    kept = top > -1
    return (torch.where(kept, idx.gather(1, order), -1),
            torch.where(kept, top, 0.0),
            torch.where(kept, lab.gather(1, order), 0), kept.sum(1))


def _nms_case(seed, M=300, C=4):
    """(boxes (B, M, 9), logits (B, M, C)): boxes in a 40 m square with
    velocities, logits quantised to 1/8 so that equal scores are common
    within and across classes."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, M, 9), np.float32)
    boxes[..., 0:2] = rng.uniform(-20, 20, (B, M, 2))
    boxes[..., 2] = rng.uniform(-2, 0, (B, M))
    boxes[..., 3:6] = rng.uniform([0.6, 0.5, 1.4], [5.0, 2.2, 1.8],
                                  (B, M, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    boxes[..., 7:9] = rng.normal(0, 2, (B, M, 2))
    logits = np.round(rng.normal(-1.0, 1.5, (B, M, C)) * 8) / 8
    return boxes, logits.astype(np.float32)


def _near_thresh(boxes, nms_thresh):
    """The smallest distance of a pair's BEV IoU (the port's) from the
    NMS threshold."""
    b = _t(boxes[..., :7])
    iou = torch.stack([ops.boxes.boxes_iou_bev_fast(f, f) for f in b])
    return float((iou - nms_thresh).abs().min())


@pytest.mark.parametrize('seed,pre,post', [(20, 120, 30), (21, 300, 50),
                                           (22, 64, 16)])
def test_multi_classes_nms_matches_jax_and_the_per_class_loop(seed, pre,
                                                              post):
    """``multi_classes_nms_batch`` on boxes with velocities and scores
    with ties: its kept indices, scores, labels and counts equal to a
    per-class loop of the port's own ``nms_bev`` index for index, its
    boxes (all 9 columns), scores, labels and counts to JAX's (no pair's
    IoU within 1e-5 of the threshold, so the jitted JAX IoUs decide
    alike); one ``nms_bev`` call over B x C rows."""
    boxes, logits = _nms_case(seed)
    assert _near_thresh(boxes, 0.2) > 1e-5
    calls = []
    real = ops.nms_bev

    def counted(b, *args, **kwargs):
        calls.append(b.shape)
        return real(b, *args, **kwargs)
    ops.nms_bev = counted
    try:
        dets = detector3d.multi_classes_nms_batch(
            _t(boxes), _t(logits), 0.3, 0.2, pre, post)
    finally:
        ops.nms_bev = real
    assert calls == [(B * 4, pre, 7)]
    idx, sc, lab, count = _per_class_loop(_t(boxes), _t(logits), 0.3, 0.2,
                                          pre, post)
    np.testing.assert_array_equal(dets['indices'].numpy(), idx.numpy())
    np.testing.assert_array_equal(dets['scores'].numpy(), sc.numpy())
    np.testing.assert_array_equal(dets['labels'].numpy(), lab.numpy())
    np.testing.assert_array_equal(dets['count'].numpy(), count.numpy())
    jd = jax_multi_nms(boxes, logits, score_thresh=0.3, nms_thresh=0.2,
                       nms_pre=pre, nms_post=post)
    for key in ('labels', 'count'):
        np.testing.assert_array_equal(dets[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(dets['boxes'].numpy(),
                                  np.asarray(jd['boxes']))
    np.testing.assert_allclose(dets['scores'].numpy(), np.asarray(
        jd['scores']), rtol=1e-6, atol=0)
    kept = dets['indices'] >= 0
    np.testing.assert_array_equal(
        dets['boxes'].numpy(), np.where(kept.numpy()[..., None], np.take_along_axis(
            boxes, dets['indices'].clamp(min=0).numpy()[..., None], 1), 0))
    # equal scores among the kept, across classes too
    s = dets['scores'][kept]
    assert len(s) > len(s.unique()) and (count > 0).all()
    assert len(dets['labels'][kept].unique()) == 4


@pytest.mark.parametrize('case', ['two_classes_overlap', 'one_class'])
def test_multi_classes_nms_on_the_jax_fixtures(case):
    """``tests/test_multiclass_nms.py``'s boxes: two overlapping boxes of
    different classes both survive (4 kept, labels {1, 2}); as one class
    the overlap is suppressed (3 kept); as JAX keeps them."""
    boxes = np.zeros((1, 4, 7), dtype=np.float32)
    boxes[0, 0] = [0, 0, 0, 4, 2, 1.5, 0.0]
    boxes[0, 1] = [0.2, 0, 0, 4, 2, 1.5, 0.0]
    boxes[0, 2] = [20, 0, 0, 4, 2, 1.5, 0.0]
    boxes[0, 3] = [40, 0, 0, 4, 2, 1.5, 0.0]
    logits = np.full((1, 4, 2), -10.0, dtype=np.float32)
    if case == 'two_classes_overlap':
        logits[0, [0, 1, 2, 3], [0, 1, 0, 1]] = [5.0, 4.0, 3.0, 2.0]
    else:
        logits[0, :, 0] = [5.0, 4.0, 3.0, 2.0]
    dets = detector3d.multi_classes_nms_batch(_t(boxes), _t(logits), 0.1,
                                              0.1, 4, 4)
    jd = jax_multi_nms(boxes, logits, score_thresh=0.1, nms_thresh=0.1,
                       nms_pre=4, nms_post=4)
    for key in ('labels', 'count', 'boxes'):
        np.testing.assert_array_equal(dets[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    count = int(dets['count'][0])
    if case == 'two_classes_overlap':
        assert count == 4
        assert set(dets['labels'][0, :count].tolist()) == {1, 2}
    else:
        assert count == 3
        assert dets['indices'][0, :count].tolist() == [0, 2, 3]


def test_post_processing_routes_multi_classes_nms():
    """``post_processing`` under MULTI_CLASSES_NMS gives
    ``multi_classes_nms_batch``'s detections at the config's thresholds."""
    boxes, logits = _nms_case(23, M=100, C=3)
    post = zoo.tiny_second_multihead_cfg((2, 2, 2)).POST_PROCESSING
    out = {'batch_box_preds': _t(boxes), 'batch_cls_preds': _t(logits),
           'cls_preds_normalized': False}
    dets = detector3d.post_processing(out, post)
    want = detector3d.multi_classes_nms_batch(_t(boxes), _t(logits), 0.1,
                                              0.1, 64, 16)
    assert set(dets) == set(want)
    for key in want:
        assert torch.equal(dets[key], want[key]), key
    assert dets['boxes'].shape == (B, 16, 9)
