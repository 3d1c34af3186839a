"""One ``adam_onecycle`` train step of the port's tiny multi-head
detectors against the JAX package's ``make_train_step`` on the CPU: the
tiny SECOND with the grouped RPN (``zoo.tiny_second_multihead_cfg``: a
shared conv, one 1 x 1 head a KITTI class, on ``tests/test_pvrcnn.py``'s
``make_pv_batch``) and the tiny PointPillars with the nuScenes topology
(``zoo.tiny_pointpillar_multihead_cfg``: SEPARATE_REG_CONFIG branches,
(sin, cos) headings, gt with velocities) from the same numpy-filled flax
variables: loss terms, every gradient, updated parameters and BatchNorm
statistics, each within the tolerance stated in
``tests/test_torch_pvrcnn_train.py``; and their eval forward with
multi-class NMS, indices, labels and counts identical.

The pillar model's JAX step runs in float64 (``_one_step(jax_float64=
True)``): on these scans JAX's fp32 gradient at the BEV canvas departs
from the float64 gradient by 5.9e-3 of its largest entry (0.44 of 89 at
the PFN's weights), where the port's fp32 gradient lies within 1.3e-6 of
it and both packages in float64 agree to 1e-8 (the BEV backbone's
backward; ROADMAP Queue 3).
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_pvrcnn import PCR as PV_PCR
from tests.test_pvrcnn import VS as PV_VS
from tests.test_pvrcnn import make_pv_batch
from tests.test_torch_multihead import _velocity_gt
from tests.test_torch_pointpillar import PCR, VS, _data_cfg
from tests.test_torch_pointrcnn_train import _first_step_slack
from tests.test_torch_pvrcnn_train import (GRAD_RTOL, LOSS_RTOL, RTOL,
                                           STEP_ATOL, _one_step, _t,
                                           _variables)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

WHICH = ['second', 'pillar']
# the head's box convolutions' kernels: sizes are exp of their output
BOX_LAYERS = ('_box', '_reg', '_height', '_size', '_angle', '_velo')


def _pv_gt(rng):
    """Each frame's gt on three of the 2 x 2 anchor sites of the tiny
    voxel map (x 0 or 12.8, y -6.4 or 6.4), one a KITTI class, at its
    anchor's size and a heading near 0 or pi / 2, jittered."""
    sizes = np.float32([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73],
                        [1.76, 0.6, 1.73]])
    sites = [(0.0, -6.4), (12.8, -6.4), (0.0, 6.4), (12.8, 6.4)]
    gt = np.zeros((2, 3, 8), np.float32)
    for b in range(2):
        for k, s in enumerate(rng.permutation(4)[:3]):
            gt[b, k, 0:2] = np.float32(sites[s]) + rng.normal(0, 0.2, 2)
            gt[b, k, 3:6] = sizes[k] * rng.uniform(0.95, 1.05, 3)
            gt[b, k, 2] = -1.6 + gt[b, k, 5] / 2
            gt[b, k, 6] = rng.choice([0.0, 1.57]) + rng.normal(0, 0.1)
            gt[b, k, 7] = k + 1
    return gt


def _batch(which, train=True):
    """The torch batch of ``which``: make_pv_batch's voxels (gt on the
    anchor sites), or the port's pillars of two clustered scans (gt of 10
    columns, 6 and 4 a frame)."""
    if which == 'second':
        batch, final_zyx = make_pv_batch(np.random.default_rng(1))
        batch = {k: np.array(v) for k, v in batch.items()}
        batch['gt_boxes'] = _pv_gt(np.random.default_rng(2))
        return batch, tuple(int(v) for v in final_zyx)
    pts, _ = synthetic_scene_batch(50, 2, 1800, pc_range=PCR, n_clusters=6)
    rng = np.random.default_rng(51)
    gt = [_velocity_gt(rng, 6), _velocity_gt(rng, 4)]
    return voxel_batch(pts, _data_cfg(), mode='train' if train else 'test',
                       gt_boxes=gt if train else None), None


def _models(which, batch, final_zyx):
    """Both packages' tiny model with the same numpy-filled variables (the
    head's box convolutions at 0.05), and the variables."""
    if which == 'second':
        cfg = zoo.tiny_second_multihead_cfg(final_zyx)
        geometry = {'voxel_size': PV_VS, 'point_cloud_range': PV_PCR,
                    'final_grid_zyx': final_zyx}
    else:
        cfg = zoo.tiny_pointpillar_multihead_cfg()
        geometry = {'voxel_size': VS, 'point_cloud_range': PCR}
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=3,
                            **geometry)
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    for name, layer in variables['params']['dense_head'].items():
        if name.endswith(BOX_LAYERS):
            layer['kernel'] = layer['kernel'] * np.float32(0.05)
    model = build_detector(cfg, 3, device='cpu', **geometry)
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    return cfg, jm, variables, load_flax(model, variables)


@pytest.fixture(scope='module', params=WHICH)
def multi_step(request):
    batch, final_zyx = _batch(request.param)
    cfg, jm, variables, model = _models(request.param, batch, final_zyx)
    step = _one_step(jm, variables, model,
                     {k: _t(v) for k, v in batch.items()},
                     jax_float64=request.param == 'pillar')
    step['which'] = request.param
    return step


def hold_train_step(step, keys):
    """``_one_step``'s record held to JAX's: the tb keys ``keys``, each
    loss term within LOSS_RTOL and non-zero; every parameter's gradient
    within GRAD_RTOL of its largest entry, none zero; parameters within
    STEP_ATOL plus each entry's first-step slack and BN statistics within
    STEP_ATOL + RTOL after the step, every one moved."""
    jmet = step['jax_metrics']
    assert set(jmet) == keys
    for tb, loss in ((step['tb'], step['loss']),
                     (step['step_tb'], step['step_loss'])):
        assert set(tb) | {'loss'} == keys
        np.testing.assert_allclose(loss, jmet['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jmet[k], rtol=LOSS_RTOL, err_msg=k)
    assert all(v > 0 for v in jmet.values())
    want = {k: v for k, v in step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(step['grads']) == set(want)
    for name, g in step['grads'].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
    state, jstate, init, opt = step['state'], step['jax_state'], \
        step['init'], step['opt']
    slack = _first_step_slack(step['grads'], step['jax_grads'],
                              opt.lr_fn(0), opt.max_norm)
    n_stats = 0
    for name, w in jstate.items():
        if name.endswith('num_batches_tracked'):
            continue
        diff = (state[name] - w).abs()
        bound = STEP_ATOL + slack.get(name, torch.zeros(()))
        if name.endswith(('running_mean', 'running_var')):
            bound = bound + RTOL * w.abs()
            n_stats += 1
        assert (diff <= bound).all(), (
            f'{name}: {int((diff > bound).sum())} entries beyond the bound, '
            f'largest difference {float(diff.max()):.3e}')
        assert not torch.equal(state[name], init[name]), f'{name} unchanged'
    assert n_stats > 0 and opt.count == 1


RPN_KEYS = {'loss', 'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
            'rpn_loss'}


def test_multihead_train_step_matches_jax(multi_step):
    """The step of the tiny multi-head detector (the shared conv's and
    every group's layers, the middle convs' BN statistics of the
    nuScenes topology) held by ``hold_train_step``."""
    hold_train_step(multi_step, RPN_KEYS)
    names = set(multi_step['grads'])
    assert 'dense_head.shared_conv.0.weight' in names
    if multi_step['which'] == 'pillar':
        assert 'dense_head.rpn_heads.1.conv_box.conv_velo.3.weight' in names
        assert 'dense_head.rpn_heads.0.conv_cls.1.running_var' in \
            multi_step['state']


@pytest.mark.parametrize('which', WHICH)
def test_multihead_model_serves_as_jax(which):
    """The tiny multi-head detector's eval forward (head outputs within
    RTOL plus ATOL of the largest entry) and ``post_processing``'s
    multi-class NMS: indices, labels and counts identical, boxes within
    tolerance, detections in every frame; nuScenes' boxes keep their
    velocity columns."""
    batch, final_zyx = _batch(which, train=False)
    batch = {k: v for k, v in batch.items() if k != 'gt_boxes'}
    cfg, jm, variables, model = _models(which, batch, final_zyx)
    post = cfg.POST_PROCESSING
    jout, jd = jax.jit(lambda v, b: (lambda o: (o, jax_post_processing(
        o, StaticConfig(JaxEDict(copy.deepcopy(post))))))(
            jm.apply(v, b, train=False)))(variables, batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    for key in ('batch_box_preds', 'batch_cls_preds'):
        want = np.asarray(jout[key])
        np.testing.assert_allclose(out[key].numpy(), want, rtol=RTOL,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)
    dets = post_processing(out, post)
    for key in ('labels', 'count'):
        np.testing.assert_array_equal(dets[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    want = np.asarray(jd['boxes'])
    np.testing.assert_allclose(dets['boxes'].numpy(), want, rtol=RTOL,
                               atol=1e-4 * np.abs(want).max())
    assert int(dets['count'].min()) > 0
    assert dets['boxes'].shape[-1] == (9 if which == 'pillar' else 7)
