"""One ``adam_onecycle`` train step of the port's tiny voxel CenterPoint
(``zoo.tiny_centerpoint_voxel_cfg``: two head groups, 10-wide gt with
velocities, the IoU branch) against the JAX package's ``make_train_step``
on the CPU, from the same numpy-filled flax variables on the port's host
voxels and plan (``tests/test_torch_centerpoint.py`` builds the models
and frames, and holds the serving path): the train forward's heatmap and
centre targets, the loss terms, every gradient, the updated parameters
and BatchNorm statistics, within the tolerances stated there.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from tests.test_torch_centerpoint import (FINAL, GRAD_RTOL, HM_JIT_RTOL,
                                          RTOL, STEP_ATOL, TARGET_ATOL,
                                          _data_cfg, _models, _scenes, _t)
from tests.test_torch_centerpoint import \
    jax_centerpoint_builds  # noqa: F401  (the module's autouse fixture)
from tests.test_torch_pvrcnn_train import _one_step

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def cp_step():
    """One ``adam_onecycle`` step of each package of the tiny CenterPoint
    from the same numpy-filled variables on two frames with 10-wide gt
    boxes (velocities), the IoU branch included."""
    pts, gt = _scenes(41, width=10)
    batch = voxel_batch(pts, _data_cfg(), mode='train', gt_boxes=gt)
    jm, variables, model = _models(zoo.tiny_centerpoint_voxel_cfg(FINAL),
                                   batch)
    step = _one_step(jm, variables, model, {k: _t(v)
                                            for k, v in batch.items()})
    model = copy.deepcopy(model).train()
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    jout, _ = jax.jit(lambda v, b: jm.apply(
        v, b, train=True, mutable=['batch_stats']))(variables, batch)
    step['targets'] = (out['center_head_iou_ret']['target_dicts'],
                       jout['center_head_iou_ret']['target_dicts'])
    return step


CP_KEYS = {'loss', 'rpn_loss', 'hm_loss_head_0', 'loc_loss_head_0',
           'iou_loss_0', 'hm_loss_head_1', 'loc_loss_head_1', 'iou_loss_1'}


def test_train_forward_targets_match_jax(cp_step):
    """Each group's targets in the train forward against JAX's jitted
    one: its classes relabelled 1..G, the heatmap within HM_JIT_RTOL,
    peaks, pixels, masks and raw gt identical, the 10-wide regression
    targets within TARGET_ATOL."""
    for got, want in zip(*cp_step['targets']):
        np.testing.assert_allclose(got['heatmap'].numpy(), want['heatmap'],
                                   rtol=HM_JIT_RTOL, atol=0)
        np.testing.assert_array_equal(got['heatmap'].numpy() == 1.0,
                                      np.asarray(want['heatmap']) == 1.0)
        for k in ('inds', 'mask', 'gt7'):
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)
        np.testing.assert_allclose(got['boxes'].numpy(), want['boxes'],
                                   rtol=0, atol=TARGET_ATOL)
        assert got['boxes'].shape[-1] == 10 and got['mask'].any()
    assert cp_step['targets'][0][1]['heatmap'].shape[1] == 2


def test_train_step_loss_terms_match_jax(cp_step):
    """JAX's tb keys (a heatmap, a regression and an IoU term a group);
    every term within 1e-4 relative and non-zero."""
    jm = cp_step['jax_metrics']
    assert set(jm) == CP_KEYS
    for tb, loss in ((cp_step['tb'], cp_step['loss']),
                     (cp_step['step_tb'], cp_step['step_loss'])):
        assert set(tb) | {'loss'} == CP_KEYS
        np.testing.assert_allclose(loss, jm['loss'], rtol=1e-4)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=1e-4, err_msg=k)
    assert all(v > 0 for v in jm.values())


def test_train_step_gradients_match_jax(cp_step):
    """Every parameter's gradient within GRAD_RTOL of the largest entry of
    its layer's gradients (weight and bias): the bias of a conv before a
    train-mode BatchNorm (USE_BIAS_BEFORE_NORM) has no gradient but
    rounding, 1e-10-1e-6 in both packages, as the BatchNorm takes out
    any shift; every layer's gradient non-zero."""
    want = {k: v.numpy() for k, v in cp_step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(cp_step['grads']) == set(want)
    layer_scale = {}
    for name, w in want.items():
        layer = name.rsplit('.', 1)[0]
        layer_scale[layer] = max(layer_scale.get(layer, 0.0),
                                 float(np.abs(w).max()))
    for name, g in cp_step['grads'].items():
        scale = layer_scale[name.rsplit('.', 1)[0]]
        assert scale > 1e-4, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_train_step_updates_params_and_bn_stats_as_jax(cp_step):
    """Parameters within STEP_ATOL plus each entry's first-step slack,
    every BN running statistic (the residual backbone's over its padded
    rows, the BEV backbone's and the heads' with flax's rule) within
    STEP_ATOL + RTOL, every one moved."""
    from tests.test_torch_pvrcnn_train import _first_step_slack
    state, want, init = cp_step['state'], cp_step['jax_state'], \
        cp_step['init']
    opt = cp_step['opt']
    slack = _first_step_slack(cp_step['grads'], cp_step['jax_grads'],
                              opt.lr_fn(0), opt.max_norm)
    n_stats = 0
    for name, w in want.items():
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
