"""One ``adam_onecycle`` train step of the port's tiny pillar detectors
against the JAX package's ``make_train_step`` on the CPU: the tiny
PointPillar (anchor targets and ``anchor_head_loss``), the tiny pillar
CenterPoint with Waymo's two-layer PFN (the plain CenterHead's targets and
``center_head_loss``) and its DynamicPillarVFE twin, from the same
numpy-filled flax variables on two frames with gt boxes
(``tests/test_torch_pointpillar.py`` builds the models and batches): loss
terms, every gradient (the PFN's max ties at the padded slots and
duplicate points included), updated parameters and BatchNorm statistics,
each within the tolerance stated there.

The dynamic model's JAX step runs with ``jax_enable_x64`` on (its arrays
stay fp32): in the default mode the JAX program's gradients of the PFN and
the first BEV block depart from the same program's with x64 on by up to
12% (seed 44; 1-3% at this seed), where the forward agrees to 4e-6 and the
port's gradients agree with the x64 run and with the port's own float64
run to 1e-6 (ROADMAP Queue 3).
"""
import numpy as np
import jax
import pytest
import torch

from tests.test_torch_pointpillar import (GRAD_RTOL, RTOL, STEP_ATOL, WHICH,
                                          _batch, _models,
                                          _recip_departures, _t)
from tests.test_torch_pointrcnn_train import _first_step_slack
from tests.test_torch_pvrcnn_train import _one_step

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)


@pytest.fixture(scope='module', params=WHICH)
def tiny_step(request):
    """One ``adam_onecycle`` step of each package of the tiny model from
    the same variables on two frames with gt boxes."""
    which = request.param
    batch = _batch(which, 41, train=True)
    if which == 'dynamic':
        assert _recip_departures(batch['points']) == 0
    jm, variables, model = _models(which, batch)
    with jax.enable_x64(which == 'dynamic'):
        step = _one_step(jm, variables, model, {k: _t(v)
                                                for k, v in batch.items()})
    step['which'] = which
    return step


STEP_KEYS = {'pointpillar': {'loss', 'rpn_loss_cls', 'rpn_loss_loc',
                             'rpn_loss_dir', 'rpn_loss'},
             'centerpoint': {'loss', 'hm_loss', 'loc_loss', 'center_loss'}}


def test_tiny_train_step_matches_jax(tiny_step):
    """The loss terms (JAX's tb keys) within 1e-4 relative and non-zero;
    every parameter's gradient within GRAD_RTOL of the largest entry of
    its layer's (the bias of a conv before a train-mode BatchNorm has no
    gradient but rounding), every layer's gradient non-zero; parameters
    after the step within STEP_ATOL plus the first step's slack, and the
    BN running statistics (the PFN's over every pillar slot or point, the
    BEV backbone's and the head's) within STEP_ATOL + RTOL, every one
    moved."""
    step = tiny_step
    keys = STEP_KEYS['pointpillar' if step['which'] == 'pointpillar'
                     else 'centerpoint']
    jmet = step['jax_metrics']
    assert set(jmet) == keys
    for tb, loss in ((step['tb'], step['loss']),
                     (step['step_tb'], step['step_loss'])):
        assert set(tb) | {'loss'} == keys
        np.testing.assert_allclose(loss, jmet['loss'], rtol=1e-4)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jmet[k], rtol=1e-4, err_msg=k)
    assert all(v > 0 for v in jmet.values())
    want = {k: v.numpy() for k, v in step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(step['grads']) == set(want)
    layer_scale = {}
    for name, w in want.items():
        layer = name.rsplit('.', 1)[0]
        layer_scale[layer] = max(layer_scale.get(layer, 0.0),
                                 float(np.abs(w).max()))
    for name, g in step['grads'].items():
        scale = layer_scale[name.rsplit('.', 1)[0]]
        assert scale > 1e-4, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
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
    assert any(n.startswith('vfe.pfn_layers.') for n in state)
