"""One train step of the tiny IA-SSD with F-FPS and FS over dilated groups
(``fs``) and with ds-FPS (``ds``) in the port against the JAX package's
``make_train_step`` on the CPU, as ``tests/test_torch_train.py`` holds
IA-SSD's: the same variables, scenes and optimizer; loss terms, gradients,
updated parameters and BatchNorm statistics within that file's
tolerances. JAX's F-FPS picks of its step are captured and fed to each
forward of the port (equal, or within the distances' rounding slack and
replayed; ``tests/point_family_cases.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.runtime import optimization as jax_optim
from spsnet_tpu.runtime.trainer import TrainState
from spsnet_tpu.runtime.trainer import make_train_step as jax_make_train_step
from spsnet_tpu.zoo import tiny_iassd_cfg as jax_tiny_iassd_cfg
from spsnet_torch.config import EDict
from spsnet_torch.models import build_detector
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.trainer import make_train_step
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from spsnet_torch.zoo import tiny_iassd_cfg
from tests.point_family_cases import (apply_variant, jax_captures,
                                      port_replays)
from tests.test_torch_train import (EPOCHS, GRAD_RTOL, ITERS, LOSS_RTOL,
                                    OPTIM, STEP_ATOL)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, N = 2, 512


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree_to_torch(params, batch_stats=None):
    tree = {'params': _np_tree(params)}
    if batch_stats is not None:
        tree['batch_stats'] = _np_tree(batch_stats)
    return flax_to_torch(tree)


def _one_step(name, seed):
    """The JAX step (its raw gradients kept by a chained transform, as in
    ``test_torch_train.py``) and the port's: a forward and backward for
    the gradients, ``make_train_step`` on a second copy for the update."""
    pts, gt = synthetic_scene_batch(seed, B, N)
    jcfg = apply_variant(jax_tiny_iassd_cfg(), name, 'tiny')[0]
    cfg = apply_variant(tiny_iassd_cfg(), name, 'tiny')[0]
    jax_model = jax_build_detector(jcfg, num_class=3)
    variables = _np_tree(dict(jax.jit(lambda key, p: jax_model.init(
        key, {'points': p}, train=False))(jax.random.PRNGKey(seed), pts)))
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
    with jax_captures() as captured:
        new_state, metrics = jax_make_train_step(jax_model, tx)(
            state, {'points': jnp.asarray(pts), 'gt_boxes': jnp.asarray(gt)})
        jax.effects_barrier()

    batch = {'points': _t(pts), 'gt_boxes': _t(gt)}
    model = load_flax(build_detector(cfg, 3, device='cpu'), variables).train()
    with port_replays(captured) as replayed:
        out = model(batch)
    loss, tb = model.loss(out)
    loss.backward()
    model2 = load_flax(build_detector(cfg, 3, device='cpu'), variables)
    opt = optimization.build_optimizer(EDict(OPTIM), model2.parameters(),
                                       ITERS, EPOCHS)
    with port_replays(captured):
        loss2, tb2 = make_train_step(model2, opt)(batch)
    return {
        'captured': captured, 'replayed': replayed,
        'jax_metrics': {k: float(v) for k, v in metrics.items()},
        'jax_grads': _tree_to_torch(new_state.opt_state[0]),
        'jax_state': _tree_to_torch(new_state.params, new_state.batch_stats),
        'init': flax_to_torch(variables),
        'tb': {k: float(torch.as_tensor(v).detach()) for k, v in tb.items()},
        'loss': float(loss.detach()),
        'step_tb': {k: float(v) for k, v in tb2.items()},
        'step_loss': float(loss2),
        'grads': {n: p.grad for n, p in model.named_parameters()},
        'state': model2.state_dict(), 'opt': opt,
    }


_STEPS = {}


@pytest.fixture(params=['fs', 'ds'], scope='module')
def step(request):
    if request.param not in _STEPS:
        _STEPS.clear()
        _STEPS[request.param] = _one_step(request.param, seed=0)
    return _STEPS[request.param]


def test_train_step_loss_terms_match_jax(step):
    jm = step['jax_metrics']
    for tb, loss in ((step['tb'], step['loss']),
                     (step['step_tb'], step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert jm['center_pos_num'] > 0 and all(np.isfinite(list(jm.values())))
    print('F-FPS calls replayed (differing picks each):', step['replayed'])


def test_train_step_gradients_match_jax(step):
    want = {k: v for k, v in step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(step['grads']) == set(want)
    for name, g in step['grads'].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_train_step_updates_params_and_bn_stats_as_jax(step):
    """Parameters and BN running statistics after the step within
    STEP_ATOL of JAX's. Adam's first update is lr * g / (|g| + eps), so an
    entry whose gradient lies within the gradients' tolerance of zero
    (where the packages' gradients may take either sign) moves by up to
    2 lr the other way, never more; every other entry within STEP_ATOL."""
    state, want, init = step['state'], step['jax_state'], step['init']
    lr = step['opt'].lr_fn(0)
    loose = 0
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        diff = (state[name] - w).abs()
        g = step['jax_grads'].get(name)
        if g is not None:
            near_zero = g.abs() <= GRAD_RTOL * float(g.abs().max())
            assert float(diff.max()) <= 2 * lr * (1 + 1e-3), name
            loose += int((near_zero & (diff > STEP_ATOL)).sum())
            diff = torch.where(near_zero, 0.0, diff)
        np.testing.assert_array_less(diff.numpy(), STEP_ATOL, err_msg=name)
        assert not torch.equal(state[name], init[name]), f'{name} unchanged'
    assert step['opt'].count == 1
    print(f'entries of a near-zero gradient beyond {STEP_ATOL}: {loose}')
