"""CaDDN training in the port against the JAX package on the CPU: the
depth-distribution loss (``image_vfe_loss``) on depth maps with NaN,
out-of-range values and depths at the bin edges and 2D boxes with padding
rows, its refusal of a depth map the data processor has already block-
meaned to feature resolution (JAX fails to broadcast it: ROADMAP Queue
3), and one ``adam_onecycle`` step of the tiny CaDDN
(``tests/test_torch_caddn.py`` builds it) against JAX's
``make_train_step``: loss terms, gradients, updated parameters and
BatchNorm statistics, within the tolerances stated below.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.data.processor.data_processor import DataProcessor
from spsnet_tpu.models.vfe import image_vfe as jax_ivfe
from spsnet_torch.models.vfe import image_vfe
from tests.test_caddn import PCR
from tests.test_torch_caddn import _depths, tiny_caddn
from tests.test_torch_pointpillar import _t
from tests.test_torch_pointrcnn_train import _first_step_slack
from tests.test_torch_pvrcnn_train import _one_step

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
# gradients against the largest entry of each tensor's; parameters and BN
# statistics after one step (Adam's first update: _first_step_slack)
GRAD_RTOL, STEP_ATOL, RTOL = 1e-3, 1e-5, 1e-4
LOSS_ARGS = {'weight': 3.0, 'alpha': 0.25, 'gamma': 2.0, 'fg_weight': 13,
             'bg_weight': 1}
DISC = {'mode': 'LID', 'num_bins': 16, 'depth_min': 2.0, 'depth_max': 27.6}


def _loss_inputs(seed):
    """Logits (2, 17, 16, 24), full-resolution depth maps (2, 64, 96)
    with bin edges, NaN, infinite and out-of-range depths on the strided
    pixels, and 2D boxes: overlapping, one with x2 <= x1 and zero
    padding."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (2, 17, 16, 24)).astype(np.float32)
    depth = rng.uniform(0, 32, (2, 64, 96)).astype(np.float32)
    special = _depths('LID', 16, 2.0, 27.6)
    strided = depth[:, ::4, ::4].reshape(-1)
    strided[:len(special)] = special
    depth[:, ::4, ::4] = strided.reshape(2, 16, 24)
    boxes = np.zeros((2, 5, 4), np.float32)
    boxes[0, :3] = [[10, 6, 41.5, 30], [30, 20, 60, 50], [50, 5, 40, 9]]
    boxes[1, :2] = [[0, 0, 95, 12.2], [77.3, 33.1, 96, 64]]
    return logits, depth, boxes


@pytest.mark.parametrize('seed', [0, 1])
def test_image_vfe_loss_matches_jax(seed):
    """The loss within LOSS_RTOL of eager JAX's and its gradient at the
    logits within GRAD_RTOL of the largest entry; the targets JAX's bins
    bit for bit (the extra class for NaN, infinite and out-of-range
    depths), fg pixels and padding rows among the boxes."""
    logits, depth, boxes = _loss_inputs(seed)
    batch = {'depth_maps': depth, 'gt_boxes2d': boxes}

    def jax_loss(lg):
        return jax_ivfe.image_vfe_loss(
            {'depth_logits': lg}, batch, LOSS_ARGS, DISC, 4)[0]
    with jax.disable_jit():
        want, grad = jax.value_and_grad(jax_loss)(
            jnp.asarray(logits.transpose(0, 2, 3, 1)))
        target = np.asarray(jax_ivfe.bin_depths(
            jnp.asarray(depth[:, ::4, ::4]), 'LID', 2.0, 27.6, 16,
            target=True))
    got_target = image_vfe.depth_targets(_t(depth), DISC, 4, (16, 24))
    np.testing.assert_array_equal(got_target.numpy(), target)
    assert (target == 16).sum() > 10 and (target == 0).any()
    lg = _t(logits).requires_grad_()
    loss, tb = image_vfe.image_vfe_loss({'depth_logits': lg}, {
        'depth_maps': _t(depth), 'gt_boxes2d': _t(boxes)}, LOSS_ARGS, DISC,
        4)
    loss.backward()
    assert set(tb) == {'ddn_loss'}
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    g = np.asarray(grad).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(lg.grad.numpy(), g, rtol=0,
                               atol=GRAD_RTOL * float(np.abs(g).max()))


def test_depth_loss_refuses_a_processed_depth_map():
    """The JAX package's own DataProcessor block-means the depth map to
    feature resolution (``downsample_depth_map``: 64 x 96 -> 16 x 24),
    which JAX's loss then strides again (to 4 x 6) and fails to broadcast
    against the 16 x 24 logits; the port refuses it with a ValueError
    (ROADMAP Queue 3)."""
    logits, depth, boxes = _loss_inputs(2)
    proc = DataProcessor(
        [JaxEDict({'NAME': 'downsample_depth_map', 'DOWNSAMPLE_FACTOR': 4})],
        np.asarray(PCR, np.float32), training=True)
    processed = np.stack([proc.forward({'depth_maps': d.copy()})[
        'depth_maps'] for d in depth]).astype(np.float32)
    assert processed.shape == (2, 16, 24)
    with pytest.raises((TypeError, ValueError)):
        jax_ivfe.image_vfe_loss(
            {'depth_logits': jnp.asarray(logits.transpose(0, 2, 3, 1))},
            {'depth_maps': processed, 'gt_boxes2d': boxes}, LOSS_ARGS, DISC,
            4)
    with pytest.raises(ValueError, match='full-resolution'):
        image_vfe.image_vfe_loss(
            {'depth_logits': _t(logits)},
            {'depth_maps': _t(processed), 'gt_boxes2d': _t(boxes)},
            LOSS_ARGS, DISC, 4)


@pytest.fixture(scope='module')
def caddn_step():
    """One ``adam_onecycle`` step of each package's tiny CaDDN from the
    same variables on the tiny batch (two cars a frame)."""
    t = tiny_caddn()
    return _one_step(t['jm'], t['variables'], t['model'],
                     {k: _t(v) for k, v in t['batch'].items()})


def test_tiny_caddn_train_step_loss_terms_match_jax(caddn_step):
    """JAX's tb keys (the anchor head's terms and 'ddn_loss'), every term
    within LOSS_RTOL and non-zero, from the forward and from
    ``make_train_step``."""
    jm = caddn_step['jax_metrics']
    assert set(jm) == {'loss', 'rpn_loss_cls', 'rpn_loss_loc',
                       'rpn_loss_dir', 'rpn_loss', 'ddn_loss'}
    for tb, loss in ((caddn_step['tb'], caddn_step['loss']),
                     (caddn_step['step_tb'], caddn_step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert all(v > 0 for v in jm.values())


def test_tiny_caddn_train_step_gradients_match_jax(caddn_step):
    """Every parameter's gradient within GRAD_RTOL of its largest entry,
    none of them zero: the depth loss and the anchor loss reach the DDN
    through the logits and through the sampled voxels."""
    want = {k: v for k, v in caddn_step['jax_grads'].items()
            if not k.endswith('num_batches_tracked')}
    assert set(caddn_step['grads']) == set(want)
    for name, g in caddn_step['grads'].items():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_tiny_caddn_train_step_updates_params_and_bn_stats_as_jax(
        caddn_step):
    """Parameters after the step within STEP_ATOL plus each entry's
    first-step slack; the running means and variances of every BatchNorm
    (the DDN's, the channel reduce's, the collapse's and the BEV
    backbone's, flax's biased-variance rule) within STEP_ATOL + RTOL;
    every one of them moved."""
    state, want, init = caddn_step['state'], caddn_step['jax_state'], \
        caddn_step['init']
    opt = caddn_step['opt']
    slack = _first_step_slack(caddn_step['grads'], caddn_step['jax_grads'],
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
    assert n_stats == 2 * (11 + 1 + 4) and opt.count == 1

