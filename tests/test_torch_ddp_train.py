"""The port's data-parallel train step at world 2 on the CPU.

Two worker processes over gloo (``tests/torch_ddp_cases.py``, spawned once
for the module) each take one step of the tiny IA-SSD, SPSNet (the
stability hook's ``stability`` and ``random`` deletion), PointRCNN and
PV-RCNN on their half of a batch, through ``make_train_step(...,
group=)`` under DistributedDataParallel; then, split between them, the
one-process step over the joined batch. The halves hold unequal numbers of
positives, so a rank's loss normalized over its own half (what plain DDP
trains) is another objective: a variant with IA-SSD's normalizers local
must fall outside the tolerances. IA-SSD's world-2 step is also held to
the JAX package's ``make_train_step`` over the joined batch, and the
``Trainer`` runs two epochs at world 2 with a ``ShardedSampler``.
"""
import jax
import jax.numpy as jnp
import numpy as np
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
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from spsnet_torch.zoo import tiny_iassd_cfg
from tests import torch_ddp_cases as cases
from tests.test_torch_spsnet_train import _first_step_slack

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

CASES = ('iassd', 'spsnet_stability', 'spsnet_random', 'pointrcnn',
         'pvrcnn')
# world 2 against the joined step. Both run fp32 and differ by rounding
# alone: the ranks' partial sums (of BN statistics, losses, gradients)
# meet in another order. Loss terms: 1e-5 relative (3.9e-6 measured), but
# PointRCNN's RoI terms (1.3e-5 measured: the RoIs' boxes carry the
# forward's rounding into the pooled frames). Gradients, each tensor's
# relative L2 before the clip: training BatchNorm's 1/std carries the
# forward's ~1e-7 differences back through every layer, as far as a 1e-7
# weight jitter moves the joined step's own gradients (within 3.2x of it
# a tensor, measured): up to 5.3e-5 measured, PointRCNN 1.8e-4 (the RoIs'
# gradient into the point head's box layer, which a 1e-7 jitter moves by
# 3e-2). BN running statistics, all of them at once: 2.2e-7 measured
LOSS_RTOL = {'pointrcnn': 1e-4}
GRAD_RTOL = {'pointrcnn': 1e-3}
DEFAULT_LOSS_RTOL, DEFAULT_GRAD_RTOL, BN_RTOL = 1e-5, 2e-4, 1e-6
# a gradient that is zero in exact arithmetic (a bias before training
# BatchNorm, which subtracts it again): within this of the model's largest
# gradient entry (2.3e-10 measured)
ZERO_GRAD = ('backbone_3d.SF_extract.convs.3.layer_last.linear.bias',)
ZERO_GRAD_TOL = 1e-6
# parameters after the step: STEP_ATOL plus each entry's first-step slack
# (``test_torch_spsnet_train._first_step_slack``)
STEP_ATOL = 1e-5
# IA-SSD's world-2 step against JAX over the joined batch: the tolerances
# of test_torch_train.py (loss terms, gradients against each tensor's
# largest entry, parameters and BN statistics after the step)
JAX_LOSS_RTOL, JAX_GRAD_RTOL, JAX_STEP_ATOL = 5e-5, 1e-3, 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_step(variables, pts, gt):
    """JAX's make_train_step over the joined batch, its optimizer behind a
    transform that keeps the raw gradients: (metrics, raw gradients,
    parameters and BN statistics after the step) as torch state dicts."""
    model = jax_build_detector(jax_tiny_iassd_cfg(), num_class=3)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(keep, jax_optim.build_optimizer(
        EDict(cases.OPTIM), cases.ITERS, cases.EPOCHS))
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = TrainState(
        params=params, batch_stats=jax.tree_util.tree_map(
            jnp.asarray, variables['batch_stats']),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    new, metrics = jax_make_train_step(model, tx)(
        state, {'points': jnp.asarray(pts), 'gt_boxes': jnp.asarray(gt)})
    return ({k: float(v) for k, v in metrics.items()},
            flax_to_torch({'params': _np_tree(new.opt_state[0])}),
            flax_to_torch({'params': _np_tree(new.params),
                           'batch_stats': _np_tree(new.batch_stats)}))


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    """The ranks' records ({case: record}, the joined steps under
    '{case}_joined'), IA-SSD's initial state and JAX's step, which runs
    here while the ranks run."""
    out = tmp_path_factory.mktemp('ddp_train')
    pts, gt = synthetic_scene_batch(cases.IASSD_SEED, 2 * cases.IASSD_B,
                                    cases.IASSD_N)
    jax_model = jax_build_detector(jax_tiny_iassd_cfg(), num_class=3)
    variables = _np_tree(dict(jax.jit(lambda key, p: jax_model.init(
        key, {'points': p}, train=False))(jax.random.PRNGKey(0), pts)))
    init = load_flax(build_detector(tiny_iassd_cfg(), 3, device='cpu'),
                     variables).state_dict()
    torch.save(init, out / 'iassd_init.pt')
    procs = cases.start('train', out)
    try:
        jax_rec = _jax_step(variables, pts, gt)
    finally:
        ranks = cases.finish(procs, 'train', out)
    joined = {k[:-len('_joined')]: v for r in ranks for k, v in r.items()
              if k.endswith('_joined')}
    return {'ranks': ranks, 'joined': joined, 'init': init, 'jax': jax_rec}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _grads_within(grads, want, rtol):
    """Each tensor's relative L2 within ``rtol``; the zero gradients of
    ZERO_GRAD within ZERO_GRAD_TOL of the largest entry."""
    assert set(grads) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if name in ZERO_GRAD:
            assert max(float(grads[name].abs().max()),
                       float(w.abs().max())) <= ZERO_GRAD_TOL * top, name
            continue
        rel = _rel_l2(grads[name], w)
        assert rel <= rtol, f'{name}: relative L2 {rel:.3e} over {rtol}'


@pytest.mark.parametrize('name', CASES)
def test_world2_loss_terms_match_the_joined_step(world2, name):
    """The loss and every tb term (the joined batch's, summed from the
    ranks' shares) on both ranks: the joined step's."""
    rtol = LOSS_RTOL.get(name, DEFAULT_LOSS_RTOL)
    want = world2['joined'][name]
    for rank in world2['ranks']:
        got = rank[name]
        assert set(got['tb']) == set(want['tb'])
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=rtol)
        for k, v in want['tb'].items():
            np.testing.assert_allclose(got['tb'][k], v, rtol=rtol,
                                       atol=1e-12, err_msg=k)
    assert np.isfinite(want['loss']) and want['loss'] > 0


@pytest.mark.parametrize('name', CASES)
def test_world2_takes_the_joined_steps_indices(world2, name):
    """FPS picks, ball-query indices and sampled RoIs of the two ranks,
    stacked, are the joined step's, and so are the points the stability
    hook keeps (its random deletion draws the joined batch's noise)."""
    r0, r1 = (r[name] for r in world2['ranks'])
    want = world2['joined'][name]
    for key in ('fps', 'ball', 'rois'):
        assert len(r0['idx'][key]) == len(r1['idx'][key]) == \
            len(want['idx'][key])
        for a, b, w in zip(r0['idx'][key], r1['idx'][key], want['idx'][key]):
            assert torch.equal(torch.cat([a, b]), w), key
    assert want['idx']['fps'] and want['idx']['ball']
    if name in ('pointrcnn', 'pvrcnn'):
        assert want['idx']['rois']
    if name.startswith('spsnet'):
        assert torch.equal(torch.cat([r0['kept'][0], r1['kept'][0]]),
                           want['kept'][0])


@pytest.mark.parametrize('name', CASES)
def test_world2_gradients_match_the_joined_step(world2, name):
    """The gradient DDP leaves before the clip: bit for bit the same on
    both ranks, and each tensor the joined step's."""
    r0, r1 = (r[name] for r in world2['ranks'])
    for k, g in r0['grads'].items():
        assert torch.equal(g, r1['grads'][k]), k
    _grads_within(r0['grads'], world2['joined'][name]['grads'],
                  GRAD_RTOL.get(name, DEFAULT_GRAD_RTOL))


@pytest.mark.parametrize('name', CASES)
def test_world2_update_and_bn_statistics_match_the_joined_step(world2, name):
    """After the AdamW step both ranks hold the same state, bit for bit;
    its parameters are the joined step's within STEP_ATOL plus each
    entry's first-step slack, its BN running statistics within BN_RTOL."""
    r0, r1 = (r[name] for r in world2['ranks'])
    want = world2['joined'][name]
    for k, v in r0['state'].items():
        assert torch.equal(v, r1['state'][k]), k
    slack = _first_step_slack(r0['grads'], want['grads'], want['lr'],
                              cases.OPTIM['GRAD_NORM_CLIP'])
    stats = []
    for k, w in want['state'].items():
        if k.endswith('num_batches_tracked'):
            continue
        if k.endswith(('running_mean', 'running_var')):
            stats.append(k)
            continue
        diff = (r0['state'][k] - w).abs()
        assert (diff <= STEP_ATOL + slack[k]).all(), (
            f'{k}: largest difference {float(diff.max()):.3e}')
    a = torch.cat([r0['state'][k].double().flatten() for k in stats])
    b = torch.cat([want['state'][k].double().flatten() for k in stats])
    assert stats and _rel_l2(a, b) <= BN_RTOL


def test_world2_iassd_step_matches_jax(world2):
    """IA-SSD's world-2 step against JAX's one program over the joined
    batch: loss terms, gradients and the state after the step."""
    metrics, grads, state = world2['jax']
    got = world2['ranks'][0]['iassd']
    assert set(got['tb']) | {'loss'} == set(metrics)
    np.testing.assert_allclose(got['loss'], metrics['loss'],
                               rtol=JAX_LOSS_RTOL)
    for k, v in got['tb'].items():
        np.testing.assert_allclose(v, metrics[k], rtol=JAX_LOSS_RTOL,
                                   err_msg=k)
    grads = {k: v for k, v in grads.items()
             if not k.endswith('num_batches_tracked')}
    assert set(got['grads']) == set(grads)
    for name, g in got['grads'].items():
        scale = float(grads[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), rtol=0,
                                   atol=JAX_GRAD_RTOL * scale, err_msg=name)
    for name, w in state.items():
        if name.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(got['state'][name].numpy(), w.numpy(),
                                   rtol=0, atol=JAX_STEP_ATOL, err_msg=name)
        assert not torch.equal(got['state'][name], world2['init'][name])


def test_per_rank_normalization_is_refused(world2):
    """The ranks hold unequal numbers of positives; with IA-SSD's
    normalizers over each rank's own half and the ranks' gradients
    averaged (plain DDP), loss terms and gradients fall outside the
    tolerances of the joined step that the global step meets."""
    pos = [r['iassd']['pos'][0] for r in world2['ranks']]
    assert pos[0] != pos[1] and min(pos) > 0
    local = world2['ranks'][0]['iassd_local']
    want = world2['joined']['iassd']
    worst = max(abs(local['tb'][k] - v) / max(abs(v), 1e-12)
                for k, v in want['tb'].items())
    assert worst > 100 * DEFAULT_LOSS_RTOL
    with pytest.raises(AssertionError, match='relative L2'):
        _grads_within(local['grads'], want['grads'], DEFAULT_GRAD_RTOL)
    assert max(_rel_l2(local['grads'][k], w)
               for k, w in want['grads'].items()) > 100 * DEFAULT_GRAD_RTOL


def test_world2_trainer_saves_on_rank0_and_resumes_equal(world2):
    """Two epochs of the tiny IA-SSD ``Trainer`` at world 2: rank 0 alone
    writes checkpoints 1 and 2; one epoch, a resume on both ranks and the
    second epoch end in the state of the two epochs straight through, on
    both ranks; the checkpoint (no DDP prefix) loads into a model at
    world 1."""
    r0, r1 = (r['trainer'] for r in world2['ranks'])
    assert r0['straight']['saves'] == [1, 2] and r1['straight']['saves'] == []
    assert r0['straight']['files'] == r1['straight']['files'] == [
        'checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth']
    assert r0['resumed']['saves'] == [2] and r1['resumed']['saves'] == []
    assert r0['resumed']['count'] == r1['resumed']['count'] == 2
    straight = r0['straight']['state']
    for rank in (r0, r1):
        for k, v in rank['resumed']['state'].items():
            assert torch.equal(v, straight[k]), k
    assert not any(k.startswith('module.') for k in straight)
    model = build_detector(tiny_iassd_cfg(), 3, device='cpu')
    model.load_state_dict(straight)
