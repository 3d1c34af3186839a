"""The port's SPSNet training against the JAX package on the CPU.

Two train steps: the detector's, with the frozen stability model and the
deletion inside it, and the stability model's own (targets, the four-term
loss, the one-cycle Adam step). Then S-FPS, the ``Trainer`` on the tiny
SPSNet config and the stability checkpoint converter. Tiny configs
(``tiny_spsnet_cfg``, ``tiny_stability_model_cfg``) on synthetic scenes of
256 points with gt boxes; flax variables from fixed keys cross through the
weight bridge, and the latent noise the port draws is handed to the JAX
model in place of its own draw. Indices must be identical; floats stay
within the tolerances of ``test_torch_train.py`` (both packages run fp32,
summing in another order).
"""
import os
import signal

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from spsnet_tpu import ops as jops
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models import samplers as jax_samplers
from spsnet_tpu.models.sa_module import \
    SAModuleMSGWithSampling as JaxSAModule
from spsnet_tpu.runtime import optimization as jax_optim
from spsnet_tpu.runtime.checkpoint import CheckpointManager as JaxCheckpoints
from spsnet_tpu.runtime.trainer import TrainState
from spsnet_tpu.runtime.trainer import make_train_step as jax_make_train_step
from spsnet_tpu.stability import hook as jax_hook
from spsnet_tpu.stability import model as jax_stability
from spsnet_tpu.utils.synthetic import synthetic_scene_batch as jax_scenes
from spsnet_tpu.zoo import tiny_spsnet_cfg as jax_tiny_spsnet_cfg
from spsnet_torch.config import EDict
from spsnet_torch.models import build_detector, samplers
from spsnet_torch.models.sa_module import SAModuleMSGWithSampling
from spsnet_torch.runtime import optimization, trainer as port_trainer
from spsnet_torch.runtime.trainer import (StabilityPreprocess, Trainer,
                                          make_stability_preprocess,
                                          make_train_step)
from spsnet_torch.stability import model as stability
from spsnet_torch.stability.model import GenerateCenter
from spsnet_torch.stability.train import (latent_generator,
                                          make_stability_train_step)
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import (flax_to_torch,
                                        generator_flax_to_torch, load_flax)
from spsnet_torch.zoo import (stability_cfg, tiny_spsnet_cfg,
                              tiny_stability_model_cfg)
from tools.stability_ckpt_to_torch import convert

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, N, DELETE = 2, 256, 32
SEED = 42
ITERS, EPOCHS = 10, 2
OPTIM = {'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': EPOCHS,
         'OPTIMIZER': 'adam_onecycle', 'LR': 0.002, 'WEIGHT_DECAY': 0.01,
         'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
         'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [1, 2], 'LR_DECAY': 0.1,
         'LR_CLIP': 0.0000001, 'GRAD_NORM_CLIP': 10}
# the tolerances of test_torch_train.py: loss terms (fp32 sums in another
# order), gradients per tensor against its largest entry (BatchNorm's 1/std
# carries the forward's differences back), parameters and BN statistics
# after one Adam step (its first update is lr * sign(g) where |g| >> eps)
LOSS_RTOL = 5e-5
GRAD_RTOL = 1e-3
STEP_ATOL = 1e-5
# stds: a sum of exp(0.5 * logvar) after the stability SA's MLPs, summed in
# another order by the two packages (test_torch_spsnet.py)
STDS_RTOL = 1e-5
# one sss_aware score of a training forward: BatchNorm normalises with the
# batch's own statistics, whose 1/std amplifies the forward's fp32
# differences (the class logits differ ~1.5e-5, the scores ~2.7e-6
# measured); the picks are compared only where the top-k gap is wider
TRAIN_SCORE_TOL = 1e-5
# SF_extract.convs.3.layer_last's bias adds one constant to surface
# channels that reach the loss only through the vote layer's Linear and
# train-mode BatchNorm, which removes any constant: its gradient is zero in
# exact arithmetic, and what each package computes is rounding noise
# (1e-8 of the model's largest gradient entry measured)
ZERO_GRAD = ('backbone_3d.SF_extract.convs.3.layer_last.linear.bias',)
ZERO_GRAD_TOL = 1e-6
# AdamW's eps: the first step moves an entry by lr * g / (|g| + eps)
ADAM_EPS = 1e-8


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_vars(model, rngs, *args, **kwargs):
    variables = jax.jit(lambda r, *a: model.init(r, *a, **kwargs))(rngs, *args)
    return _np_tree(dict(variables))


def _jax_generator():
    return jax_stability.GenerateCenter(
        model_cfg=StaticConfig(tiny_stability_model_cfg()))


def _keep_grads(tx):
    """``tx`` behind a transform whose state keeps the raw gradients."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))
    return optax.chain(keep, tx)


def _assert_grads_match(grads, want, zero=()):
    """Each tensor within GRAD_RTOL of its largest entry; those named in
    ``zero`` (an exact gradient of zero) within ZERO_GRAD_TOL of the
    model's largest entry, in both packages."""
    want = {k: v for k, v in want.items()
            if not k.endswith('num_batches_tracked')}
    assert set(grads) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        w = want[name].numpy()
        if name in zero:
            assert max(float(g.abs().max()), float(np.abs(w).max())) <= \
                ZERO_GRAD_TOL * top, name
            continue
        scale = float(np.abs(w).max())
        assert scale > 0, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def _assert_state_matches(state, want, init, slack=None):
    """Parameters and BN statistics after the step within STEP_ATOL, plus,
    per entry, the ``slack`` of its parameter (``_first_step_slack``)."""
    slack = slack or {}
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        diff = (state[name] - w).abs()
        bound = STEP_ATOL + slack.get(name, torch.zeros(()))
        assert (diff <= bound).all(), (
            f'{name}: {int((diff > bound).sum())} entries beyond the bound, '
            f'largest difference {float(diff.max()):.3e}')
        assert not torch.equal(state[name], init[name]), f'{name} unchanged'


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


def _ten_column(gt, seed):
    """(B, T, 8) boxes as (B, T, 10): two velocity columns before the
    class, zero on padding rows."""
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, 2, gt.shape[:2] + (2,)).astype(np.float32)
    vel *= (gt[..., -1:] > 0)
    return np.concatenate([gt[..., :7], vel, gt[..., 7:]], axis=-1)


# ------------------------------------------------------- (a) the targets


@pytest.mark.parametrize('columns', [8, 10])
def test_stability_targets_match_jax(columns):
    """The foreground (exact boxes, the 0.5 ring ignored) identical, the
    offsets to the box centres within 1e-6; 10-column boxes drop their
    velocities."""
    pts, gt = jax_scenes(3, B, N)
    if columns == 10:
        gt = _ten_column(gt, 3)
    xyz = pts[..., :3].copy()
    fg, off = stability.assign_stability_targets(_t(xyz), _t(gt))
    jfg, joff = jax_stability.assign_stability_targets(jnp.asarray(xyz),
                                                       jnp.asarray(gt))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))
    np.testing.assert_allclose(off.numpy(), np.asarray(joff), rtol=0,
                               atol=1e-6)
    assert fg.any() and not fg.all()


# --------------------------------------------------------- (b) the loss


def _jax_loss_and_grads(model, variables, batch, gt, eps):
    """The JAX package's training forward with ``eps`` as its latent
    noise, ``generate_center_loss`` and its gradients."""
    def loss_fn(params):
        ret, _ = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch, train=True, mutable=['batch_stats'],
            rngs={'latent': jax.random.PRNGKey(0)})
        return jax_stability.generate_center_loss(params, ret, gt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'normal', lambda key, shape: jnp.asarray(eps))
        (_, tb), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, variables['params']))
    return tb, grads


@pytest.fixture(scope='module')
def center_loss():
    """``generate_center_loss`` of both packages on one training forward
    of the same weights, scenes and latent noise."""
    pts, gt = jax_scenes(6, B, N)
    model = _jax_generator()
    variables = _jax_vars(model, {'params': jax.random.PRNGKey(8),
                                  'latent': jax.random.PRNGKey(9)},
                          {'points': jnp.asarray(pts)}, train=True)
    port = load_flax(GenerateCenter(tiny_stability_model_cfg()), variables,
                     convert=generator_flax_to_torch).train()
    ret = port({'points': _t(pts)}, torch.Generator().manual_seed(4))
    loss, tb = stability.generate_center_loss(port, ret, _t(gt))
    loss.backward()
    eps = torch.randn(ret['mu'].shape,
                      generator=torch.Generator().manual_seed(4)).numpy()
    jtb, jgrads = _jax_loss_and_grads(model, variables,
                                      {'points': jnp.asarray(pts)},
                                      jnp.asarray(gt), eps)
    return {'tb': {k: float(v.detach()) for k, v in tb.items()},
            'jax_tb': {k: float(v) for k, v in jtb.items()},
            'grads': {n: p.grad for n, p in port.named_parameters()},
            'jax_grads': generator_flax_to_torch({'params': _np_tree(jgrads)}),
            'n_params': len(list(port.parameters())),
            'n_leaves': len(jax.tree_util.tree_leaves(variables['params']))}


def test_center_loss_terms_match_jax(center_loss):
    tb, jtb = center_loss['tb'], center_loss['jax_tb']
    assert set(tb) == set(jtb) == {'center_loss_box', 'l2_reg',
                                   'lattent_loss', 'lattent_loss2', 'loss'}
    for k in jtb:
        np.testing.assert_allclose(tb[k], jtb[k], rtol=LOSS_RTOL, err_msg=k)
        assert np.isfinite(jtb[k]) and jtb[k] > 0, k


def test_center_loss_gradients_match_jax(center_loss):
    _assert_grads_match(center_loss['grads'], center_loss['jax_grads'])


def test_l2_term_covers_the_flax_params_leaves(center_loss):
    """A sum of norms over exactly as many tensors as flax's ``params`` has
    leaves: the BatchNorm scales and biases in, the running statistics
    out."""
    assert center_loss['n_params'] == center_loss['n_leaves']
    port = GenerateCenter(tiny_stability_model_cfg())
    with torch.no_grad():
        for p in port.parameters():
            p.fill_(0.5)
    want = 5e-4 * sum(0.5 * np.sqrt(p.numel()) for p in port.parameters())
    np.testing.assert_allclose(
        float(5e-4 * stability.params_l2_norm_sum(port)), want, rtol=1e-6)


# ------------------------------------------- (c) the stability train step


@pytest.fixture(scope='module')
def stability_step():
    """One step of ``tools/train_stability.py:81-97``, rebuilt from the JAX
    package's pieces, and one of ``make_stability_train_step``, from the
    same variables, scenes, latent noise and ``sf_unc.yaml``
    OPTIMIZATION."""
    optim = EDict(dict(stability_cfg().OPTIMIZATION, NUM_EPOCHS=EPOCHS))
    pts, gt = jax_scenes(11, B, N)
    model = _jax_generator()
    variables = _jax_vars(model, {'params': jax.random.PRNGKey(SEED),
                                  'latent': jax.random.PRNGKey(SEED + 1)},
                          {'points': jnp.asarray(pts)}, train=True)
    port = load_flax(GenerateCenter(tiny_stability_model_cfg()), variables,
                     convert=generator_flax_to_torch)
    opt = optimization.build_optimizer(optim, port.parameters(), ITERS,
                                       EPOCHS)
    loss, tb = make_stability_train_step(port, opt, SEED)(
        {'points': _t(pts), 'gt_boxes': _t(gt)})

    tx = jax_optim.build_optimizer(optim, ITERS, EPOCHS)
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = TrainState(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, variables['batch_stats']), opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32))

    def train_step(state, batch):
        rng = jax.random.fold_in(jax.random.PRNGKey(SEED), state.step)

        def compute(params):
            ret, mut = model.apply(
                {'params': params, 'batch_stats': state.batch_stats},
                batch, train=True, mutable=['batch_stats'],
                rngs={'latent': rng})
            loss, tb = jax_stability.generate_center_loss(
                params, ret, batch['gt_boxes'])
            return loss, (tb, mut.get('batch_stats', {}))

        (_, (tb, bs)), grads = jax.value_and_grad(compute, has_aux=True)(
            state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(params=optax.apply_updates(state.params, updates),
                          batch_stats=bs, opt_state=opt_state,
                          step=state.step + 1), tb

    eps = torch.randn((B, N, int(tiny_stability_model_cfg().LATENT_DIM)),
                      generator=latent_generator(SEED, 0)).numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'normal', lambda key, shape: jnp.asarray(eps))
        new_state, jtb = jax.jit(train_step)(
            state, {'points': jnp.asarray(pts), 'gt_boxes': jnp.asarray(gt)})
    return {'tb': {k: float(v) for k, v in tb.items()}, 'loss': float(loss),
            'jax_tb': {k: float(v) for k, v in jtb.items()},
            'state': port.state_dict(), 'opt': opt,
            'jax_state': generator_flax_to_torch({
                'params': _np_tree(new_state.params),
                'batch_stats': _np_tree(new_state.batch_stats)}),
            'init': generator_flax_to_torch(variables)}


def test_stability_step_loss_terms_match_jax(stability_step):
    tb, jtb = stability_step['tb'], stability_step['jax_tb']
    assert set(tb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(tb[k], jtb[k], rtol=LOSS_RTOL, err_msg=k)
    assert stability_step['loss'] == tb['loss']


def test_stability_step_updates_params_and_bn_stats_as_jax(stability_step):
    """Parameters, BN running means and variances after the step."""
    _assert_state_matches(stability_step['state'], stability_step['jax_state'],
                          stability_step['init'])
    assert stability_step['opt'].count == 1


def test_stability_latent_noise_follows_seed_and_step():
    """(seed, step) picks the noise; the same pair draws the same noise on
    any device, another pair other noise."""
    pairs = ((1, 0), (1, 0), (1, 1), (2, 0), (1, 2 ** 32), (0, 1))
    draw = [torch.randn(4, generator=latent_generator(s, k))
            for s, k in pairs]
    assert torch.equal(draw[0], draw[1])
    for other in draw[2:]:
        assert not torch.equal(draw[0], other)


# ------------------------------- (d) the SPSNet train step with the hook


def _record_sss(module, stash):
    """Wrap ``module.sample_sss_aware`` so each call stores its inputs and
    picks in ``stash``; returns the original."""
    own = module.sample_sss_aware

    def sampler(cls_features, stds, npoint):
        idx, out = own(cls_features, stds, npoint)
        stash.append((cls_features, stds, idx))
        return idx, out
    module.sample_sss_aware = sampler
    return own


@pytest.fixture(scope='module')
def spsnet_step():
    """One train step of each package on the tiny SPSNet with the frozen
    tiny stability model inside it, from the same variables and scenes:
    the JAX ``make_train_step(..., preprocess=)`` (its optimizer behind a
    transform that keeps the raw gradients), and the port's forward and
    backward (for the gradients) and ``make_train_step(..., preprocess)``
    on a second copy (for the update)."""
    pts, gt = jax_scenes(0, B, N)
    jbatch = {'points': jnp.asarray(pts), 'gt_boxes': jnp.asarray(gt)}
    gen = _jax_generator()
    gen_vars = _jax_vars(gen, {'params': jax.random.PRNGKey(1),
                               'latent': jax.random.PRNGKey(5)},
                         {'points': jbatch['points']}, train=True)

    def jax_preprocess(batch, rng):
        return jax_hook.apply_stability_hook(gen.apply, gen_vars, batch, rng,
                                             delete_number=DELETE)

    kept = jax_preprocess(jbatch, jax.random.PRNGKey(0))
    jax_stds = np.asarray(gen.apply(gen_vars, {'points': jbatch['points']},
                                    train=False)['stds'])
    cfg = jax_tiny_spsnet_cfg()
    model = jax_build_detector(cfg, num_class=3)
    variables = _jax_vars(model, jax.random.PRNGKey(0),
                          {'points': kept['points'], 'stds': kept['stds']},
                          train=False)
    tx = _keep_grads(jax_optim.build_optimizer(EDict(OPTIM), ITERS, EPOCHS))
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = TrainState(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, variables['batch_stats']), opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32))
    new_state, metrics = jax_make_train_step(
        model, tx, preprocess=jax_preprocess)(state, jbatch)
    # the sss_aware picks of the same training forward, for the gap check
    jax_sss = []
    own = _record_sss(jax_samplers, jax_sss)
    try:
        def forward(v, b):
            jax_sss.clear()
            model.apply(v, b, train=True, mutable=['batch_stats'])
            return list(jax_sss)
        jax_sss = jax.jit(forward)(
            variables, {'points': kept['points'], 'stds': kept['stds'],
                        'gt_boxes': jbatch['gt_boxes']})
    finally:
        jax_samplers.sample_sss_aware = own

    tgen = load_flax(GenerateCenter(tiny_stability_model_cfg()), gen_vars,
                     convert=generator_flax_to_torch).eval()
    for p in tgen.parameters():
        p.requires_grad_(False)
    gen_before = {k: v.clone() for k, v in tgen.state_dict().items()}
    pre = StabilityPreprocess(tgen, DELETE, 'stability')
    batch = {'points': _t(pts), 'gt_boxes': _t(gt)}
    port = load_flax(build_detector(tiny_spsnet_cfg(), 3, device='cpu'),
                     variables).train()
    with torch.no_grad():
        stds = tgen(batch)['stds']
        port_kept = pre(batch, torch.Generator().manual_seed(0))
    sss = []
    own = _record_sss(samplers, sss)
    try:
        loss, tb = port.loss(port(port_kept))
    finally:
        samplers.sample_sss_aware = own
    loss.backward()
    port2 = load_flax(build_detector(tiny_spsnet_cfg(), 3, device='cpu'),
                      variables)
    opt = optimization.build_optimizer(EDict(OPTIM), port2.parameters(),
                                       ITERS, EPOCHS)
    loss2, tb2 = make_train_step(port2, opt, pre)(batch)
    return {
        'jax_metrics': {k: float(v) for k, v in metrics.items()},
        'jax_grads': flax_to_torch({'params': _np_tree(
            new_state.opt_state[0])}),
        'jax_state': flax_to_torch({
            'params': _np_tree(new_state.params),
            'batch_stats': _np_tree(new_state.batch_stats)}),
        'init': flax_to_torch(variables),
        'tb': {k: float(torch.as_tensor(v).detach()) for k, v in tb.items()},
        'loss': float(loss.detach()),
        'step_tb': {k: float(v) for k, v in tb2.items()},
        'step_loss': float(loss2),
        'grads': {n: p.grad for n, p in port.named_parameters()},
        'state': port2.state_dict(), 'opt': opt, 'port2': port2,
        'gen': tgen, 'gen_before': gen_before,
        'stds': stds.numpy(), 'jax_stds': jax_stds,
        'fake': np.asarray(jops.points_in_boxes(jbatch['points'][..., :3],
                                                jbatch['gt_boxes'][..., :7])),
        'kept': port_kept, 'jax_kept': kept, 'sss': sss, 'jax_sss': jax_sss}


def test_spsnet_step_deletes_the_same_points(spsnet_step):
    """The hook inside the step keeps the JAX package's points once the
    DELETE-th and next foreground stds lie further apart than the packages'
    stds differ (else the seed is unfit, and this says so)."""
    s = spsnet_step
    np.testing.assert_allclose(s['stds'], s['jax_stds'], rtol=STDS_RTOL)
    diff = float(np.abs(s['stds'] - s['jax_stds']).max())
    for b in range(B):
        fg = np.sort(s['jax_stds'][b][s['fake'][b] >= 0])
        assert fg.size > DELETE
        gap = fg[DELETE] - fg[DELETE - 1]
        assert gap > 2 * diff, f'scene {b}: near-tie {gap:.2e}'
    np.testing.assert_array_equal(s['kept']['points'].numpy(),
                                  np.asarray(s['jax_kept']['points']))
    np.testing.assert_allclose(s['kept']['stds'].numpy(),
                               np.asarray(s['jax_kept']['stds']),
                               rtol=STDS_RTOL)
    assert s['kept']['points'].shape == (B, N - DELETE, 4)


def test_spsnet_step_sss_aware_picks_are_identical(spsnet_step):
    """Both sss_aware layers of the training forward pick the same points,
    guarded by the top-k gap of the JAX package's scores."""
    s = spsnet_step
    assert len(s['sss']) == len(s['jax_sss']) == 2
    for (cls, stds, idx), (jcls, jstds, jidx) in zip(s['sss'], s['jax_sss']):
        t = samplers.sss_aware_scores(cls.detach(), stds).numpy()
        js = np.asarray(jax.nn.sigmoid(jnp.max(jcls, -1))
                        * jax_samplers.stability_score(jstds))
        diff = float(np.abs(t - js).max())
        assert diff < TRAIN_SCORE_TOL, f'scores differ by {diff:.2e}'
        top = -np.sort(-js, axis=-1)[:, :idx.shape[1] + 1]
        gap = float((top[:, :-1] - top[:, 1:]).min())
        assert gap > 2 * diff, f'near-tie {gap:.2e}'
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_spsnet_step_loss_terms_match_jax(spsnet_step):
    jm = spsnet_step['jax_metrics']
    for tb, loss in ((spsnet_step['tb'], spsnet_step['loss']),
                     (spsnet_step['step_tb'], spsnet_step['step_loss'])):
        assert set(tb) | {'loss'} == set(jm)
        np.testing.assert_allclose(loss, jm['loss'], rtol=LOSS_RTOL)
        for k, v in tb.items():
            np.testing.assert_allclose(v, jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert all(np.isfinite(list(jm.values())))


def test_spsnet_step_gradients_match_jax(spsnet_step):
    _assert_grads_match(spsnet_step['grads'], spsnet_step['jax_grads'],
                        zero=ZERO_GRAD)


def test_spsnet_step_updates_params_and_bn_stats_as_jax(spsnet_step):
    """Parameters and BN statistics within STEP_ATOL, plus the first-step
    slack of each entry's two gradients (the zero-gradient bias and the
    entries whose gradient is near AdamW's eps take it)."""
    opt = spsnet_step['opt']
    slack = _first_step_slack(spsnet_step['grads'], spsnet_step['jax_grads'],
                              opt.lr_fn(0), opt.max_norm)
    _assert_state_matches(spsnet_step['state'], spsnet_step['jax_state'],
                          spsnet_step['init'], slack)
    assert opt.count == 1


def test_spsnet_step_leaves_the_frozen_generator_alone(spsnet_step):
    """The generator stays in eval mode with its weights and BatchNorm
    statistics bit-unchanged, outside the detector and its optimizer."""
    gen = spsnet_step['gen']
    assert not gen.training
    for k, v in gen.state_dict().items():
        assert torch.equal(v, spsnet_step['gen_before'][k]), k
    ids = {id(p) for p in gen.parameters()}
    assert not ids & {id(p) for p in spsnet_step['port2'].parameters()}
    assert not ids & {id(p) for p in spsnet_step['opt'].params}


# ------------------------------------ (e) the random method in the step


def test_random_deletion_follows_the_step_count():
    """The random method draws its noise from the optimizer's update count:
    the same count deletes the same points, another count others."""
    pre = make_stability_preprocess(
        EDict({'CKPT': None, 'DELETE_NUMBER': DELETE,
               'DELETE_METHOD': 'random',
               'MODEL': tiny_stability_model_cfg()}), 'cpu')
    pts, gt = synthetic_scene_batch(4, B, N)
    batch = {'points': _t(pts), 'gt_boxes': _t(gt)}

    def run(steps):
        kept = []

        def recording(b, generator):
            out = pre(b, generator)
            kept.append(out['points'])
            return out
        model = build_detector(tiny_spsnet_cfg(), 3, device='cpu')
        opt = optimization.build_optimizer(EDict(OPTIM), model.parameters(),
                                           ITERS, EPOCHS)
        step = make_train_step(model, opt, recording)
        for _ in range(steps):
            step(batch)
        return kept

    first, again = run(2), run(1)
    assert torch.equal(first[0], again[0])
    assert not torch.equal(first[0], first[1])


# ---------------------------------------------------------- (f) S-FPS


def _sfps_inputs(seed):
    pts = jax_scenes(seed, B, N)[0][..., :3].copy()
    stds = np.random.default_rng(seed).uniform(0.5, 30.0, (B, N)).astype(
        np.float32)
    return pts, stds


@pytest.mark.parametrize('min_unique', [0, 65])
def test_sample_sfps_matches_jax(min_unique):
    """Both branches: ``min_unique`` = 0 keeps the swapped picks, one above
    npoint falls back to the D-FPS picks. Indices and carried stds
    identical."""
    pts, stds = _sfps_inputs(7)
    npoint, radius, nsample = 64, 1.6, 8
    idx, got_stds = samplers.sample_sfps(_t(pts), _t(stds), npoint, radius,
                                         nsample, min_unique=min_unique)
    want, want_stds = jax_samplers.sample_sfps(
        jnp.asarray(pts), jnp.asarray(stds), npoint, radius, nsample,
        min_unique=min_unique)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_stds.numpy(), np.asarray(want_stds))
    base = np.asarray(jops.farthest_point_sample(jnp.asarray(pts), npoint))
    if min_unique == 0:
        assert (idx.numpy() != base).mean() > 0.2
        assert (got_stds.numpy() <= stds[np.arange(B)[:, None], base]).all()
    else:
        np.testing.assert_array_equal(idx.numpy(), base)


@pytest.mark.parametrize('method', ['S-FPS', 'SFS'])
@pytest.mark.parametrize('min_unique', [0, 3500])
def test_sfps_sa_layer_matches_jax(method, min_unique):
    """An SA layer configured with S-FPS builds and samples in both
    packages: the same picks, sampled points and carried stds."""
    pts, stds = _sfps_inputs(8)
    kw = dict(npoint_list=[64], sample_range_list=[-1],
              sample_type_list=[method], radii=[0.8], nsamples=[8],
              mlps=[[8, 16]], num_class=3, ss_radius=1.6, ss_nsample=8,
              sfps_min_unique=min_unique)
    port = SAModuleMSGWithSampling(in_channels=0, **kw)
    new_xyz, feats, _, idx, got_stds = port(_t(pts), stds=_t(stds))
    jax_layer = JaxSAModule(**kw)
    xyz = jnp.asarray(pts)
    variables = jax_layer.init(jax.random.PRNGKey(0), xyz,
                               stds=jnp.asarray(stds), train=False)
    jnew, _, _, jidx, jstds = jax_layer.apply(variables, xyz,
                                              stds=jnp.asarray(stds),
                                              train=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(new_xyz.detach().numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(got_stds.numpy(), np.asarray(jstds))
    assert feats.shape == (B, 64, 16)


def test_sfps_layer_needs_stds():
    port = SAModuleMSGWithSampling(
        in_channels=0, npoint_list=[16], sample_range_list=[-1],
        sample_type_list=['S-FPS'], radii=[0.8], nsamples=[4],
        mlps=[[8]], num_class=3, ss_radius=0.5, ss_nsample=4)
    with pytest.raises(ValueError, match='S-FPS sampler needs stds'):
        port(_t(_sfps_inputs(9)[0]))


# ----------------------------------------------------- (g) the Trainer


def _spsnet_trainer_cfg():
    model = tiny_spsnet_cfg()
    model.STABILITY_HOOK = {'CKPT': None, 'DELETE_NUMBER': DELETE,
                            'DELETE_METHOD': 'random',
                            'MODEL': tiny_stability_model_cfg()}
    return EDict({'MODEL': model,
                  'OPTIMIZATION': dict(OPTIM, NUM_EPOCHS=2)})


class _Scenes:
    """One batch of synthetic scenes an epoch; sends SIGUSR1 to this
    process while handing out the batch of epoch ``signal_epoch``."""

    def __init__(self, signal_epoch=None):
        self.epoch, self.signal_epoch = 0, signal_epoch

    def __iter__(self):
        pts, gt = synthetic_scene_batch(200 + self.epoch, B, N)
        if self.epoch == self.signal_epoch:
            os.kill(os.getpid(), signal.SIGUSR1)
        self.epoch += 1
        yield {'points': pts, 'gt_boxes': gt, 'frame_id': ['a', 'b']}


def _spsnet_trainer(tmp_path):
    cfg = _spsnet_trainer_cfg()
    model = build_detector(cfg.MODEL, 3, device='cpu',
                           generator=torch.Generator().manual_seed(1))
    return Trainer(cfg, model, tmp_path, total_iters_each_epoch=1)


def test_spsnet_trainer_resumes_the_same_noise_stream(tmp_path, monkeypatch):
    """SPSNet.yaml's topology trains through the ``Trainer`` with the hook
    built from ``MODEL.STABILITY_HOOK``. Two epochs straight through, and
    one epoch, a stop, a resume and the second epoch: the same noise at
    each step count and the same final weights."""
    noises = []
    hook = port_trainer.apply_stability_hook

    def recording(generator, batch, noise=None, **kw):
        noises.append(noise)
        return hook(generator, batch, noise, **kw)
    monkeypatch.setattr(port_trainer, 'apply_stability_hook', recording)

    straight = _spsnet_trainer(tmp_path / 'a')
    assert straight.preprocess is not None
    assert straight.train(_Scenes()) == 2
    through = list(noises)

    noises.clear()
    first = _spsnet_trainer(tmp_path / 'b')
    assert first.train(_Scenes(signal_epoch=1)) == 1
    assert first.ckpt.all_steps() == [1]
    again = _spsnet_trainer(tmp_path / 'b')
    assert again.maybe_resume() == 1 and again.optimizer.count == 1
    scenes = _Scenes()
    scenes.epoch = 1
    assert again.train(scenes, start_epoch=1) == 2
    assert len(through) == 2 and len(noises) == 3
    assert torch.equal(noises[0], through[0])
    assert torch.equal(noises[1], through[1])
    assert torch.equal(noises[2], through[1])
    assert not torch.equal(through[0], through[1])
    for (name, a), b in zip(straight.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(a, b), name


# ------------------------------------------------------- the converter


def test_stability_checkpoint_converts_to_the_port(tmp_path):
    """A JAX ``CheckpointManager`` checkpoint of the stability model, as
    ``tools/train_stability.py`` writes it, converts to a state dict that
    ``make_stability_preprocess`` loads: the port's stds from it are the
    JAX package's within STDS_RTOL, from the manager root and from a step
    directory."""
    pts = jax_scenes(12, B, N)[0]
    model = _jax_generator()
    variables = _jax_vars(model, {'params': jax.random.PRNGKey(3),
                                  'latent': jax.random.PRNGKey(4)},
                          {'points': jnp.asarray(pts)}, train=True)
    tx = optax.adam(1e-3)
    state = TrainState(params=variables['params'],
                       batch_stats=variables['batch_stats'],
                       opt_state=tx.init(variables['params']),
                       step=np.int32(3))
    JaxCheckpoints(tmp_path / 'ckpt').save(3, jax.device_get(state))
    want = np.asarray(model.apply(variables, {'points': jnp.asarray(pts)},
                                  train=False)['stds'])
    for src in (tmp_path / 'ckpt', tmp_path / 'ckpt' / '3'):
        out = convert(src, tmp_path / 'torch' / 'generator.pt')
        pre = make_stability_preprocess(
            EDict({'CKPT': str(out), 'DELETE_NUMBER': DELETE,
                   'MODEL': tiny_stability_model_cfg()}), 'cpu')
        with torch.no_grad():
            got = pre.model({'points': _t(pts)})['stds'].numpy()
        np.testing.assert_allclose(got, want, rtol=STDS_RTOL)
