"""One ``adam_onecycle`` train step of the port's tiny AL
(``zoo.tiny_al_cfg``) against the JAX package's ``make_train_step`` on the
CPU, and the family's semantic losses.

Both packages start from the same numpy-filled flax variables
(``tests/test_torch_al.py`` builds the models and the batch: two frames
with points past the range and the field of view, three gt boxes a
frame). JAX's projections read the port's coordinates
(``jax_coords_of``, after the boundary rule holds them), and the port's
three Dropout layers (the semantic branch's two, RB_Fusion's) take the
masks that JAX's modules draw from the step's 'dropout' key
(``fold_in(PRNGKey(23), 0)``), read from their outputs
(``capture_intermediates``) and handed to ``blocks.Dropout`` in call
order, as ``tests/test_torch_secondiou.py`` replays its head's. The loss
terms, every gradient, the updated parameters and the BN statistics are
held as ``tests/test_torch_pointpillar_train.py`` holds them, against
JAX's step in float64 (``_one_step(jax_float64=True)``, its masks drawn
in that mode): JAX's fp32 step departs from its own float64 step by up to
9% of a layer's largest gradient (the first head group's center_z conv,
seed 31), where the port's fp32 step lies within 1e-5 of it (ROADMAP
Queue 3). The
semantic branch takes no gradient from the detection loss, in either
package. The SEM_TASK and USE_DET_FOR_SEM losses on given 'sem_labels'
are held on the train forward's outputs (their values and gradients at
the semantic logits). The port's own masks come from the step's
generator (``runtime.trainer.step_rngs``).
"""
import copy
import re

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_torch import zoo
from spsnet_torch.models import blocks, build_detector
from spsnet_torch.runtime.trainer import step_rngs
from tests.test_torch_al import (B, CLASSES, GRAD_RTOL, PCR, RTOL, VS,
                                 _close, _t, jax_coords_of, tiny_batch,
                                 tiny_models)
from tests.test_torch_pointrcnn_train import _first_step_slack
from tests.test_torch_pvrcnn_train import STEP_ATOL, _one_step
from tests.test_torch_secondiou import _Replay

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

SEM_CLS = 4
# the layers that only the semantic logits read: the semantic branch, the
# range U-Net's decoder and the BEV U-Net's after d0 (the fusion reads the
# range encoder, the detection features the BEV d0)
SEMANTIC_ONLY = re.compile(r'backbone_3d\.(cls_|range_unet\.(dec|basic|out)|'
                           r'bev_unet\.(dec[12]|basic[12]|out))')


def _train_batch(seed):
    """``tiny_batch`` with three gt boxes a frame (a car, a pedestrian, a
    cyclist at random places and headings) and per-point semantic labels
    in [-1, SEM_CLS) (-1 ignored)."""
    batch = tiny_batch(seed)
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, 3, 8), np.float32)
    gt[..., 0] = rng.uniform(3, 22, (B, 3))
    gt[..., 1] = rng.uniform(-10, 10, (B, 3))
    gt[..., 2] = -1.0
    gt[..., 3:6] = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, 3))
    gt[..., 7] = [1, 2, 3]
    batch['gt_boxes'] = gt
    batch['sem_labels'] = rng.integers(
        -1, SEM_CLS, batch['points'].shape[:2]).astype(np.int32)
    return batch


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype ==
        np.float32 else np.asarray(a), dict(tree))


def _jax_masks(jm, variables, batch):
    """JAX's train forward with the step's rngs: its output and the keep
    masks of its three Dropouts in call order (an entry the ReLU zeroed
    is 0 either way)."""
    rngs = {'roi_sampling': jax.random.fold_in(jax.random.PRNGKey(17), 0),
            'dropout': jax.random.fold_in(jax.random.PRNGKey(23), 0)}
    out, state = jax.jit(lambda v, b: jm.apply(
        v, b, train=True, rngs=rngs,
        mutable=['batch_stats', 'intermediates'],
        capture_intermediates=lambda m, _: type(m).__name__ == 'Dropout'))(
        variables, batch)
    inter = state['intermediates']
    masks = [inter['backbone_3d']['cls_drop1']['__call__'][0],
             inter['backbone_3d']['cls_drop2']['__call__'][0],
             inter['backbone_2d']['Dropout_0']['__call__'][0]]
    return out, [np.asarray(m) != 0 for m in masks]


@pytest.fixture(scope='module')
def al_step():
    """One step of each package of the tiny AL from the same variables,
    JAX on the port's coordinates, the port on JAX's dropout masks; and
    each package's train forward (for the semantic losses)."""
    cfg = zoo.tiny_al_cfg()
    batch = _train_batch(31)
    jm, variables, model = tiny_models(cfg, batch)
    tb = {k: _t(v) for k, v in batch.items()}
    det = {k: v for k, v in tb.items() if k != 'sem_labels'}
    with jax_coords_of(model.backbone_3d, tb), jax.enable_x64(True):
        jout, masks = _jax_masks(jm, _float64(variables), _float64(batch))
    replay = _Replay(masks * 3)
    with jax_coords_of(model.backbone_3d, tb), pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(blocks.Dropout, 'forward',
                   lambda m, x, g=None: replay(m, x, g))
        step = _one_step(jm, variables, model, det, jax_float64=True)
        fwd = copy.deepcopy(model).train()
        out = fwd(dict(tb, rngs=step_rngs(0)))
    assert not replay.masks
    jout = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == np.float64
        else np.asarray(a), jout)
    step.update(cfg=cfg, jm=jm, variables=variables, model=model,
                batch=batch, out=out, jout=jout, masks=masks)
    return step


def test_dropout_masks_drop_entries(al_step):
    """JAX's masks keep at most about half (the semantic branch, p 0.5)
    and four fifths (RB_Fusion, p 0.2) of the entries (fewer: an entry the
    ReLU zeroed reads as dropped); the port's train forward on them gives
    JAX's semantic logits and fused map."""
    m = al_step['masks']
    assert m[0].shape == (B, 512, 128) and m[1].shape == (B, 512, 64)
    assert m[2].shape == (B, 64)
    for mask, p in zip(m, (0.5, 0.5, 0.2)):
        assert 0.05 < mask.mean() < 1 - p + 0.05
    out, jout = al_step['out'], al_step['jout']
    _close(out['sem_pred'], jout['sem_pred'], 'sem_pred in training')
    _close(out['spatial_features_2d'],
           np.asarray(jout['spatial_features_2d']).transpose(0, 3, 1, 2),
           'RB_Fusion in training')


def test_tiny_al_train_step_matches_jax(al_step):
    """The loss terms (JAX's tb keys) within 1e-4 relative and non-zero;
    every parameter's gradient within GRAD_RTOL of its layer's largest
    entry, zero where only the semantic logits read a layer (the
    detection loss does not reach it: ``SEMANTIC_ONLY``) and non-zero
    elsewhere; parameters after the step within STEP_ATOL
    plus the first step's slack, BN running statistics within STEP_ATOL +
    RTOL, every one moved."""
    step = al_step
    jmet = step['jax_metrics']
    assert {'loss', 'rpn_loss'} <= set(jmet)
    assert any(k.startswith('iou_loss') for k in jmet)
    for tb, loss in ((step['tb'], step['loss']),
                     (step['step_tb'], step['step_loss'])):
        assert set(tb) | {'loss'} == set(jmet)
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
        layer = name.rsplit('.', 1)[0]
        if SEMANTIC_ONLY.match(layer):
            assert layer_scale[layer] == 0 and (g is None or not g.any())
            continue
        scale = layer_scale[layer]
        assert scale > 1e-6, f'{name}: no gradient'
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
    state, jstate, init, opt = step['state'], step['jax_state'], \
        step['init'], step['opt']
    grads = {k: g for k, g in step['grads'].items() if g is not None}
    slack = _first_step_slack(grads, step['jax_grads'], opt.lr_fn(0),
                              opt.max_norm)
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
    assert any('range_unet' in n and n.endswith('running_var')
               for n in state)


@pytest.mark.parametrize('mode', ['SEM_TASK', 'USE_DET_FOR_SEM'])
def test_semantic_losses_match_jax(al_step, mode):
    """With DENSE_HEAD.SEM_TASK (the semantic loss alone) or
    USE_DET_FOR_SEM (the detection loss plus the foreground points'
    semantic loss, scaled by their share) and 'sem_labels' (-1 ignored),
    both packages' ``loss`` on their train forwards: every tb term within
    1e-4 relative, the gradient at the semantic logits within GRAD_RTOL
    of its largest entry."""
    cfg = copy.deepcopy(al_step['cfg'])
    cfg.DENSE_HEAD[mode] = True
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=3,
                            voxel_size=VS, point_cloud_range=PCR,
                            class_names=CLASSES)
    model = build_detector(cfg, 3, device='cpu', voxel_size=VS,
                           point_cloud_range=PCR, class_names=CLASSES)
    model.load_state_dict(al_step['model'].state_dict())
    labels = al_step['batch']['sem_labels']
    jout = dict(al_step['jout'], sem_labels=labels)

    def jloss(sem):
        loss, tb = jm.apply(al_step['variables'], dict(jout, sem_pred=sem),
                            method='loss')
        return loss, tb
    (jl, jtb), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jout['sem_pred'])
    sem = al_step['out']['sem_pred'].detach().requires_grad_()
    loss, tb = model.loss(dict(al_step['out'], sem_pred=sem,
                               sem_labels=_t(labels)))
    loss.backward()
    assert set(tb) == set(jtb) and 'sem_loss' in tb
    assert (set(tb) == {'sem_loss'}) == (mode == 'SEM_TASK')
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for k, v in tb.items():
        np.testing.assert_allclose(float(v.detach()), float(jtb[k]),
                                   rtol=1e-4, err_msg=k)
    _close(sem.grad, jgrad, 'gradient at the semantic logits', rtol=0,
           atol=GRAD_RTOL)
    if mode == 'USE_DET_FOR_SEM':
        assert (sem.grad.numpy()[labels <= 0] == 0).all()


def test_port_dropout_masks_come_from_the_step_generator(al_step):
    """The port's three Dropouts in a train forward draw their masks from
    ``batch['rngs']['dropout']`` in call order (``torch.rand`` of each
    input's shape, kept below 1 - p); an eval forward draws none; a train
    forward without the generator raises."""
    model = copy.deepcopy(al_step['model']).train()
    batch = {k: _t(v) for k, v in al_step['batch'].items()}
    seen = []
    own = blocks.Dropout.forward

    def record(m, x, generator=None):
        y = own(m, x, generator)
        seen.append((m.p, x.detach().clone(), y.detach()))
        return y
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks.Dropout, 'forward', record)
        model(dict(batch, rngs=step_rngs(7)))
        assert len(seen) == 3
        gen = step_rngs(7)['dropout']
        for p, x, y in seen:
            keep = torch.rand(x.shape, generator=gen) < 1 - p
            torch.testing.assert_close(y, torch.where(keep, x / (1 - p), 0.0))
        assert [p for p, _, _ in seen] == [0.5, 0.5, 0.2]
        model.eval()
        with torch.no_grad():
            model(batch)
        assert all(torch.equal(x, y) for _, x, y in seen[3:])
    with pytest.raises(ValueError, match='step generator'):
        model.train()(batch)
