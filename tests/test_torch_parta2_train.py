"""The tiny PartA2 (``zoo.tiny_parta2_cfg``, the JAX package's
``tests/test_parta2.py`` config; PartA2_free's cases, through the helpers
here, in ``tests/test_torch_parta2_free_train.py``) against the JAX
package on the CPU: each model's eval forward
and ``post_processing`` on two frames of 48 voxels padded to 64 rows (the
JAX package's plan with its up tables, as ``tests/test_parta2.py``'s
``make_parta2_batch`` builds it),
and one ``adam_onecycle`` step through each package's
``make_train_step`` with the JAX package's RoI draws (gt boxes near the
proposals), from the same numpy-filled flax variables through the weight
bridge. Indices, labels and counts must be identical, floats within the
tolerances of ``tests/test_torch_pvrcnn_train.py`` (``hold_train_step``).

PartA2_free's proposals are the part head's boxes of every voxel row, the
padded rows among them (JAX feeds them to its proposal NMS too): a padded
row reads only the plan's zero row, so all of a frame's padded rows carry
one box and one score. JAX's BEV IoU of two identical boxes is degenerate
(``tests/test_torch_centerpoint.py``'s ``hold_detections``), so its NMS may
keep such a box twice where the port keeps it once; ``hold_proposals``
drops JAX's repeats before comparing and counts them.
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
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.detectors.part_a2 import PartA2FreeNet, PartA2Net
from spsnet_torch.models.roi_heads import pointrcnn_head
from spsnet_torch.runtime.trainer import step_rngs
from spsnet_torch.utils.weights import load_flax
from spsnet_tpu.data.processor.sparse_plan import build_sparse_plan
from tests.test_parta2 import make_parta2_batch
from tests.test_pvrcnn import GRID_ZYX, PCR, VS
from tests.test_torch_multihead_train import RPN_KEYS, hold_train_step
from tests.test_torch_pointrcnn_train import _first_step_slack, _jax_draws
from tests.test_torch_pvrcnn import _close
from tests.test_torch_pvrcnn_train import (GRAD_RTOL, STEP_ATOL,
                                           _gt_near_proposals,
                                           _head_key, _one_step, _t,
                                           _variables)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

# the two tiny models: PartA2's cases here, PartA2_free's in
# tests/test_torch_parta2_free_train.py (one file each, so that
# --dist loadfile runs them on two workers)
WHICH = ['parta2', 'parta2_free']
PART_KEYS = {'loss', 'point_seg_loss', 'point_part_loss', 'rcnn_loss_cls',
             'rcnn_loss_reg', 'rcnn_loss_corner', 'rcnn_loss'}
# a gradient where the packages part by more than GRAD_RTOL: within this
# factor of what WEIGHT_JITTER moves the port's own (as chip_smoke.py holds
# the card's step to the CPU's)
WEIGHT_JITTER, JITTER_FACTOR = 1e-6, 5.0
STEP_KEYS = {'parta2': PART_KEYS | RPN_KEYS,
             'parta2_free': PART_KEYS | {'point_box_loss'}}


def padded_batch(seed, V=64, n=48):
    """``make_parta2_batch``'s two frames and gt boxes with ``n`` voxels a
    frame (half of them inside the gt boxes, so that RoIs pool some)
    padded to ``V`` rows, as ``voxel_batch`` pads them (zero voxels, no
    points), and the JAX package's plan with its up tables."""
    rng = np.random.default_rng(seed)
    batch, final = make_parta2_batch(rng, V=V)
    gt = np.array(batch['gt_boxes'])
    frames = []
    for b in range(2):
        inside = np.concatenate([
            box[:3] + rng.uniform(-0.45, 0.45, (n // 4, 3)) * box[3:6]
            for box in gt[b] if box[3] > 0])
        near = np.floor((inside - PCR[:3]) / VS).astype(np.int64)[:, ::-1]
        coords = np.unique(np.concatenate([near, np.stack(
            [rng.integers(0, g, 2 * n) for g in GRID_ZYX], 1)]), axis=0)
        coords = coords[rng.permutation(len(coords))[:n]]
        pad = np.zeros((V, 3), np.int64)
        pad[:n] = coords
        valid = np.arange(V) < n
        plan = build_sparse_plan(pad, valid, GRID_ZYX,
                                 max_voxels_per_level=V, with_up_tables=True)
        plan.pop('final_grid')
        plan.update(voxel_coords=pad, voxel_valid=valid)
        frames.append(plan)
    out = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    out['voxels'] = np.array(batch['voxels']) * \
        out['voxel_valid'][..., None, None]
    out['voxel_num_points'] = np.where(out['voxel_valid'], 5, 0).astype(
        np.int32)
    out['gt_boxes'] = np.array(batch['gt_boxes'])
    return out, tuple(int(v) for v in final)


def _models(which):
    """The batch (numpy), both packages' tiny model with the same
    numpy-filled variables, and the port's config."""
    batch, final = padded_batch(WHICH.index(which))
    if which == 'parta2':
        cfg, num_class = zoo.tiny_parta2_cfg(final), 1
    else:
        cfg, num_class = zoo.tiny_parta2_free_cfg(), 3
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)),
                            num_class=num_class, voxel_size=VS,
                            point_cloud_range=PCR, final_grid_zyx=final)
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    model = load_flax(build_detector(cfg, num_class, device='cpu',
                                     voxel_size=VS, point_cloud_range=PCR,
                                     final_grid_zyx=final), variables)
    return batch, jm, variables, model, cfg


def hold_proposals(rois, jrois):
    """The RoIs of each frame against JAX's: JAX's repeats of a box it
    kept before dropped, the rest within tolerance, in order. Returns how
    many repeats were dropped."""
    repeats = 0
    for got, want in zip(rois.detach().numpy(), np.asarray(jrois)):
        first = [i for i in range(len(want))
                 if not any((want[i] == want[j]).all() for j in range(i))]
        repeats += len(want) - len(first)
        got = got[(got != 0).any(-1)]
        want = want[first]
        want = want[(want != 0).any(-1)]
        _close(_t(got), want, 'RoIs')
    return repeats


def serve_case(which):
    """The eval forward of ``which``: the UNet's features, the proposals (held by
    ``hold_proposals``), the refined boxes and logits on them and
    ``post_processing``'s indices, labels and counts identical, boxes and
    scores within tolerance. The class follows the config: PartA2Net, or
    PartA2FreeNet for the PointRCNN config over UNetV2."""
    batch, jm, variables, model, cfg = _models(which)
    assert isinstance(model, PartA2Net if which == 'parta2'
                      else PartA2FreeNet)
    batch = {k: v for k, v in batch.items() if k != 'gt_boxes'}
    post = StaticConfig(JaxEDict(copy.deepcopy(cfg.POST_PROCESSING)))
    jout, jdets = jax.jit(lambda v, b: (lambda o: (
        o, jax_post_processing(o, post)))(jm.apply(v, b, train=False)))(
            variables, batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    _close(out['point_features'], jout['point_features'], 'point_features')
    repeats = hold_proposals(out['rois'], jout['roi_head_ret']['rois'])
    if repeats == 0:
        for key in ('batch_box_preds', 'batch_cls_preds'):
            _close(out[key], jout[key], key)
        np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                      jout['batch_roi_labels'])
        dets = post_processing(out, cfg.POST_PROCESSING)
        for key in ('indices', 'labels', 'count'):
            np.testing.assert_array_equal(dets[key].numpy(),
                                          np.asarray(jdets[key]),
                                          err_msg=key)
        _close(dets['scores'], jdets['scores'], 'scores')
        assert int(dets['count'].min()) > 0
    if which == 'parta2_free':
        padded = ~batch['voxel_valid']
        with torch.no_grad():
            boxes = model.stage_one({k: _t(v) for k, v in batch.items()})[
                'batch_box_preds'].numpy()
        for b in range(2):
            assert (boxes[b][padded[b]] == boxes[b][padded[b]][0]).all()


def _jittered_grads(model, batch, draws):
    """The port's fp32 gradients of one train forward with every weight
    times (1 + 1e-6 N(0, 1)) (a seeded draw), the same batch and RoI
    draws: how far rounding-sized changes move each gradient (the weight
    jitter of ``chip_smoke.py``'s train-step checks)."""
    own = pointrcnn_head.draw_roi_sampling
    pointrcnn_head.draw_roi_sampling = draws
    gen = torch.Generator().manual_seed(5)
    try:
        jit = copy.deepcopy(model).train()
        with torch.no_grad():
            for p in jit.parameters():
                p.mul_(1 + WEIGHT_JITTER * torch.randn(p.shape,
                                                       generator=gen))
        loss, _ = jit.loss(jit(dict(batch, rngs=step_rngs(0))))
        loss.backward()
    finally:
        pointrcnn_head.draw_roi_sampling = own
    return {n: p.grad for n, p in jit.named_parameters()}


def _float64_grads(model, batch, draws):
    """The port's gradients of one train forward in float64 from the same
    weights, batch and RoI draws."""
    own = pointrcnn_head.draw_roi_sampling
    pointrcnn_head.draw_roi_sampling = draws
    try:
        m64 = copy.deepcopy(model).double().train()
        loss, _ = m64.loss(m64({**{k: v.double() if v.is_floating_point()
                                   else v for k, v in batch.items()},
                                'rngs': step_rngs(0)}))
        loss.backward()
    finally:
        pointrcnn_head.draw_roi_sampling = own
    return {n: p.grad for n, p in m64.named_parameters()}


def make_step(which):
    """``_one_step``'s record of ``which`` with the JAX package's RoI
    draws, and the port's jittered and float64 gradients of the step on
    request ('references')."""
    batch, jm, variables, model, _ = _models(which)
    batch = {k: _t(v) for k, v in batch.items()}
    batch['gt_boxes'] = _gt_near_proposals(model, batch)
    key = _head_key(jm, variables, 0)

    def draws(g, B_, R, M, d):
        return _jax_draws(key, B_, R, M)
    step = _one_step(jm, variables, model, batch, draws)
    step['which'] = which
    step['references'] = lambda: (_jittered_grads(model, batch, draws),
                                  _float64_grads(model, batch, draws))
    return step


def hold_step(parta2_step):
    """One step: the loss terms (the part head's, PartA2_free's box term,
    the RoI head's, PartA2's anchor head's), every gradient (the UNet
    decoder's, the part head's, the RoI convs' and masked BNs'), the
    updated parameters and every BN's running statistics (the masked BNs'
    unbiased variance among them) held by ``hold_train_step``. Where the
    two packages' gradients part by more than GRAD_RTOL of the largest
    entry, the port's is held to its own float64 gradient of the same step
    (relative L2): no farther from it than JAX's fp32 gradient, or within
    JITTER_FACTOR times what a 1e-6 relative weight jitter moves the port's
    gradient. Only the tiny PartA2's RoI head parts so (its BNs see 32
    RoIs, most of their cells empty: the jitter moves shared_fc_layer.1's
    bias gradient by ~1e-2); at cls_layers.0's weight the port lies 3.1e-4
    from float64, JAX 2.8e-3. Those tensors' updates are held within
    STEP_ATOL plus the first-step slack of the two gradients."""
    step = dict(parta2_step)
    departs, refs = {}, None
    for name, g in step['grads'].items():
        w = step['jax_grads'][name]
        scale = float(w.abs().max())
        apart = float((g - w).abs().max())
        if apart <= GRAD_RTOL * scale:
            continue
        refs = refs or step['references']()
        exact = refs[1][name]
        norm = float(exact.norm())
        port, jax_off = (float((x.double() - exact).norm()) / norm
                         for x in (g, w))
        moved = float((refs[0][name] - g).norm()) / norm
        assert port <= max(jax_off, JITTER_FACTOR * moved), (
            name, port, jax_off, moved)
        departs[name] = (port, jax_off, moved)
    opt = step['opt']
    slack = _first_step_slack(step['grads'], step['jax_grads'],
                              opt.lr_fn(0), opt.max_norm)
    for name in departs:
        diff = (step['state'][name] - step['jax_state'][name]).abs()
        assert (diff <= STEP_ATOL + slack[name]).all(), name
    for key in ('grads', 'jax_grads', 'state', 'jax_state'):
        step[key] = {n: v for n, v in step[key].items() if n not in departs}
    hold_train_step(step, STEP_KEYS[step['which']])
    assert all(n.startswith('roi_head.') for n in departs), departs
    names = set(parta2_step['grads'])
    for name in ('backbone_3d.inv_conv2.0.weight',
                 'backbone_3d.conv_up_t1.conv2.0.weight',
                 'point_head.part_reg_layers.3.weight',
                 'roi_head.conv_part.0.0.weight',
                 'roi_head.conv_rpn.1.1.weight'):
        assert name in names, name
    assert 'roi_head.conv_part.1.1.running_var' in parta2_step['state']


def test_tiny_parta2_serves_as_jax():
    """``serve_case``: the tiny PartA2 (PartA2Net)."""
    serve_case('parta2')


@pytest.fixture(scope='module')
def parta2_step():
    return make_step('parta2')


def test_tiny_parta2_train_step_matches_jax(parta2_step):
    """``hold_step``: one step of the tiny PartA2 against JAX's."""
    hold_step(parta2_step)
