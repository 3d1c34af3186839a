"""The port's PartA2 modules against the JAX package on the CPU, one by one:
the UNet's up tables of the host plan, ``UNetV2``, the RoI-aware pool
(both methods, its gradients, tied maxima and empty cells, the chunked
pairs), ``MaskedBatchNorm`` and ``SubMConvBlock``, the intra-part head's
targets and loss (PartA2's and PartA2_free's), ``PartA2FCHead`` in eval
and in training with the JAX package's RoI draws and dropout masks
replayed, and the weight bridge. The whole tiny models serve and train in
``tests/test_torch_parta2_train.py``, the three yamls at full width in
``tests/test_torch_parta2_configs.py``.

Every module runs on seeded numpy inputs with numpy-filled flax variables
(He-normal kernels, BN statistics off their identity) through the weight
bridge. Integer outputs (tables, cells, masks, RoI indices and labels)
must be identical; floats stay within RTOL relative plus ATOL times the
tensor's largest entry (fp32 sums in another order: the CPU BLAS and
oneDNN against XLA:CPU), gradients within GRAD_RTOL of their largest
entry.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.data.processor.sparse_plan import \
    build_sparse_plan as jax_build_sparse_plan
from spsnet_tpu.models.backbones_3d.spconv_unet import UNetV2 as JaxUNetV2
from spsnet_tpu.models.dense_heads import point_intra_part_head as jax_part
from spsnet_tpu.models.roi_heads import parta2_head as jax_parta2
from spsnet_tpu.models.roi_heads.pointrcnn_head import \
    pointrcnn_head_loss as jax_pointrcnn_head_loss
from spsnet_tpu.utils import box_coder as jax_box_coder
from spsnet_torch import zoo
from spsnet_torch.config import EDict
from spsnet_torch.data.processor import uses_up_tables, voxel_batch
from spsnet_torch.data.processor.voxelize import sparse_grid_zyx
from spsnet_torch.models import blocks
from spsnet_torch.models.backbones_3d.spconv_unet import UNetV2
from spsnet_torch.models.dense_heads import point_intra_part_head
from spsnet_torch.models.roi_heads import parta2_head, pointrcnn_head
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch
from tests.test_parta2 import make_parta2_batch
from tests.test_pvrcnn import PCR, VS
from tests.test_torch_pointpillar import _fill
from tests.test_torch_pointrcnn_train import _jax_draws
from tests.test_torch_pvrcnn import _Holder
from tests.test_torch_secondiou import _Replay

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B = 2
# features and predictions: fp32 sums in another order, ~1e-7 relative a
# layer, grown by BatchNorm's 1/std in training
RTOL, ATOL = 1e-4, 1e-4
# the pool's averages: the same sums in the order of the pairs (the max is
# exact and held bit for bit)
POOL_ATOL = 1e-6
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _load(module, name, variables):
    """``module`` as the ``name`` submodule of a detector, loaded from
    flax ``variables`` of that submodule through the bridge (strict)."""
    holder = _Holder(**{name: module})
    sd = flax_to_torch({c: {name: t} for c, t in variables.items()})
    assert set(sd) == set(holder.state_dict())
    holder.load_state_dict(sd)
    return module


def _grads_close(got, want, what):
    for name, g in got.items():
        w = np.asarray(want[name])
        scale = float(np.abs(w).max())
        assert scale > 0, f'{what} {name}: no gradient'
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale,
                                   err_msg=f'{what} {name}')


# ----------------------------------------------------------- host plan

def _data_cfg():
    return EDict({
        'POINT_CLOUD_RANGE': list(PCR),
        'DATA_PROCESSOR': [
            {'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': list(VS),
             'MAX_POINTS_PER_VOXEL': 5,
             'MAX_NUMBER_OF_VOXELS': {'train': 120, 'test': 160}},
            {'NAME': 'build_sparse_conv_plan'}]})


@pytest.mark.parametrize('mode', ['train', 'test'])
def test_up_tables_are_identical_to_the_plan(mode):
    """``voxel_batch(..., up_tables=True)``: each frame's plan, its
    'down{2,3,4}_up_table' among it, bit for bit the JAX package's
    ``build_sparse_plan(..., with_up_tables=True)`` over the frame's voxels
    (the train cap cuts); without ``up_tables`` no up table;
    ``uses_up_tables`` of the three PartA2 yamls and of PV-RCNN's."""
    scans = synthetic_scan_batch(31, B, 800, pc_range=PCR)
    batch = voxel_batch(scans, _data_cfg(), mode=mode, up_tables=True)
    plain = voxel_batch(scans, _data_cfg(), mode=mode)
    assert set(batch) - set(plain) == {'down2_up_table', 'down3_up_table',
                                       'down4_up_table', 'out_up_table'}
    for k, v in plain.items():
        np.testing.assert_array_equal(batch[k], v, err_msg=k)
    grid = sparse_grid_zyx(PCR, VS)
    cap = 120 if mode == 'train' else 160
    for b in range(B):
        assert batch['voxel_valid'][b].sum() <= cap
        want = jax_build_sparse_plan(batch['voxel_coords'][b],
                                     batch['voxel_valid'][b], grid,
                                     max_voxels_per_level=cap,
                                     with_up_tables=True)
        want.pop('final_grid')
        for k, w in want.items():
            np.testing.assert_array_equal(batch[k][b], w, err_msg=k)
        for n in (2, 3, 4):
            up = batch[f'down{n}_up_table'][b]
            assert up.shape == (cap, 27) and (up < cap).any()
    for cfg in (zoo.parta2_kitti_cfg(), zoo.parta2_free_kitti_cfg(),
                zoo.parta2_waymo_cfg()):
        assert uses_up_tables(cfg.MODEL)
    assert not uses_up_tables(zoo.pv_rcnn_kitti_cfg().MODEL)


# ---------------------------------------------------------------- UNetV2

@pytest.fixture(scope='module')
def part_batch():
    """``tests/test_parta2.py``'s two frames (64 voxel rows on
    ``make_pv_batch``'s grid, the plan with its up tables), the voxel
    features their means."""
    batch, final = make_parta2_batch(np.random.default_rng(0))
    batch = {k: np.array(v) for k, v in batch.items()}
    batch['voxel_features'] = batch['voxels'].mean(2)
    return batch, tuple(int(v) for v in final)


@pytest.mark.parametrize('encoded', [True, False])
def test_unetv2_matches_jax(part_batch, encoded):
    """UNetV2 in eval and in training: the four encoder levels, the
    decoder's 'point_features' and, with RETURN_ENCODED_TENSOR, the
    encoded tensor within tolerance; without it no ``conv_out`` in either
    package; the sparse BNs' running statistics after the train forward."""
    batch, _ = part_batch
    cfg = {'NAME': 'UNetV2', 'RETURN_ENCODED_TENSOR': encoded}
    jm = JaxUNetV2(model_cfg=StaticConfig(JaxEDict(cfg)), input_channels=4)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False), batch)
    variables = _fill(shapes, 3)
    assert ('conv_out' in variables['params']) == encoded
    net = _load(UNetV2(4, encoded), 'backbone_3d', variables)
    assert hasattr(net, 'conv_out') == encoded
    tb = {k: _t(v) for k, v in batch.items()}
    for train in (False, True):
        jout, state = jax.jit(lambda v, b: jm.apply(
            v, b, train=train, mutable=['batch_stats']))(variables, batch)
        net.train(train)
        with torch.no_grad():
            out = net(dict(tb))
        for level in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
            _close(out['multi_scale_3d_features'][level],
                   jout['multi_scale_3d_features'][level], level)
        _close(out['point_features'], jout['point_features'],
               'point_features')
        assert out['point_features'].shape == (B, 64, 16)
        assert ('encoded_voxel_features' in out) == encoded
        if encoded:
            _close(out['encoded_voxel_features'],
                   jout['encoded_voxel_features'], 'encoded')
    want = flax_to_torch({'params': {'backbone_3d': variables['params']},
                          'batch_stats': {'backbone_3d': jax.tree_util.
                                          tree_map(np.asarray, state[
                                              'batch_stats'])}})
    sd = _Holder(backbone_3d=net).state_dict()
    for name in ('backbone_3d.conv_up_t2.conv2.1.running_var',
                 'backbone_3d.inv_conv3.1.running_mean',
                 'backbone_3d.conv5.1.running_var'):
        _close(sd[name], want[name].numpy(), name, atol=1e-5)


# ------------------------------------------------------- RoI-aware pool

def _pool_case(seed, ties=True):
    """Voxel centres on a 0.25 m lattice (several share a RoI cell) with
    16 ReLU'd features (ties at 0 and, with ``ties``, every third point
    a repeat of the one before it), 12 RoIs a frame of which one holds no
    centre."""
    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, [40, 40, 12], (B, 600, 3)) * 0.25 -
           [0, 5, 2]).astype(np.float32)
    feats = np.maximum(rng.normal(size=(B, 600, 16)), 0).astype(np.float32)
    if ties:
        pts[:, 1::3] = pts[:, 0::3]
        feats[:, 1::3] = feats[:, 0::3]
    rois = np.zeros((B, 12, 7), np.float32)
    rois[..., 0] = rng.uniform(1, 9, (B, 12))
    rois[..., 1] = rng.uniform(-4, 4, (B, 12))
    rois[..., 2] = rng.uniform(-1.5, 0.5, (B, 12))
    rois[..., 3:6] = rng.uniform([2, 1, 1], [5, 3, 2.5], (B, 12, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (B, 12))
    rois[:, 0, 0] = 40.0
    return pts, feats, rois


@pytest.mark.parametrize('method', ['max', 'avg'])
def test_roiaware_pool_matches_jax(method, monkeypatch):
    """Both methods at G = 6 on ``_pool_case``: the max identical to JAX's
    (ties and empty cells 0 among it), the mean within POOL_ATOL of the
    largest entry; the (voxel, cell) pairs of ``roi_cells`` the same in
    chunks of any size (POOL_PAIRS cut to 700 pairs: one RoI a chunk); the gradient of a weighted sum at
    the features within GRAD_RTOL of JAX's, a tied max splitting its
    gradient evenly (the gradient at a repeated feature equals its
    twin's)."""
    pts, feats, rois = _pool_case(40)
    w = np.random.default_rng(41).normal(size=(B, 12, 216, 16)).astype(
        np.float32)

    def jax_loss(f):
        out = jax_parta2.roiaware_pool(pts, f, rois, 6, method)
        return jnp.sum(out * w), out
    (_, want), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(feats)
    f = _t(feats).requires_grad_()
    got = parta2_head.roiaware_pool(_t(pts), f, _t(rois), 6, method)
    if method == 'max':
        np.testing.assert_array_equal(got.detach().numpy(), want)
    else:
        _close(got, want, 'avg pool', rtol=0, atol=POOL_ATOL)
    assert (got[:, 0] == 0).all() and (got[:, 1:] != 0).any()
    filled = (got.detach() != 0).any(-1)
    assert filled.any() and (~filled[:, 1:]).any()
    (got * _t(w)).sum().backward()
    _grads_close({'features': f.grad}, {'features': jgrad}, method)
    if method == 'max':
        torch.testing.assert_close(f.grad[:, 1::3], f.grad[:, 0::3],
                                   rtol=0, atol=0)
    def pairs():
        row, slot = parta2_head.roi_cells(_t(pts), _t(rois), 6)
        return torch.sort(slot * B * 600 + row).values
    whole = pairs()
    monkeypatch.setattr(parta2_head, 'POOL_PAIRS', 700)
    assert torch.equal(pairs(), whole) and len(whole) > 100


def test_max_pool_splits_a_tie_evenly():
    """Two points of one cell with equal features and a third below them:
    each tied point takes half the cell's gradient, the third none (JAX's
    ``.at[].max`` and torch's ``scatter_reduce('amax')`` alike)."""
    pts = np.float32([[[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [0.15, 0.1, 0.1],
                       [0.9, 0.9, 0.9]]])
    feats = np.float32([[[1.0], [1.0], [0.5], [2.0]]])
    rois = np.float32([[[0.5, 0.5, 0.5, 1.0, 1.0, 1.0, 0.0]]])
    jgrad = jax.grad(lambda f: jnp.sum(jax_parta2.roiaware_pool(
        pts, f, rois, 2, 'max')))(feats)
    f = _t(feats).requires_grad_()
    parta2_head.roiaware_pool(_t(pts), f, _t(rois), 2, 'max').sum(
    ).backward()
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(f.grad.numpy().ravel(), [0.5, 0.5, 0, 1])


# ------------------------------------------------ the RoI grid's blocks

def _grid_case(seed, c_in=8):
    """(N, G, G, G, C) grids of 6 RoIs at G = 4 with about half of their
    cells active, inactive cells zero, and the mask."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(6, 4, 4, 4, 1)) < 0.5).astype(np.float32)
    x = (rng.normal(1.0, 2.0, (6, 4, 4, 4, c_in)) * mask).astype(np.float32)
    return x, mask


def _ncdhw(a):
    return _t(np.asarray(a)).permute(0, 4, 1, 2, 3)


def test_masked_batch_norm_matches_jax():
    """MaskedBatchNorm in training: the output within tolerance, the
    running mean and the unbiased running variance (var * n / (n - 1) over
    the n active cells) as JAX moves them, the gradients at the input,
    scale and bias; in eval the output of the running statistics."""
    x, mask = _grid_case(50)
    jm = jax_parta2.MaskedBatchNorm(use_running_average=False)
    variables = _fill(jax.eval_shape(lambda a, m: jm.init(
        jax.random.PRNGKey(0), a, m), x, mask), 51)

    def jloss(params, a):
        y, state = jm.apply({'params': params,
                             'batch_stats': variables['batch_stats']}, a,
                            mask, mutable=['batch_stats'])
        return jnp.sum(y * jnp.arange(8.0)), (y, state['batch_stats'])
    (_, (want, stats)), (jp, jx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables['params'], x)
    bn = parta2_head.MaskedBatchNorm(8)
    bn.weight.data, bn.bias.data = (_t(variables['params'][k])
                                    for k in ('scale', 'bias'))
    bn.running_mean.data, bn.running_var.data = (
        _t(variables['batch_stats'][k]) for k in ('mean', 'var'))
    xt = _ncdhw(x).requires_grad_()
    y = bn.train()(xt, _ncdhw(mask))
    _close(y.permute(0, 2, 3, 4, 1), want, 'train output')
    (y * torch.arange(8.0)[None, :, None, None, None]).sum().backward()
    _close(bn.running_mean, stats['mean'], 'running_mean', atol=1e-6)
    _close(bn.running_var, stats['var'], 'running_var', atol=1e-6)
    n = float(mask.sum())
    assert not np.allclose(stats['var'], 0.99 * variables['batch_stats'][
        'var'] + 0.01 * np.var(x, axis=(0, 1, 2, 3), where=mask > 0))
    _grads_close({'x': xt.grad.permute(0, 2, 3, 4, 1), 'scale': bn.weight.grad,
                  'bias': bn.bias.grad}, {'x': jx, 'scale': jp['scale'],
                                          'bias': jp['bias']}, 'masked BN')
    assert n > 2
    with torch.no_grad():
        _close(bn.eval()(_ncdhw(x), _ncdhw(mask)).permute(0, 2, 3, 4, 1),
               jax_parta2.MaskedBatchNorm(use_running_average=True).apply(
                   {'params': variables['params'], 'batch_stats': stats},
                   x, mask), 'eval output')


@pytest.mark.parametrize('train', [False, True])
def test_submconv_block_matches_jax(train):
    """SubMConvBlock (the 3 x 3 x 3 'SAME' convolution, the masked BN,
    ReLU, the mask) with its flax kernel (3, 3, 3, C_in, C_out) bridged to
    torch's (C_out, C_in, 3, 3, 3): the output within tolerance and zero
    at every inactive cell."""
    x, mask = _grid_case(52)
    jm = jax_parta2.SubMConvBlock(16)
    variables = _fill(jax.eval_shape(lambda a, m: jm.init(
        jax.random.PRNGKey(0), a, m, train=False), x, mask), 53)
    want, _ = jm.apply(variables, x, mask, train=train,
                       mutable=['batch_stats'])
    block = parta2_head.SubMConvBlock(8, 16)
    holder = _Holder(block=block)
    sd = {k.replace('roi_head.conv_part.0', 'block'): v for k, v in
          flax_to_torch({c: {'roi_head': {'conv_part_0': t}}
                         for c, t in variables.items()}).items()}
    holder.load_state_dict(sd)
    block.train(train)
    with torch.no_grad():
        got = block(_ncdhw(x), _ncdhw(mask)).permute(0, 2, 3, 4, 1)
    _close(got, want, f'SubMConvBlock train={train}')
    assert (got.numpy()[np.broadcast_to(mask, got.shape) == 0] == 0).all()


# -------------------------------------------------------- the part head

def _part_inputs(seed, V=96):
    """Voxel centres around three gt boxes a frame (one a class, some rows
    padded), 16 decoder features a row, the gt."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, 4, 8), np.float32)
    gt[:, :3, 0] = rng.uniform(2, 10, (B, 3))
    gt[:, :3, 1] = rng.uniform(-4, 4, (B, 3))
    gt[:, :3, 2] = -1.0
    gt[:, :3, 3:6] = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    gt[:, :3, 6] = rng.uniform(-np.pi, np.pi, (B, 3))
    gt[:, :3, 7] = [1, 2, 3]
    centers = np.zeros((B, V, 3), np.float32)
    for b in range(B):
        k = rng.integers(0, 3, V)
        centers[b] = gt[b, k, :3] + rng.normal(0, 1, (V, 3)) * \
            gt[b, k, 3:6] * 0.45
    valid = np.ones((B, V), bool)
    valid[1, -10:] = False
    return {'point_features': rng.normal(size=(B, V, 16)).astype(
        np.float32), 'voxel_centers': centers.astype(np.float32),
        'voxel_valid': valid, 'gt_boxes': gt}


def _part_cfg(free):
    if free:
        return zoo.tiny_parta2_free_cfg().POINT_HEAD, 3
    return zoo.tiny_parta2_cfg((2,)).POINT_HEAD, 1


@pytest.mark.parametrize('free', [False, True])
def test_part_head_targets_and_loss_match_jax(free):
    """The part head in training (PartA2's: segmentation and part
    locations; PartA2_free's: three classes and the box branch with the
    ignore band): the foreground and the part targets, the class labels
    and encoded boxes identical or within tolerance, the decoded boxes a
    row and the part features; the loss terms within LOSS_RTOL and their
    gradients at every parameter within GRAD_RTOL."""
    cfg, num_class = _part_cfg(free)
    inputs = {k: jnp.asarray(v) for k, v in _part_inputs(60 + free).items()}
    jm = jax_part.PointIntraPartOffsetHead(
        model_cfg=StaticConfig(JaxEDict(copy.deepcopy(cfg))),
        num_class=num_class)
    variables = _fill(jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=True), inputs), 62)

    def jloss(params):
        out, _ = jm.apply({'params': params,
                           'batch_stats': variables['batch_stats']},
                          inputs, train=True, mutable=['batch_stats'])
        loss, tb = jax_part.point_intra_part_loss(
            out['point_part_ret'], StaticConfig(JaxEDict(copy.deepcopy(
                cfg.LOSS_CONFIG))))
        return loss, (out, tb)
    (jl, (jout, jtb)), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables['params'])
    head = _load(point_intra_part_head.PointIntraPartOffsetHead(
        cfg, num_class), 'point_head', variables).train()
    out = head({k: _t(np.asarray(v)) for k, v in inputs.items()})
    ret, jret = out['point_part_ret'], jout['point_part_ret']
    for key in ('fg_mask', 'valid'):
        np.testing.assert_array_equal(ret[key].numpy(), jret[key], key)
    assert ret['fg_mask'].any() and (~ret['fg_mask']).any()
    assert not ret['fg_mask'][1, -10:].any()
    _close(ret['part_targets'], jret['part_targets'], 'part targets',
           atol=1e-6)
    _close(out['point_part_features'], jout['point_part_features'],
           'point_part_features')
    if free:
        t, jt = ret['box_targets'], jret['box_targets']
        np.testing.assert_array_equal(t.cls_labels.numpy(), jt.cls_labels)
        assert (t.cls_labels == -1).any() and (t.cls_labels > 1).any()
        _close(t.box_labels, jt.box_labels, 'box labels', atol=1e-5)
        _close(out['batch_box_preds'], jout['batch_box_preds'],
               'boxes a row')
        assert out['batch_box_preds'].shape == (B, 96, 7)
    loss, tb = point_intra_part_head.point_intra_part_loss(
        ret, cfg.LOSS_CONFIG)
    assert set(tb) == set(jtb) == {'point_seg_loss', 'point_part_loss'} | (
        {'point_box_loss'} if free else set())
    for k, v in jtb.items():
        np.testing.assert_allclose(float(tb[k].detach()), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    loss.backward()
    want = flax_to_torch({'params': {'point_head': jax.tree_util.tree_map(
        np.asarray, jgrad)}})
    _grads_close({f'point_head.{n}': p.grad for n, p in
                  head.named_parameters()}, want, 'part head')


# -------------------------------------------------------- the RoI head

def _head_cfg():
    """The tiny PartA2 RoI head at DP_RATIO 0.3 (a Dropout between the
    shared blocks and after each tower's first), 48 / 12 proposals after
    the train / test NMS, 16 RoIs a frame."""
    cfg = copy.deepcopy(zoo.tiny_parta2_cfg((2,)).ROI_HEAD)
    cfg.DP_RATIO = 0.3
    cfg.SHARED_FC = [32, 32, 32]
    cfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 48
    cfg.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 12
    return cfg


def _head_batch(seed, train):
    """``_part_inputs``' voxels and features, their part features, and 80
    proposals a frame around the gt (three class logits), the gt near
    eight proposals in training."""
    rng = np.random.default_rng(seed)
    batch = _part_inputs(seed)
    gt = batch.pop('gt_boxes')
    batch['point_part_features'] = rng.uniform(
        0, 1, (B, 96, 4)).astype(np.float32)
    props = np.repeat(gt[:, :3, :7], 27, axis=1)[:, :80].copy()
    props[..., :3] += rng.normal(0, 0.4, (B, 80, 3))
    props[..., 3:6] *= rng.uniform(0.8, 1.25, (B, 80, 3))
    props[..., 6] += rng.normal(0, 0.2, (B, 80))
    batch['batch_box_preds'] = props.astype(np.float32)
    batch['batch_cls_preds'] = rng.normal(size=(B, 80, 3)).astype(
        np.float32)
    if train:
        g = np.zeros((B, 6, 8), np.float32)
        g[:, :3] = gt[:, :3]
        g[:, 3:, :7] = props[:, [5, 30, 60], :7] + rng.normal(
            0, 0.05, (B, 3, 7))
        g[:, 3:, 7] = batch['batch_cls_preds'][:, [5, 30, 60]].argmax(-1) + 1
        batch['gt_boxes'] = g
    return batch


def _head_pair(seed):
    cfg = _head_cfg()
    jm = jax_parta2.PartA2FCHead(
        model_cfg=StaticConfig(JaxEDict(copy.deepcopy(cfg))), num_class=1,
        voxel_size=VS, point_cloud_range=PCR)
    batch = _head_batch(seed, False)
    variables = _fill(jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), batch), seed)
    return jm, variables, _load(parta2_head.PartA2FCHead(cfg, 1),
                                'roi_head', variables)


def test_parta2_head_eval_matches_jax():
    """Eval: the proposals (NMS_CONFIG.TEST), their labels, the pooled
    grids' active masks identical; rcnn_cls, the decoded boxes within
    tolerance; 'has_class_labels' True for three class channels; the
    avg-pooled part features and the max-pooled features each within
    tolerance of JAX's ``roiaware_pool`` on the same RoIs."""
    jm, variables, head = _head_pair(70)
    batch = _head_batch(71, False)
    jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                               batch)
    head.eval()
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        out = head(tb)
        part, rpn = head.pool(tb, out['rois'])
    np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                  jout['batch_roi_labels'])
    _close(out['rois'], jout['roi_head_ret']['rois'], 'rois', atol=1e-6)
    for key in ('batch_cls_preds', 'batch_box_preds'):
        _close(out[key], jout[key], key)
    assert out['has_class_labels'] is True
    assert out['batch_box_preds'].shape == (B, 12, 7)
    centers = np.where(batch['voxel_valid'][..., None],
                       batch['voxel_centers'], 1e6)
    score = batch['point_part_features'][..., -1:]
    feats = np.concatenate([np.where(score < 0.3, 0.0, batch[
        'point_part_features'][..., :3]), score], -1)
    rois = np.asarray(jout['roi_head_ret']['rois'])
    jpart = jax_parta2.roiaware_pool(centers, feats, rois, 4, 'avg')
    jrpn = jax_parta2.roiaware_pool(centers, batch['point_features'], rois,
                                    4, 'max')
    _close(part, jpart, 'pooled part', rtol=0, atol=POOL_ATOL)
    np.testing.assert_array_equal(rpn.numpy(), jrpn)
    np.testing.assert_array_equal((part.sum(-1) != 0).numpy(),
                                  np.asarray(jpart).sum(-1) != 0)
    assert (part.sum(-1) != 0).any() and (part.sum(-1) == 0).any()


def _dropout_masks(jm, variables, batch, rngs):
    """The JAX head's Dropout masks in a train forward, in the port's call
    order (shared_fc's, then cls_layers', then reg_layers'), as kept / not
    kept."""
    _, state = jax.jit(lambda v, b, r: jm.apply(
        v, b, train=True, rngs=r, mutable=['batch_stats', 'intermediates'],
        capture_intermediates=lambda m, _: type(m).__name__ == 'Dropout'))(
            variables, batch, rngs)
    inter = state['intermediates']
    masks = [inter['shared_fc'][f'Dropout_{k}']['__call__'][0]
             for k in range(2)]
    masks += [inter[t]['SharedMLP_0']['Dropout_0']['__call__'][0]
              for t in ('cls_layers', 'reg_layers')]
    return [np.asarray(m) != 0 for m in masks]


def test_parta2_head_train_matches_jax_with_replayed_draws():
    """Training with gt: with the JAX package's RoI draws the sampled RoIs,
    their labels, gt and regression mask identical (foreground among
    them); with its dropout masks rcnn_cls, rcnn_reg and the decoded boxes
    within tolerance; ``pointrcnn_head_loss`` within LOSS_RTOL; its
    gradients at every parameter (the RoI convs' and their masked BNs'
    among them) and at the part and rpn features (the score channel
    detached) within GRAD_RTOL; the masked BNs' running statistics as JAX
    moves them."""
    jm, variables, head = _head_pair(72)
    batch = _head_batch(73, True)
    rngs = {'roi_sampling': jax.random.PRNGKey(5),
            'dropout': jax.random.PRNGKey(6)}
    key = jm.apply(variables, method=lambda m: m.make_rng('roi_sampling'),
                   rngs={'roi_sampling': rngs['roi_sampling']})
    loss_cfg = zoo.tiny_parta2_cfg((2,)).ROI_HEAD.LOSS_CONFIG
    masks = _dropout_masks(jm, variables, batch, rngs)
    assert all(0 < (~m).mean() < 1 for m in masks)

    def jloss(params, part, feats):
        out, state = jm.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            dict(batch, point_part_features=part, point_features=feats),
            train=True, rngs=rngs, mutable=['batch_stats'])
        loss, tb = jax_parta2_loss(out['roi_head_ret'], loss_cfg)
        return loss, (out['roi_head_ret'], tb, state['batch_stats'])
    (jl, (jret, jtb, jstats)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            variables['params'], batch['point_part_features'],
            batch['point_features'])
    head.train()
    tb = {k: _t(v) for k, v in batch.items()}
    for k in ('point_part_features', 'point_features'):
        tb[k].requires_grad_()
    tb['rngs'] = {'roi_sampling': None, 'dropout': torch.Generator()}
    own, own_fwd = pointrcnn_head.draw_roi_sampling, blocks.Dropout.forward
    replay = _Replay(masks)
    pointrcnn_head.draw_roi_sampling = \
        lambda g, B_, R, M, d: _jax_draws(key, B_, R, M)
    blocks.Dropout.forward = lambda m, x, g=None: replay(m, x, g)
    try:
        out = head(tb)
    finally:
        pointrcnn_head.draw_roi_sampling = own
        blocks.Dropout.forward = own_fwd
    assert not replay.masks
    ret = out['roi_head_ret']
    t, jt = ret['targets'], jret['targets']
    for field in ('roi_labels', 'gt_of_rois_src', 'reg_valid_mask'):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(jt, field)),
                                      err_msg=field)
    assert t.reg_valid_mask.any()
    for field in ('rois', 'gt_iou_of_rois', 'rcnn_cls_labels'):
        _close(getattr(t, field), getattr(jt, field), field)
    for k in ('rcnn_cls', 'rcnn_reg', 'batch_box_preds'):
        _close(ret[k], jret[k], k)
    loss, ltb = pointrcnn_head.pointrcnn_head_loss(ret, loss_cfg,
                                                   head.box_coder)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert set(ltb) == set(jtb)
    loss.backward()
    want = {n: g for n, g in flax_to_torch({'params': {
        'roi_head': jax.tree_util.tree_map(np.asarray, jgrads[0])}}).items()
        if not n.endswith('num_batches_tracked')}
    got = {f'roi_head.{n}': p.grad for n, p in head.named_parameters()}
    assert set(got) == set(want)
    got.update(part=tb['point_part_features'].grad,
               feats=tb['point_features'].grad)
    want.update(part=jgrads[1], feats=jgrads[2])
    assert (tb['point_part_features'].grad[..., -1] == 0).all()
    _grads_close(got, want, 'RoI head')
    stats = flax_to_torch({'params': {'roi_head': variables['params']},
                           'batch_stats': {'roi_head': jax.tree_util.
                                           tree_map(np.asarray, jstats)}})
    sd = _Holder(roi_head=head).state_dict()
    n = 0
    for name, w in stats.items():
        if name.endswith(('running_mean', 'running_var')):
            _close(sd[name], w.numpy(), name, atol=1e-5)
            n += name.startswith('roi_head.conv_')
    assert n == 8


def jax_parta2_loss(ret, loss_cfg):
    """JAX's ``pointrcnn_head_loss`` with the head's ResidualCoder."""
    return jax_pointrcnn_head_loss(ret, StaticConfig(JaxEDict(copy.deepcopy(
        loss_cfg))), jax_box_coder.build_box_coder('ResidualCoder'))


# ------------------------------------------------------------ the bridge

def test_flax_to_torch_maps_every_parta2_key(part_batch):
    """Every leaf of the tiny PartA2's and PartA2_free's trees lands on a
    port key (the UNet's decoder, the part head's three MLPHeads, the RoI
    head's 3D kernels (3, 3, 3, C_in, C_out) -> (C_out, C_in, 3, 3, 3) and
    masked BNs, the towers behind their Dropout) and a strict load takes
    it; an unknown RoI-head or decoder layer raises."""
    from spsnet_tpu.models import build_detector as jax_build_detector
    from spsnet_torch.models import build_detector
    from spsnet_torch.utils.weights import load_flax
    batch, final = part_batch
    for cfg, nc in ((zoo.tiny_parta2_cfg(final), 1),
                    (zoo.tiny_parta2_free_cfg(), 3)):
        jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=nc,
                                voxel_size=VS, point_cloud_range=PCR,
                                final_grid_zyx=final)
        variables = _fill(jax.eval_shape(lambda b: jm.init(
            jax.random.PRNGKey(0), b, train=False),
            {k: v for k, v in batch.items() if k != 'gt_boxes'}), 80)
        model = load_flax(build_detector(cfg, nc, device='cpu',
                                         voxel_size=VS,
                                         point_cloud_range=PCR,
                                         final_grid_zyx=final), variables)
        params = variables['params']
        k = params['roi_head']['conv_rpn_1']['conv']['kernel']
        np.testing.assert_array_equal(
            model.roi_head.conv_rpn[1][0].weight.detach().numpy(),
            k.transpose(4, 3, 0, 1, 2))
        np.testing.assert_array_equal(
            model.roi_head.conv_part[0][1].running_var.numpy(),
            variables['batch_stats']['roi_head']['conv_part_0']['bn']['var'])
        np.testing.assert_array_equal(
            model.backbone_3d.inv_conv2[0].weight.detach().numpy(),
            params['backbone_3d']['inv_conv2']['Dense_0']['kernel'].T)
        np.testing.assert_array_equal(
            model.point_head.part_reg_layers[3].weight.detach().numpy(),
            params['point_head']['part_reg_layers']['Dense_0']['kernel'].T)
        np.testing.assert_array_equal(
            model.roi_head.cls_layers[4].weight.detach().numpy(),
            params['roi_head']['cls_layers']['Dense_0']['kernel'].T)
        assert ('conv_out' in params['backbone_3d']) == (nc == 1)
        for top, extra in (('roi_head', 'conv_bev_0'),
                           ('backbone_3d', 'conv_up_x4')):
            bad = copy.deepcopy(variables)
            bad['params'][top][extra] = {'conv': {'kernel': np.ones(
                (3, 3), np.float32)}}
            with pytest.raises(KeyError, match='unmapped'):
                flax_to_torch(bad)
