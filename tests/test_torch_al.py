"""The port's AL_3D stack (AL and MLT-SSD) against the JAX package on the
CPU, module by module and the tiny model's serving.

The projections first: BEV and range (u, v) and their masks on points
inside, outside and on the edges of the range and the field of view, the
scatter-max onto the zero grid with its dump cell and its ties (duplicate
points, the grid's own 0), the bilinear gather with its zero pad, each
with its gradients. Then flax's 3 x 3 'SAME' ConvTranspose at strides
(2, 2) and (1, 2) against ``SameConvTranspose2d`` through the bridge's
flip, the CP-UNet in both views, the attentions' max pools at ties,
``Space2Depth``'s channel order, the fusion block, ``AL3D`` and
``RBFusion``, eval and train, then the tiny ALNet (``zoo.tiny_al_cfg``,
``tests/test_alnet.py``'s) through its head's class-specific NMS
(``head_detections``), the bridge's key map both ways, the semantic loss
(``cpgnet_criterion``, ``lovasz_softmax`` with tied errors) and the U_Net
and CP_Unet registry slots. The tiny model's train step and the semantic
losses in a step: ``tests/test_torch_al_train.py``; the yamls at full
width: ``tests/test_torch_al_configs.py``.

Tolerances: floats within RTOL relative plus ATOL of each tensor's
largest entry (fp32 sums in another order, grown by BatchNorm's 1 / std
in training); gradients within GRAD_RTOL of their largest entry.

The range projection takes ``arcsin`` and ``arctan2``, which XLA:CPU,
torch's CPU and CUDA round differently, and jitted JAX divides by a
constant as a product with its reciprocal: a coordinate may differ by a
few ulps, and a point a few ulps from a cell edge may fall in either
cell. ``hold_coords`` holds the port's (u, v) within COORD_ULPS ulps of
the grid's side of JAX's, their cells identical except where the
coordinate lies within that slack of an integer, and the masks identical
except where the elevation lies within FOV_SLACK of the field of view's
edge; the model tests then replay the port's coordinates into JAX's
projections (``jax_coords_of``), so that both packages read the same
cells.
"""
import contextlib
import copy

import flax.linen as fnn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.backbones_2d import al_2d as jax_al_2d
from spsnet_tpu.models.backbones_2d import build_backbone_2d as jax_build_2d
from spsnet_tpu.models.backbones_2d import projection as jax_proj
from spsnet_tpu.models.backbones_2d.base_bev_backbone import \
    RBFusion as JaxRBFusion
from spsnet_tpu.models.backbones_3d.al_3d import AL3D as JaxAL3D
from spsnet_tpu.utils import loss_utils as jax_loss
from spsnet_torch import zoo
from spsnet_torch.config import EDict
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector
from spsnet_torch.models.backbones_2d import (BACKBONES_2D, al_2d,
                                              build_backbone_2d, projection)
from spsnet_torch.models.backbones_2d.base_bev_backbone import RBFusion
from spsnet_torch.models.backbones_3d.al_3d import AL3D
from spsnet_torch.models.detectors import detector_class
from spsnet_torch.models.detectors.al_net import ALNet
from spsnet_torch.models.detectors.detector3d import head_detections
from spsnet_torch.utils import loss_utils
from spsnet_torch.utils.weights import (flax_to_torch, load_flax,
                                        same_name_flax_to_torch)
from tests.test_torch_centerpoint import _cp_variables, hold_detections
from tests.test_torch_pointpillar import _close, _fill, _nhwc, _t
from tests.test_torch_pvrcnn import _Holder

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

# tests/test_alnet.py's geometry: 0.8 m pillars over a 25.6 m square, a
# 32 x 32 map, an 8 x 64 range image
PCR = (0, -12.8, -3, 25.6, 12.8, 1)
VS = (0.8, 0.8, 4)
CLASSES = ['Car', 'Pedestrian', 'Cyclist']
B, N = 2, 512
RTOL, ATOL = 1e-4, 1e-4
GRAD_RTOL = 1e-3
# the projections: coordinates within 16 fp32 ulps of the grid's side,
# elevations within 1e-6 rad of the field of view's edges
COORD_ULPS = 16
FOV_SLACK = 1e-6


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------------------ projections

def _theta(points):
    """Each point's elevation in float64."""
    p = np.asarray(points, np.float64)
    r = np.sqrt((p[..., :3] ** 2).sum(-1) + 1e-8)
    return np.arcsin(p[..., 2] / r)


def hold_coords(own, want, shape, theta=None, fov=None):
    """The port's (u, v, keep) ``own`` against JAX's ``want`` on a grid of
    ``shape`` (h, w): each coordinate within COORD_ULPS ulps of its side,
    its cell the same but where both lie within that slack of an integer;
    the masks identical, but (with ``theta`` and ``fov``) where the
    elevation lies within FOV_SLACK of an edge. Returns the number of
    cells and masks that differ."""
    differ = 0
    for a, b, side in ((own[0], want[0], shape[1]),
                       (own[1], want[1], shape[0])):
        a, b = _np(a), _np(b)
        slack = COORD_ULPS * np.finfo(np.float32).eps * side
        assert np.abs(a - b).max() <= slack, float(np.abs(a - b).max())
        cell = np.floor(a) != np.floor(b)
        assert (np.abs(a - np.round(a))[cell] <= slack).all()
        differ += int(cell.sum())
    keep, jkeep = _np(own[2]), _np(want[2])
    odd = keep != jkeep
    if odd.any():
        assert theta is not None
        edge = np.minimum(np.abs(theta - fov[0]), np.abs(theta - fov[1]))
        assert (edge[odd] <= FOV_SLACK).all()
    return differ + int(odd.sum())


@contextlib.contextmanager
def jax_coords_of(al3d, batch):
    """JAX's ``bev_coords`` and ``range_coords`` replaced by the port's
    coordinates of ``batch``'s points (``AL3D.coords``), after
    ``hold_coords`` holds them to JAX's own (jitted). Yields the number
    of cells and masks that differ."""
    points = batch['points']
    with torch.no_grad():
        bev, rng = al3d.coords({k: v for k, v in batch.items()
                                if k in ('points', 'points_valid')})
    pts = _np(points)
    jbev = jax.jit(lambda p: jax_proj.bev_coords(
        p, al3d.pc_range, al3d.bev_shape))(pts)
    jrng = jax.jit(lambda p: jax_proj.range_coords(
        p, al3d.v_fov, al3d.range_shape))(pts)
    valid = batch.get('points_valid', None)
    if valid is not None:
        v = _np(valid)
        jbev = (*jbev[:2], np.asarray(jbev[2]) & v)
        jrng = (*jrng[:2], np.asarray(jrng[2]) & v)
    differ = hold_coords(bev, jbev, al3d.bev_shape) + hold_coords(
        rng, jrng, al3d.range_shape, _theta(pts), al3d.v_fov)
    fixed = {'bev_coords': tuple(jnp.asarray(_np(t)) for t in bev),
             'range_coords': tuple(jnp.asarray(_np(t)) for t in rng)}
    with pytest.MonkeyPatch.context() as mp:
        for name, value in fixed.items():
            mp.setattr(jax_proj, name, lambda *a, _v=value, **k: _v)
        yield differ


def _edge_points(seed, n=N):
    """Points inside the tiny range, and past its edges: beyond x and y,
    on a cell edge of both maps, above and below the field of view, on
    its edges, duplicates, and the origin."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0.5, 25, (B, n))
    pts[..., 1] = rng.uniform(-12, 12, (B, n))
    pts[..., 2] = rng.uniform(-2, 0.5, (B, n))
    pts[..., 3] = rng.uniform(0, 1, (B, n))
    pts[:, :8, 0] = [26.0, 30.0, -1.0, 0.0, 25.6, 0.8, 1.6, 24.8]
    pts[:, 8:12, 1] = [13.0, -12.8, 12.8, 0.0]
    pts[:, 12:16, :3] = [[5.0, 0.0, 8.0], [5.0, 0.0, -12.0], [5.0, 0.0, 3.0],
                         [5.0, 0.0, -1.0]]
    # elevations on the field of view's edges (-30 and 10 degrees)
    for k, deg in zip(range(16, 20), (-30.0, 10.0, -30.0, 10.0)):
        r = np.hypot(pts[:, k, 0], pts[:, k, 1])
        pts[:, k, 2] = r * np.tan(np.radians(deg))
    pts[:, 20:24] = pts[:, 24:28]
    pts[:, 28] = 0.0
    return pts


@pytest.mark.parametrize('seed', [0, 1])
def test_bev_and_range_coords_hold_the_boundary_rule(seed):
    """``bev_coords`` and ``range_coords`` against JAX's, jitted and eager,
    on ``_edge_points``: within the slack, cells identical but at the
    slack of an edge, the masks identical but at the field of view's edge;
    the points beyond the range or the field of view masked out."""
    pts = _edge_points(seed)
    fov = projection.process_fov([-30.0, 10.0])
    assert fov == jax_proj.process_fov([-30.0, 10.0])
    bev = projection.bev_coords(_t(pts), PCR, (32, 32))
    rng = projection.range_coords(_t(pts), fov, (8, 64))
    for run in (jax.jit, lambda f: f):
        jbev = run(lambda p: jax_proj.bev_coords(p, PCR, (32, 32)))(pts)
        jrng = run(lambda p: jax_proj.range_coords(p, fov, (8, 64)))(pts)
        hold_coords(bev, jbev, (32, 32))
        hold_coords(rng, jrng, (8, 64), _theta(pts), fov)
    keep = _np(bev[2])
    assert not keep[:, [0, 1, 2, 3, 4, 8, 9, 10]].any()
    assert keep[:, [5, 6, 7, 11]].all()
    assert not _np(rng[2])[:, [12, 13, 14]].any()
    assert _np(rng[2])[:, 15].all()
    assert (_np(bev[0]) <= 32 - 0.1).all() and (_np(bev[0]) >= 0).all()


def test_coords_on_a_cell_edge_fall_either_way_within_the_slack():
    """A coordinate an ulp below an integer and one exactly on it: their
    cells differ and ``hold_coords`` takes them; a cell that differs far
    from an edge fails it."""
    u = np.array([[3.0, 5.5]], np.float32)
    below = np.nextafter(u, np.float32(0))
    keep = np.ones_like(u, bool)
    assert hold_coords((u, u, keep), (below, u, keep), (8, 8)) == 1
    with pytest.raises(AssertionError):
        hold_coords((u + 0.5, u, keep), (u, u, keep), (8, 8))


def _proj_inputs(seed, c=3, n=64, h=4, w=6):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, w - 0.1, (B, n)).astype(np.float32)
    v = rng.uniform(0, h - 0.1, (B, n)).astype(np.float32)
    keep = rng.uniform(size=(B, n)) > 0.2
    feats = rng.normal(size=(B, n, c)).astype(np.float32)
    # duplicates in one cell with equal features (a tie), a lone negative
    # feature (loses to the empty cell's 0), a lone 0 (ties with it)
    u[:, :3], v[:, :3], keep[:, :4] = 0.5, 0.5, True
    feats[:, 1] = feats[:, 0]
    feats[:, 0, 0] = feats[:, 1, 0] = feats[:, 2, 0] = 2.0
    u[:, 3], v[:, 3] = w - 0.1, h - 0.1
    feats[:, 3] = [-1.0] + [0.0] * (c - 1)
    return feats, u, v, keep


def test_scatter_max_matches_jax_with_ties_and_the_dump_cell():
    """``p2g_max`` against JAX's: the grid (masked points in the dump
    cell, out of the grid), the gradient at the points, split evenly
    among the tied points and the grid's own 0 as JAX splits it."""
    feats, u, v, keep = _proj_inputs(2)
    w = np.random.default_rng(3).normal(size=(B, 4, 6, 3)).astype(
        np.float32)

    def jloss(f):
        g = jax_proj.p2g_max(f, u, v, keep, (4, 6))
        return jnp.sum(g * w), g
    (_, jgrid), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        feats)
    f = _t(feats).requires_grad_()
    grid = projection.p2g_max(f, _t(u), _t(v), _t(keep), (4, 6))
    (grid * _t(w).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_array_equal(_np(grid), _nhwc(jgrid))
    np.testing.assert_allclose(_np(f.grad), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)
    # three points tie at 2.0 in cell (0, 0), channel 0: a third each
    cell = w[:, 0, 0, 0]
    np.testing.assert_allclose(_np(f.grad)[:, :3, 0], np.repeat(
        cell[:, None] / 3, 3, 1), rtol=1e-6)
    assert (_np(f.grad)[:, 3, 0] == 0).all()          # lost to the 0
    np.testing.assert_allclose(_np(f.grad)[:, 3, 1], w[:, 3, 5, 1] / 2,
                               rtol=1e-6)            # tied with the 0
    assert (_np(f.grad)[~keep] == 0).all()


def test_bilinear_gather_matches_jax_at_the_padded_edge():
    """``g2p_bilinear`` against JAX's, points at the top and right edge
    blending with the zero pad, masked points zero; the gradient at the
    grid."""
    _, u, v, keep = _proj_inputs(4)
    grid = np.random.default_rng(5).normal(size=(B, 4, 6, 3)).astype(
        np.float32)
    wts = np.random.default_rng(6).normal(size=(B, u.shape[1], 3)).astype(
        np.float32)

    def jloss(g):
        out = jax_proj.g2p_bilinear(g, u, v, keep)
        return jnp.sum(out * wts), out
    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(grid)
    g = _t(grid).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = projection.g2p_bilinear(g, _t(u), _t(v), _t(keep))
    (out * _t(wts)).sum().backward()
    _close(out, jout, 'gathered features', rtol=1e-6, atol=1e-6)
    _close(g.grad, _nhwc(jgrad), 'grid gradient', rtol=1e-6, atol=1e-6)
    assert (_np(out)[~keep] == 0).all()


# ------------------------------------------------------------- 2D blocks

def _pair(jmod, tmod, args, seed, train=None):
    """``jmod`` initialised from numpy (``_fill``) on ``args`` (and
    ``train`` after them where given), its variables loaded into ``tmod``
    by ``same_name_flax_to_torch``; returns (variables, the jitted JAX
    output, its batch stats after a train forward or None)."""
    call = tuple(args) if train is None else (*args, train)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *call))
    variables = _fill(shapes, seed)
    tmod.load_state_dict(same_name_flax_to_torch(variables), strict=True)
    if train:
        out, state = jax.jit(lambda v: jmod.apply(
            v, *call, mutable=['batch_stats']))(variables)
        return variables, out, state['batch_stats']
    return variables, jax.jit(lambda v: jmod.apply(v, *call))(variables), \
        None


class _JaxConvT(fnn.Module):
    strides: tuple

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(5, (3, 3), strides=self.strides,
                                 padding='SAME', name='transconv')(x)


@pytest.mark.parametrize('strides', [(2, 2), (1, 2), (1, 1)])
def test_same_conv_transpose_matches_flax(strides):
    """flax ``ConvTranspose(3, strides, padding='SAME')`` with a
    non-symmetric kernel against ``SameConvTranspose2d`` (the bridge
    flips the kernel; padding 0 on a stride-2 axis, 1 on a stride-1 axis,
    then the first s H rows and s W columns) on a 5 x 7 map."""
    x = np.random.default_rng(7).normal(size=(2, 5, 7, 4)).astype(
        np.float32)
    jm = _JaxConvT(strides)
    tm = _Holder(transconv=al_2d.SameConvTranspose2d(4, 5, strides))
    variables, want, _ = _pair(jm, tm, (x,), 8)
    kernel = variables['params']['transconv']['kernel']
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    got = tm.transconv(_t(x).permute(0, 3, 1, 2))
    assert got.shape[-2:] == (5 * strides[0], 7 * strides[1])
    _close(got, _nhwc(want), f'ConvTranspose {strides}', rtol=1e-5,
           atol=1e-6)


@pytest.mark.parametrize('range_view', [False, True])
@pytest.mark.parametrize('train', [False, True])
def test_cp_unet_matches_jax(range_view, train):
    """``CPUnet`` (8 channels in, 6 out) against JAX's on a 16 x 16 map, or
    a 4 x 32 range image (width-only pooling): the output and the pyramid
    {'e1', 'e2', 'e3', 'd0'}; in training (batch statistics) the BN
    running statistics after the forward."""
    shape = (2, 4, 32, 8) if range_view else (2, 16, 16, 8)
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    jm = jax_al_2d.CPUnet(8, 6, range_view=range_view)
    tm = al_2d.CPUnet(8, 6, range_view=range_view)
    _, (jout, jdict), jstats = _pair(jm, tm, (x,), 10, train=train)
    tm.train(train)
    out, feats = tm(_t(x).permute(0, 3, 1, 2))
    _close(out, _nhwc(jout), 'out')
    for k in ('e1', 'e2', 'e3', 'd0'):
        _close(feats[k], _nhwc(jdict[k]), k)
    if range_view:
        assert feats['e3'].shape[-2:] == (4, 4)
    if train:
        want = same_name_flax_to_torch({'batch_stats': jstats})
        state = tm.state_dict()
        for name, w in want.items():
            _close(state[name], w, name)


# module: (JAX's, the port's, its train argument, output and gradient
# tolerances: CBAM's two BatchNorms grow the gradients' differences)
ATTENTIONS = {
    'ChannelAttention': (lambda: jax_al_2d.ChannelAttention(16),
                         lambda: al_2d.ChannelAttention(16), None,
                         (1e-5, 1e-6)),
    'SpatialAttention': (jax_al_2d.SpatialAttention, al_2d.SpatialAttention,
                         None, (1e-5, 1e-6)),
    'CBAM': (lambda: jax_al_2d.CBAM(16), lambda: al_2d.CBAM(16), False,
             (1e-4, 1e-5)),
}


@pytest.mark.parametrize('name', sorted(ATTENTIONS))
def test_attention_max_pools_split_ties_as_jax(name):
    """``ChannelAttention``, ``SpatialAttention`` and ``CBAM`` (eval) on a
    ReLU'd map with all-zero rows, columns and channels (the maxima tie):
    the output and the gradient of its squares at the input against
    JAX's, whose ``max`` splits its gradient evenly among ties, as
    ``amax`` does."""
    make_jax, make_port, train, (rtol, atol) = ATTENTIONS[name]
    rng = np.random.default_rng(11)
    x = np.maximum(rng.normal(size=(2, 6, 5, 16)), 0).astype(np.float32)
    x[:, :, :, :4] = 0.0
    x[:, 2] = 0.0
    x[0, :, 1, 4:6] = 1.5
    jm, tm = make_jax(), make_port()
    variables, jout, _ = _pair(jm, tm, (x,), 12, train=train)
    call = (train,) if train is not None else ()
    jgrad = jax.jit(jax.grad(lambda xx: jnp.sum(
        jm.apply(variables, xx, *call) ** 2)))(x)
    tm.eval()
    xt = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = tm(xt)
    (out ** 2).sum().backward()
    _close(out, _nhwc(jout), name, rtol=rtol, atol=atol)
    _close(xt.grad, _nhwc(jgrad), f'{name} input gradient', rtol=rtol,
           atol=atol)


def test_space_to_depth_is_pixel_unshuffle():
    """``Space2Depth`` (2x, then the 1 x 1 compress) against JAX's einops
    order (c s1 s2): the bridge keeps the compress kernel's input
    channels as they are."""
    x = np.random.default_rng(14).normal(size=(2, 8, 6, 3)).astype(
        np.float32)

    class JaxS2D(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jax_al_2d.Space2Depth(5, name='sd')(x, 2, False)
    tm = _Holder(sd=al_2d.Space2Depth(3, 5, 2))
    _, jout, _ = _pair(JaxS2D(), tm, (x,), 15)
    tm.eval()
    _close(tm.sd(_t(x).permute(0, 3, 1, 2)), _nhwc(jout), 'Space2Depth',
           rtol=1e-5, atol=1e-6)


def _range_pyramid(seed, c=64, h=8, w=64):
    rng = np.random.default_rng(seed)
    return {f'e{k}': np.maximum(rng.normal(size=(B, h, w >> k, c >> (
        3 - k))), 0).astype(np.float32) for k in (1, 2, 3)}


@pytest.mark.parametrize('train', [False, True])
def test_fusion_block_matches_jax(train):
    """``FusionBlock`` (64 channels, a 32 x 32 BEV) on a range pyramid of
    an 8 x 64 image and the port's coordinates of ``_edge_points`` (both
    packages read the same cells): the fused BEV features, and in training
    the BN running statistics."""
    pts = _t(_edge_points(16))
    fov = projection.process_fov([-30.0, 10.0])
    bev = projection.bev_coords(pts, PCR, (32, 32))
    rng = projection.range_coords(pts, fov, (8, 64))
    pyr = _range_pyramid(17)
    jm = jax_al_2d.FusionBlock(64, (32, 32))
    tm = al_2d.FusionBlock(64, (32, 32))
    jargs = (pyr, tuple(_np(t) for t in rng), tuple(_np(t) for t in bev))
    _, jout, jstats = _pair(jm, tm, jargs, 18, train=train)
    tm.train(train)
    out = tm({k: _t(v).permute(0, 3, 1, 2) for k, v in pyr.items()}, rng,
             bev)
    assert out.shape == (B, 32, 8, 8)
    _close(out, _nhwc(jout), 'fused BEV features')
    if train:
        state = tm.state_dict()
        for name, w in same_name_flax_to_torch(
                {'batch_stats': jstats}).items():
            _close(state[name], w, name)


def _rb_cfg():
    return {'NAME': 'RB_Fusion', 'BEV_DIM': 12, 'RANGE_DIM': 8}


def test_rb_fusion_matches_jax_with_tied_maxima():
    """``RBFusion`` (eval) against JAX's on a ReLU'd [BEV | range] map
    whose halves hold all-zero channels and pixels: the output and the
    gradients at the map and at every parameter."""
    rng = np.random.default_rng(19)
    x = np.maximum(rng.normal(size=(2, 6, 5, 20)), 0).astype(np.float32)
    x[:, :, :, :3] = 0.0
    x[:, 1, 2] = 0.0
    x[1, :, :, 14:] = 0.0
    jm = JaxRBFusion(StaticConfig(JaxEDict(_rb_cfg())))
    tm = _Holder(backbone_2d=RBFusion(EDict(_rb_cfg())))
    shapes = jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), {'spatial_features': x})
    variables = _fill(shapes, 20)
    sd = flax_to_torch({'params': {'backbone_2d': variables['params']}})
    tm.load_state_dict(sd, strict=True)
    wts = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out = jm.apply({'params': p}, {'spatial_features': xx}, train=False)
        return jnp.sum(out['spatial_features_2d'] * wts), out
    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables['params'], x)
    tm.eval()
    xt = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = tm.backbone_2d({'spatial_features': xt})['spatial_features_2d']
    (out * _t(wts).permute(0, 3, 1, 2)).sum().backward()
    _close(out, _nhwc(jout['spatial_features_2d']), 'RB_Fusion')
    _close(xt.grad, _nhwc(jgx), 'gradient at the map', atol=1e-5)
    want = flax_to_torch({'params': {'backbone_2d': _tree_np(jgp)}})
    for name, p in tm.named_parameters():
        _close(p.grad, want[name], name, rtol=0,
               atol=GRAD_RTOL)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


# ------------------------------------------------------------ the model

def _data_cfg():
    return EDict({'POINT_CLOUD_RANGE': list(PCR), 'DATA_PROCESSOR': [
        {'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': list(VS),
         'MAX_POINTS_PER_VOXEL': 8,
         'MAX_NUMBER_OF_VOXELS': {'train': 256, 'test': 256}}]})


def tiny_batch(seed):
    """``voxel_batch`` of ``_edge_points`` (B = 2, 512 points)."""
    return voxel_batch(_edge_points(seed), _data_cfg())


def tiny_models(cfg, batch, seed=21):
    """The JAX ALNet of ``cfg`` with numpy-filled variables
    (``_cp_variables``: head outputs scaled, heatmap bias -2.19) and the
    port's from the same variables."""
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cfg)), num_class=3,
                            voxel_size=VS, point_cloud_range=PCR,
                            class_names=CLASSES)
    variables = _cp_variables(jm, {k: v for k, v in batch.items()
                                   if k not in ('gt_boxes', 'sem_labels')})
    model = build_detector(cfg, 3, device='cpu', voxel_size=VS,
                           point_cloud_range=PCR, class_names=CLASSES)
    load_flax(model, variables)
    return jm, variables, model


@pytest.fixture(scope='module')
def served():
    """Each package's eval forward of the tiny ALNet on ``tiny_batch(22)``,
    JAX's on the port's coordinates."""
    cfg = zoo.tiny_al_cfg()
    batch = tiny_batch(22)
    jm, variables, model = tiny_models(cfg, batch)
    tb = {k: _t(v) for k, v in batch.items()}
    with jax_coords_of(model.backbone_3d, tb) as differ:
        jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
            variables, batch)
    with torch.no_grad():
        out = model(tb)
    return {'cfg': cfg, 'batch': batch, 'jm': jm, 'variables': variables,
            'model': model, 'out': out, 'jout': jout, 'differ': differ}


def test_al3d_module_matches_jax(served):
    """``AL3D`` alone against JAX's on the tiny model's BEV map (its
    variables from the tiny model's), in eval mode: the semantic logits
    and the detection features (BEV d0 | fusion)."""
    model, out, batch = served['model'], served['out'], served['batch']
    jm = JaxAL3D(StaticConfig(JaxEDict(copy.deepcopy(
        served['cfg'].BACKBONE_3D))))
    v = {c: {'backbone_3d': t['backbone_3d']}
         for c, t in served['variables'].items()}
    m = _Holder(backbone_3d=AL3D(served['cfg'].BACKBONE_3D))
    m.load_state_dict(flax_to_torch(v), strict=True)
    m.eval()
    bev_map = np.random.default_rng(23).normal(
        size=(B, 32, 32, 16)).astype(np.float32)
    tb = {'points': _t(batch['points']),
          'spatial_features': _t(bev_map).permute(0, 3, 1, 2)}
    with jax_coords_of(m.backbone_3d, tb):
        jout = jax.jit(lambda vv, b: jm.apply(
            {c: t['backbone_3d'] for c, t in vv.items()}, b, train=False))(
            v, {'points': batch['points'], 'spatial_features': bev_map})
    with torch.no_grad():
        got = m.backbone_3d(tb)
    _close(got['sem_pred'], jout['sem_pred'], 'sem_pred')
    _close(got['spatial_features'], _nhwc(jout['spatial_features']),
           'detection features')
    assert got['spatial_features'].shape == (B, 4 * 16 + 32, 8, 8)
    assert model.backbone_3d.num_bev_features == 96


def test_tiny_al_serves_as_jax(served):
    """The tiny ALNet: the pillar features, the detection features, the
    semantic logits, RB_Fusion's map, each head group's maps within
    tolerance, and the class-specific NMS's detections
    (``head_detections``, held by ``hold_detections`` a class segment);
    masked points out of both projections; detections in each frame."""
    out, jout, model = served['out'], served['jout'], served['model']
    assert type(model) is ALNet
    _close(out['pillar_features'], jout['pillar_features'], 'pillars')
    _close(out['spatial_features'], _nhwc(jout['spatial_features']),
           'detection features')
    _close(out['sem_pred'], jout['sem_pred'], 'sem_pred')
    assert out['sem_pred'].shape == (B, N, 4)
    _close(out['spatial_features_2d'], _nhwc(jout['spatial_features_2d']),
           'RB_Fusion')
    for g, (pd, jpd) in enumerate(zip(
            out['center_head_iou_ret']['pred_dicts'],
            jout['center_head_iou_ret']['pred_dicts'])):
        for k in pd:
            _close(pd[k], _nhwc(jpd[k]), f'head {g} {k}')
    assert out['final_boxes'].shape == (B, 12, 7)
    hold_detections(out, jout, [4, 8])
    assert int(head_detections(out)['count'].min()) > 0


def test_flax_to_torch_maps_every_al_key(served):
    """Every leaf of the tiny ALNet's flax tree on a port key and every
    port key from a leaf (``load_flax`` is strict); the transposed
    convolutions flipped; a leaf of no module raises."""
    variables, model = served['variables'], served['model']
    sd = flax_to_torch(variables)
    assert set(sd) == set(model.state_dict())
    names = [k for k in sd if 'transconv' in k and k.endswith('weight')]
    assert len(names) == 2 * 3 + 3
    k = variables['params']['backbone_3d']['bev_unet']['dec0']['transconv'][
        'kernel']
    np.testing.assert_array_equal(
        sd['backbone_3d.bev_unet.dec0.transconv.weight'].numpy(),
        np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))
    for bad in (('backbone_3d', 'bogus_unet'), ('backbone_2d', 'channel_fc3')):
        tree = copy.deepcopy(_tree_np(variables))
        tree['params'][bad[0]][bad[1]] = {'kernel': np.zeros((2, 2),
                                                             np.float32)}
        with pytest.raises(KeyError, match='unmapped flax leaf'):
            flax_to_torch(tree)


def test_detector_routing_follows_jax():
    """A PAGNet config with a VFE block, and a CenterPoint over AL_3D,
    are ``ALNet`` in both packages; a PAGNet without one is IASSD."""
    cfg = zoo.tiny_al_cfg()
    assert detector_class(cfg) is ALNet
    cp = copy.deepcopy(cfg)
    cp.NAME = 'CenterPoint'
    assert detector_class(cp) is ALNet
    jm = jax_build_detector(JaxEDict(copy.deepcopy(cp)), num_class=3,
                            voxel_size=VS, point_cloud_range=PCR)
    assert type(jm).__name__ == 'ALNet'
    assert detector_class(zoo.tiny_spsnet_cfg()).__name__ == 'IASSD'


# ------------------------------------------------------- semantic losses

def _sem_case(seed, p=300, c=4, ties=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(p, c)).astype(np.float32)
    target = rng.integers(-1, c, p).astype(np.int32)
    if ties:
        # repeated (logits, label) rows: their errors tie in every class
        logits[40:80] = logits[0]
        target[40:80] = target[0]
        logits[100:120] = logits[1]
        target[100:120] = (target[1] + 1) % c
    return logits, target


SEM_CASES = {
    'dynamic-log': dict(weight='dynamic-log'),
    'dynamic': dict(weight='dynamic'),
    'weights-ignore': dict(weight=[1.0, 2.0, 0.5, 1.5], ignore=[2]),
    'all-classes': dict(weight='dynamic-log', classes='all'),
    'no-lovasz': dict(weight='dynamic-log', with_ls=False),
}


@pytest.mark.parametrize('case', sorted(SEM_CASES))
def test_cpgnet_criterion_matches_jax_at_tied_errors(case):
    """``cpgnet_criterion`` against JAX's on logits with repeated rows
    (tied Lovasz errors), labels -1 masked out: the loss terms within
    1e-5 relative and the gradient at the logits within GRAD_RTOL of its
    largest entry (the stable sort's order at the ties decides each tied
    row's share)."""
    kw = SEM_CASES[case]
    logits, target = _sem_case(24)
    valid = target >= 0

    def jloss(x):
        out = jax_loss.cpgnet_criterion(x, target, valid=valid, **kw)
        return out['loss'], out
    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        logits)
    x = _t(logits).requires_grad_()
    out = loss_utils.cpgnet_criterion(x, _t(target), valid=_t(valid), **kw)
    out['loss'].backward()
    for k in ('loss_wce', 'loss_ls', 'loss'):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _close(x.grad, jgrad, 'logit gradient', rtol=0, atol=GRAD_RTOL)


def test_lovasz_softmax_keeps_the_order_of_tied_errors():
    """``lovasz_softmax``'s gradient at the probabilities where errors tie
    against JAX's (``jnp.argsort(-err)``, stable): equal, and unlike the
    gradient of the tied rows taken in reverse order."""
    probs = np.full((6, 2), 0.5, np.float32)
    probs[4:] = [[0.9, 0.1], [0.2, 0.8]]
    labels = np.array([0, 1, 0, 1, 0, 1], np.int32)
    jgrad = jax.grad(lambda q: jax_loss.lovasz_softmax(q, labels))(probs)
    q = _t(probs).requires_grad_()
    loss_utils.lovasz_softmax(q, _t(labels)).backward()
    np.testing.assert_allclose(_np(q.grad), np.asarray(jgrad), rtol=1e-6)
    rev = _t(probs[[3, 2, 1, 0, 4, 5]]).requires_grad_()
    loss_utils.lovasz_softmax(rev, _t(labels[[3, 2, 1, 0, 4, 5]])).backward()
    assert not np.allclose(_np(rev.grad)[[3, 2, 1, 0]], _np(q.grad)[:4])


def test_lovasz_grad_matches_jax():
    """``lovasz_grad`` on sorted 0 / 1 rows, one entry and none set."""
    for gt in ([1, 0, 1, 1, 0], [0, 0, 0], [1]):
        gt = np.asarray(gt, np.float32)
        np.testing.assert_allclose(_np(loss_utils.lovasz_grad(_t(gt))),
                                   np.asarray(jax_loss.lovasz_grad(gt)),
                                   rtol=1e-6)


# ------------------------------------------------------ registry slots

def test_unet_and_cp_unet_registry_slots_match_jax():
    """The U_Net slot (the five-level [16 .. 256] U-Net) against JAX's on
    a 32 x 32 map of 3 channels, eval and train; the CP_Unet slot builds
    ``CPUnet``; the port's registry holds JAX's names."""
    assert set(BACKBONES_2D) == {'BaseBEVBackbone', 'RB_Fusion', 'RBFusion',
                                 'U_Net', 'CP_Unet'}
    x = np.random.default_rng(25).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    jm = jax_build_2d('U_Net', out_ch=2)
    tm = build_backbone_2d('U_Net', in_ch=3, out_ch=2)
    for train in (False, True):
        _, jout, _ = _pair(jm, tm, (x,), 26, train=train)
        tm.train(train)
        _close(tm(_t(x).permute(0, 3, 1, 2)), _nhwc(jout), f'U_Net {train}')
    assert [getattr(tm, f'enc{i}').conv1.out_channels
            for i in range(1, 6)] == [16, 32, 64, 128, 256]
    assert isinstance(build_backbone_2d('CP_Unet', input_channels=8,
                                        output_channels=8), al_2d.CPUnet)
