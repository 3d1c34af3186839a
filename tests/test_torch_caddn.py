"""The port's CaDDN modules against the JAX package on the CPU, serving.

On the JAX package's own tiny camera batch (``tests/test_caddn.py``
``make_caddn_batch``, its ``caddn_tiny_cfg``; the port's copy is
``zoo.tiny_caddn_cfg``): ``bin_depths`` in the three modes, continuous and
as targets, on NaN, infinite, out-of-range values and depths at the bin
edges; the frustum grid under calibrations that put voxels before the
first bin and behind the camera (its -2 entries); ``trilinear_sample`` in
and out of range and at the cell centres, with its gradient; the DDN, the
ImageVFE and Conv2DCollapse, each in eval and train mode (BatchNorm
statistics after); the collapse's z-major channels (ROADMAP Queue 3); the
tiny CaDDN's serving through ``post_processing``; the weight bridge. The
flax variables are filled from numpy and reach the port through the
bridge. Training: ``tests/test_torch_caddn_train.py``; CaDDN.yaml at full
width: ``tests/test_torch_caddn_configs.py``.

Tolerances: features, grids and samples within RTOL relative plus ATOL of
the tensor's largest entry (fp32 sums in another order, XLA:CPU against
oneDNN); a continuous depth bin within BIN_SLACK of JAX's. The port
divides by the config's constants as true quotients on every device; JAX
run eagerly does too, and its bins are the port's bit for bit where the
op is the same (UD, LID; SID's log is libm's against XLA's), while jitted
JAX multiplies by the reciprocal: a target bin may then differ by one
where the continuous index lies within BIN_SLACK of an integer.
"""
import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.config import EDict as JaxEDict
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.map_to_bev.conv2d_collapse import \
    Conv2DCollapse as JaxCollapse
from spsnet_tpu.models.vfe import image_vfe as jax_ivfe
from spsnet_torch import zoo
from spsnet_torch.config import EDict
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.models.map_to_bev import Conv2DCollapse
from spsnet_torch.models.map_to_bev.conv2d_collapse import stack_z
from spsnet_torch.models.vfe import image_vfe
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_caddn import PCR, VOXEL, caddn_tiny_cfg, make_caddn_batch
from tests.test_torch_pointpillar import _close, _fill, _nhwc, _t, hold_nms
from tests.test_torch_pvrcnn import _Holder
from tests.test_torch_pvrcnn_train import _np_tree, _variables

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

GRID = (32, 32, 8)
RTOL, ATOL = 1e-4, 1e-4
# a bin index (up to num_bins) within a few fp32 ulps
BIN_SLACK = 1e-4
STEP_ATOL = 1e-5
DISC = {'mode': 'LID', 'num_bins': 16, 'depth_min': 2.0, 'depth_max': 27.6}


def _batch(seed=0):
    return {k: np.asarray(v) for k, v in
            make_caddn_batch(np.random.default_rng(seed)).items()}


def _vox(a):
    """JAX's (B, X, Y, Z, C) voxels in the port's (B, C, X, Y, Z)."""
    return np.asarray(a).transpose(0, 4, 1, 2, 3)


def _bn_stats_match(port, variables, mutated, top):
    """The port's BN running statistics after a train-mode call against
    flax's mutated ones, within STEP_ATOL + RTOL; returns how many."""
    want = flax_to_torch(top({'params': _np_tree(variables['params']),
                              'batch_stats': _np_tree(mutated)}))
    stats = [n for n in want if n.endswith(('running_mean', 'running_var'))]
    for name in stats:
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   want[name].numpy(), rtol=RTOL,
                                   atol=STEP_ATOL, err_msg=name)
    return len(stats)


def test_tiny_caddn_cfg_is_the_jax_tests_config():
    assert zoo.tiny_caddn_cfg() == EDict(copy.deepcopy(caddn_tiny_cfg()))


# ------------------------------------------------------------ depth bins

def _edges(mode, n, lo, hi):
    """float64 depths of the bin edges k = 0..n of ``mode``."""
    k = np.arange(n + 1, dtype=np.float64)
    if mode == 'UD':
        return lo + k * (hi - lo) / n
    if mode == 'LID':
        size = 2 * (hi - lo) / (n * (1 + n))
        return lo + size * ((2 * k + 1) ** 2 - 1) / 8
    return np.exp(np.log(1 + lo) + k / n * (np.log(1 + hi) -
                                             np.log(1 + lo))) - 1


def _depths(mode, n, lo, hi):
    """Random depths around the range, each bin edge in fp32 and an ulp on
    each side of it, NaN, +-inf, the range's ends, zero and values below
    -1 (SID's log of a negative) and below the first bin (LID's square
    root of a negative)."""
    rng = np.random.default_rng(n)
    edge = _edges(mode, n, lo, hi).astype(np.float32)
    return np.concatenate([
        rng.uniform(lo - 4, hi + 6, 300).astype(np.float32), edge,
        np.nextafter(edge, np.float32(np.inf)),
        np.nextafter(edge, np.float32(-np.inf)),
        np.float32([np.nan, np.inf, -np.inf, lo, hi, 0, -1.5, -3, lo - 1])])


@pytest.mark.parametrize('target', [False, True])
@pytest.mark.parametrize('mode', ['UD', 'LID', 'SID'])
def test_bin_depths_match_jax(mode, target):
    """80 bins over 2-46.8 m (CaDDN.yaml's): the continuous index within
    BIN_SLACK of eager JAX's, NaN where JAX's is; as targets (the extra
    class for NaN, infinite and out-of-range depths) equal to eager and
    to jitted JAX's but where the index lies within BIN_SLACK of an
    integer, there at most one apart. The edges are in the data."""
    n, lo, hi = 80, 2.0, 46.8
    d = _depths(mode, n, lo, hi)
    fn = functools.partial(jax_ivfe.bin_depths, mode=mode, depth_min=lo,
                           depth_max=hi, num_bins=n)
    with jax.disable_jit():
        eager = np.asarray(fn(jnp.asarray(d), target=target))
    jitted = np.asarray(jax.jit(functools.partial(fn, target=target))(d))
    cont = image_vfe.bin_depths(_t(d), mode, lo, hi, n).numpy()
    got = image_vfe.bin_depths(_t(d), mode, lo, hi, n, target=target)
    got = got.numpy()
    finite = np.where(np.isfinite(cont), cont, 0.5)
    edge = np.abs(finite - np.round(finite)) <= BIN_SLACK
    assert edge.sum() >= n
    if not target:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(eager))
        ok = np.isfinite(eager)
        np.testing.assert_allclose(got[ok], eager[ok], rtol=0,
                                   atol=BIN_SLACK)
        if mode != 'SID':
            np.testing.assert_array_equal(got, eager)
        return
    assert got.dtype == np.int64 and eager.dtype == np.int32
    assert got.min() >= 0 and got.max() == n
    assert (got[-9:-6] == n).all()                 # NaN, +-inf
    for want, what in ((eager, 'eager'), (jitted, 'jitted')):
        np.testing.assert_array_equal(got[~edge], want[~edge], err_msg=what)
        assert (np.abs(got - want)[edge] <= 1).all(), what
    if mode != 'SID':
        np.testing.assert_array_equal(got, eager)


# ------------------------------------------------------------ frustum grid

def _calibs(which):
    """(B, 4, 4), (B, 3, 4) calibrations: the tiny batch's; the camera 1 m
    ahead (the first voxel slice at 1.4 m, before LID's first bin: NaN);
    4 m ahead (voxels behind the camera and one slice at z = 0, the
    guarded reciprocal's other branch; SID's log of a negative); a camera
    turned 0.1 rad and moved (the near side's voxels before LID's first
    bin)."""
    batch = _batch()
    l2c = batch['trans_lidar_to_cam'].copy()
    c2i = batch['trans_cam_to_img'].copy()
    if which == 'ahead':
        l2c[:, 2, 3] = -1.0
    elif which == 'behind':
        l2c[:, 2, 3] = -4.0
    elif which == 'turned':
        a = np.float32(0.1)
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]], np.float32)
        l2c[:, :3, :3] = rot @ l2c[0, :3, :3]
        l2c[:, :3, 3] = [0.3, -0.2, 0.5]
        c2i[1, 2, 3] = 0.005
    return l2c, c2i


@pytest.mark.parametrize('which', ['tiny', 'ahead', 'behind', 'turned'])
@pytest.mark.parametrize('mode', ['UD', 'LID', 'SID'])
def test_frustum_grid_matches_jax(mode, which):
    """The (B, X, Y, Z, 3) grid: its -2 entries (non-finite) where JAX's
    are, the others within RTOL relative plus ATOL (normalised image and
    bin coordinates)."""
    disc = dict(DISC, mode=mode)
    l2c, c2i = _calibs(which)
    want = np.asarray(jax.jit(functools.partial(
        jax_ivfe.make_frustum_grid, GRID, PCR, disc, 16,
        image_shape=[64, 96]))(l2c, c2i))
    got = image_vfe.FrustumGrid(GRID, PCR, disc, 16, [64, 96])(
        _t(l2c), _t(c2i)).numpy()
    assert got.shape == (2, *GRID, 3)
    np.testing.assert_array_equal(got == -2, want == -2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    expect_bad = (mode, which) in (('LID', 'ahead'), ('LID', 'behind'),
                                   ('LID', 'turned'), ('SID', 'behind'))
    assert (got == -2).any() == expect_bad


def test_voxel_centers_are_jax_numpy_arithmetic():
    """The buffer of centres: JAX's numpy float32 expression
    (``image_vfe.py:169-175``), the span over the grid as the voxel
    size."""
    c = image_vfe.voxel_centers(GRID, PCR)
    pcr = np.asarray(PCR, np.float32)
    vs = (pcr[3:] - pcr[:3]) / np.float32(GRID)
    assert c.dtype == np.float32 and c.shape == (*GRID, 3)
    np.testing.assert_array_equal(c[3, 5, 7], (np.float32([3, 5, 7]) +
                                               np.float32(0.5)) * vs +
                                  pcr[:3])


# --------------------------------------------------------- the sampler

def _coords(case, rng, shape=(2, 4, 5, 6)):
    if case == 'in_range':
        return rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
    if case == 'out_of_range':
        c = rng.uniform(-1.6, 1.6, shape + (3,)).astype(np.float32)
        c[0, 0] = -2.0
        c[1, 1, :, :, 0] = 1 + 1 / 7           # half a cell past the edge
        c[1, 2, :, :, 1] = -1 - 1 / 6
        return c
    size = np.float32([7, 6, 5])                # W, H, D of the volume
    k = rng.integers(0, 5, shape + (3,))
    return ((2 * k + 1) / size - 1).astype(np.float32)


@pytest.mark.parametrize('case', ['in_range', 'out_of_range', 'centres'])
def test_trilinear_sample_matches_jax(case):
    """``F.grid_sample`` (align_corners=False, zeros) against JAX's
    gather form on a (B, C, D, H, W) = (2, 3, 5, 6, 7) volume: the samples
    and the gradient at the volume within RTOL plus ATOL of the largest
    entry; the cell centres give the stored values, -2 gives 0."""
    rng = np.random.default_rng(11)
    vol = rng.normal(size=(2, 3, 5, 6, 7)).astype(np.float32)
    coords = _coords(case, rng)
    cot = rng.normal(size=(2, 4, 5, 6, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_ivfe.trilinear_sample(v, coords),
                        vol.transpose(0, 2, 3, 4, 1))
    v = _t(vol).requires_grad_()
    got = image_vfe.trilinear_sample(v, _t(coords))
    (got * _t(_vox(cot))).sum().backward()
    _close(got, _vox(want), 'samples')
    _close(v.grad, np.asarray(vjp(cot)[0]).transpose(0, 4, 1, 2, 3),
           'volume gradient')
    if case == 'out_of_range':
        assert (got[0, :, 0] == 0).all()
    if case == 'centres':
        k = np.round(((coords + 1) * np.float32([7, 6, 5]) - 1) / 2)
        k = k.astype(np.int64)
        at = vol[np.arange(2)[:, None, None, None], :, k[..., 2], k[..., 1],
                 k[..., 0]]                       # (B, X, Y, Z, C)
        np.testing.assert_allclose(got.detach().numpy(), _vox(at),
                                   atol=1e-6)


# ------------------------------------------------------------ the modules

@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_ddn_matches_jax(mode):
    """The DDN on the tiny batch's 64 x 96 images: the stride-4 features
    and the D + 1 logits within tolerance; in training its seven
    BatchNorms' statistics land on flax's. Its tree is the compact flax
    encoder's (not DeepLabV3-ResNet101's) and ``layer2`` is not dilated
    (ROADMAP Queue 3)."""
    train = mode == 'train'
    images = _batch()['images']
    jm = jax_ivfe.DDN(num_bins=16, feat_channels=16)
    variables = _fill(jax.eval_shape(lambda x: jm.init(
        jax.random.PRNGKey(0), x, train=False), images), 1)
    assert set(variables['params']) == {
        'stem', 'stem_bn', 'layer1a', 'layer1b', 'layer2', 'aspp0',
        'aspp0_bn', 'aspp1', 'aspp1_bn', 'aspp2', 'aspp2_bn', 'classifier'}
    (jfeat, jlogits), mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=train, mutable=['batch_stats']))(variables, images)
    port = _Holder(vfe=_Holder(ddn=image_vfe.DDN(16, 16)))
    load_flax(port, {c: {'vfe': {'ddn': t}} for c, t in variables.items()})
    assert port.vfe.ddn.layer2.Conv_0.dilation == (1, 1)
    port.train(train)
    with torch.no_grad():
        feat, logits = port.vfe.ddn(_t(images))
    assert feat.shape == (2, 16, 16, 24) and logits.shape == (2, 17, 16, 24)
    _close(feat, _nhwc(jfeat), 'features')
    _close(logits, _nhwc(jlogits), 'logits')
    if train:
        assert _bn_stats_match(port, variables, mut['batch_stats'],
                               lambda t: {c: {'vfe': {'ddn': v}}
                                          for c, v in t.items()}) == 20


def _vfe_pair(seed):
    cfg = caddn_tiny_cfg().VFE
    jm = jax_ivfe.ImageVFE(model_cfg=StaticConfig(JaxEDict(
        copy.deepcopy(cfg))), voxel_size=tuple(VOXEL),
        point_cloud_range=tuple(PCR), grid_size=GRID)
    batch = _batch()
    variables = _fill(jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), batch), seed)
    port = _Holder(vfe=image_vfe.ImageVFE(zoo.tiny_caddn_cfg().VFE, GRID,
                                          PCR))
    load_flax(port, {c: {'vfe': t} for c, t in variables.items()})
    return jm, variables, port, batch


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_image_vfe_matches_jax(mode):
    """The ImageVFE on the tiny batch: the (B, C, X, Y, Z) voxels and the
    depth logits within tolerance, voxels in front of the camera non-zero;
    in training the DDN's and the channel reduce's BatchNorm statistics."""
    train = mode == 'train'
    jm, variables, port, batch = _vfe_pair(2)
    jout, mut = jax.jit(lambda v, b: jm.apply(
        v, b, train=train, mutable=['batch_stats']))(variables, batch)
    port.train(train)
    with torch.no_grad():
        out = port.vfe({k: _t(v) for k, v in batch.items()})
    vox = out['voxel_features_3d']
    assert vox.shape == (2, 8, *GRID)
    assert (vox != 0).any()
    _close(vox, _vox(jout['voxel_features_3d']), 'voxels')
    _close(out['image_vfe_ret']['depth_logits'],
           _nhwc(jout['image_vfe_ret']['depth_logits']), 'depth logits')
    if train:
        assert _bn_stats_match(port, variables, mut['batch_stats'],
                               lambda t: {c: {'vfe': v}
                                          for c, v in t.items()}) == 22


def _collapse_cfg():
    return caddn_tiny_cfg().MAP_TO_BEV


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_conv2d_collapse_matches_jax(mode):
    """Conv2DCollapse of random (B, X, Y, Z, C) voxels to the (B, 16, Y,
    X) map within tolerance; in training its BatchNorm statistics."""
    train = mode == 'train'
    rng = np.random.default_rng(3)
    vox = np.maximum(rng.normal(size=(2, *GRID, 8)), 0).astype(np.float32)
    jm = JaxCollapse(model_cfg=StaticConfig(JaxEDict(copy.deepcopy(
        _collapse_cfg()))), grid_size=GRID)
    batch = {'voxel_features_3d': vox}
    variables = _fill(jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), batch), 4)
    jout, mut = jax.jit(lambda v, b: jm.apply(
        v, b, train=train, mutable=['batch_stats']))(variables, batch)
    port = _Holder(map_to_bev_module=Conv2DCollapse(
        zoo.tiny_caddn_cfg().MAP_TO_BEV, GRID, 8))
    load_flax(port, {c: {'map_to_bev_module': t}
                     for c, t in variables.items()})
    port.train(train)
    with torch.no_grad():
        out = port.map_to_bev_module({'voxel_features_3d': _t(_vox(vox))})
    assert out['spatial_features'].shape == (2, 16, 32, 32)
    _close(out['spatial_features'], _nhwc(jout['spatial_features']),
           'BEV map')
    if train:
        assert _bn_stats_match(port, variables, mut['batch_stats'],
                               lambda t: {c: {'map_to_bev_module': v}
                                          for c, v in t.items()}) == 2


def test_collapse_stacks_z_major_as_jax():
    """The collapse's input channels are z-major (channel z * C + c), the
    JAX package's transpose and reshape (``conv2d_collapse.py:20-21``) bit
    for bit; the reference's are c-major (c * Z + z), so a reference
    checkpoint's collapse kernel needs its input channels permuted
    (ROADMAP Queue 3)."""
    B, C, X, Y, Z = 2, 3, 4, 5, 6
    vox = np.random.default_rng(5).normal(size=(B, X, Y, Z, C))
    want = vox.transpose(0, 2, 1, 3, 4).reshape(B, Y, X, Z * C)
    got = stack_z(_t(_vox(vox))).numpy()
    np.testing.assert_array_equal(got, _nhwc(want))
    c, z = 2, 4
    np.testing.assert_array_equal(got[:, z * C + c], vox[..., z, c].transpose(
        0, 2, 1))
    reference = _vox(vox).transpose(0, 1, 4, 3, 2).reshape(B, C * Z, Y, X)
    assert not np.array_equal(got, reference)


# ------------------------------------------------------- the tiny CaDDN

def tiny_caddn():
    """Both packages' tiny CaDDN with the same numpy-filled variables
    (``_variables``: the anchor box layer at 0.05) and their eval outputs
    and detections on the tiny batch (JAX jitted once)."""
    batch = _batch()
    jm = jax_build_detector(JaxEDict(copy.deepcopy(caddn_tiny_cfg())),
                            num_class=1, voxel_size=tuple(VOXEL),
                            point_cloud_range=tuple(PCR))
    variables = _variables(jm, {k: v for k, v in batch.items()
                                if k != 'gt_boxes'})
    model = build_detector(zoo.tiny_caddn_cfg(), 1, device='cpu',
                           voxel_size=VOXEL, point_cloud_range=PCR)
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    post = caddn_tiny_cfg().POST_PROCESSING
    jout, jdets = jax.jit(lambda v, b: (lambda o: (
        o, jax_post_processing(o, StaticConfig(post))))(
            jm.apply(v, b, train=False)))(variables, batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    return {'jm': jm, 'variables': variables, 'model': model, 'post': post,
            'batch': batch, 'jout': jout, 'jdets': jdets, 'out': out}


@pytest.fixture(scope='module')
def tiny():
    return tiny_caddn()


def _without_repeats(out, jdets):
    """JAX's detections with any box equal to one kept before it dropped
    (its sort-free BEV IoU of two identical boxes is degenerate, as
    ``tests/test_torch_centerpoint.py`` ``hold_detections`` says); returns
    them and how many went."""
    boxes = np.asarray(out['batch_box_preds'])
    idx = np.asarray(jdets['indices']).copy()
    labels = np.asarray(jdets['labels']).copy()
    dropped = 0
    for b in range(idx.shape[0]):
        kept = [i for i in idx[b] if i >= 0]
        first = [i for n, i in enumerate(kept) if not any(
            (boxes[b, i] == boxes[b, j]).all() for j in kept[:n])]
        dropped += len(kept) - len(first)
        lab = [labels[b, n] for n, i in enumerate(kept) if i in first]
        idx[b] = -1
        idx[b, :len(first)] = first
        labels[b] = 0
        labels[b, :len(lab)] = lab
    return dict(jdets, indices=idx, labels=labels), dropped


def test_tiny_caddn_serves_as_jax(tiny):
    """The tiny CaDDN's voxels, BEV map, BEV backbone, anchor predictions
    and depth logits within tolerance; ``post_processing``'s kept indices
    and labels JAX's (its repeats of a kept box dropped; pairs within
    NMS_SLACK of the threshold as ``hold_nms`` holds them), detections in
    every frame."""
    out, jout = tiny['out'], tiny['jout']
    _close(out['voxel_features_3d'], _vox(jout['voxel_features_3d']),
           'voxels')
    for key in ('spatial_features', 'spatial_features_2d'):
        _close(out[key], _nhwc(jout[key]), key)
    _close(out['image_vfe_ret']['depth_logits'],
           _nhwc(jout['image_vfe_ret']['depth_logits']), 'depth logits')
    for key in ('batch_box_preds', 'batch_cls_preds'):
        _close(out[key], jout[key], key)
    assert out['batch_box_preds'].shape == (2, 32 * 32 * 2, 7)
    dets = post_processing(out, tiny['post'])
    jdets, dropped = _without_repeats(jout, tiny['jdets'])
    assert dropped == 0
    if hold_nms(out, dets, jdets, tiny['post']) == 0:
        for key in ('indices', 'count', 'labels'):
            np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                          err_msg=key)
        _close(dets['boxes'], tiny['jdets']['boxes'], 'boxes')
    assert int(dets['count'].min()) > 0


def test_flax_to_torch_maps_every_caddn_key(tiny):
    """Every leaf of the tiny CaDDN's tree lands on a port key and every
    port key comes from one: the DDN's by its flax names (a conv kernel
    transposed), the channel reduce's, the collapse's, the BEV backbone's
    and the anchor head's; a DDN leaf of no known kind raises."""
    variables = copy.deepcopy(tiny['variables'])
    sd = flax_to_torch(variables)
    assert set(sd) == set(tiny['model'].state_dict())
    ddn = variables['params']['vfe']['ddn']
    np.testing.assert_array_equal(
        sd['vfe.ddn.layer1a.Conv_1.weight'].numpy(),
        np.asarray(ddn['layer1a']['Conv_1']['kernel']).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd['vfe.ddn.aspp2_bn.running_var'].numpy(),
        variables['batch_stats']['vfe']['ddn']['aspp2_bn']['var'])
    np.testing.assert_array_equal(
        sd['map_to_bev_module.collapse.weight'].numpy()[:, :, 0, 0],
        np.asarray(variables['params']['map_to_bev_module']['collapse'][
            'kernel'])[0, 0].T)
    ddn['layer3'] = {'Conv_0': {'kernel': np.ones((3, 3, 2, 2), np.float32)}}
    with pytest.raises(KeyError, match='unmapped'):
        flax_to_torch(variables)
