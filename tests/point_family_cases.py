"""The point-family configurations of the port's tests and the JAX-side
captures they replay.

Each variant changes IA-SSD's sampling chain (both ``SAMPLE_METHOD_LIST``s:
the backbone's and the head's, which IA-SSD.yaml ties by an anchor), its
point counts and its dilated grouping, or turns the shared-gather MSG
grouping on, in a config of either package. The chip run derives the same
full-width configurations (``chip_smoke.family_cfg``).
"""
import contextlib

import jax
import numpy as np
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models import samplers as jax_samplers
from spsnet_tpu.models.detectors.detector3d import \
    class_agnostic_nms_batch as jax_nms_batch
from spsnet_tpu.ops import grouping as jax_grouping
from spsnet_torch import ops, zoo
from spsnet_torch.models import build_detector, samplers
from spsnet_torch.models.detectors.detector3d import class_agnostic_nms_batch
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import load_flax

# test_torch_iassd.py's tolerances: fp32 on both sides, sums in another
# order (XLA:CPU against the CPU BLAS), ~1e-7 relative per layer
RTOL, ATOL = 1e-4, 1e-4
# IA-SSD.yaml's NPOINT_LIST / FACTOR at full width (``zoo.scale_sa_config``)
FACTOR = 16

# the samplers at every layer of IA-SSD's chain, for each variant
METHODS = {
    'fs': [['D-FPS'], ['FS'], ['F-FPS'], ['ctr_aware'], [], []],
    'rand': [['Rand'], ['D-FPS'], ['ctr_aware'], ['ctr_aware'], [], []],
    'ds': [['ds-FPS'], ['D-FPS'], ['ctr_aware'], ['ctr_aware'], [], []],
    'ry': [['ry-FPS'], ['D-FPS'], ['ctr_aware'], ['ctr_aware'], [], []],
    'msg_shared': None,
}
# FS doubles its layer's picks: layer 2 takes 2 x 512 at full width
FS_NPOINTS = {'tiny': [[128], [32], [32], [16], [-1], [16]],
              'full': [[4096], [512], [512], [256], [-1], [256]]}
FS_DILATED = [True, True, True, False, False, False]
VARIANTS = tuple(METHODS)


def apply_variant(model_cfg, name, size='full'):
    """Set variant ``name`` on an IA-SSD ``model_cfg`` of either package
    (``size``: 'tiny' for ``tiny_iassd_cfg``, 'full' for IA-SSD.yaml);
    returns it and whether the variant groups with ``msg_shared``."""
    methods = METHODS[name]
    if methods is not None:
        sa = model_cfg.BACKBONE_3D.SA_CONFIG
        sa.SAMPLE_METHOD_LIST = [list(m) for m in methods]
        model_cfg.POINT_HEAD.LOSS_CONFIG.SAMPLE_METHOD_LIST = \
            [list(m) for m in methods]
        if name == 'fs':
            sa.NPOINT_LIST = [list(p) for p in FS_NPOINTS[size]]
            sa.DILATED_GROUP = list(FS_DILATED)
    return model_cfg, name == 'msg_shared'


@contextlib.contextmanager
def jax_msg_shared(enabled):
    """The JAX package's process-wide shared-gather switch, restored (and
    the jit caches cleared both ways) however the block ends."""
    if not enabled:
        yield
        return
    jax_grouping.set_msg_shared(True)
    jax.clear_caches()
    try:
        yield
    finally:
        jax_grouping.set_msg_shared(None)
        jax.clear_caches()


@contextlib.contextmanager
def jax_captures():
    """Record, in call order, the JAX package's F-FPS picks and Rand
    permutations of the functions traced inside the block (host callbacks
    of the traced values): {'ffps': [(B, npoint) int32], 'perm': [(n,)]}."""
    own_ffps, own_rand = jax_samplers.sample_ffps, jax_samplers.sample_rand
    got = {'ffps': [], 'perm': []}

    def ffps(xyz, features, npoint):
        idx = own_ffps(xyz, features, npoint)
        jax.debug.callback(lambda i: got['ffps'].append(np.asarray(i)), idx,
                           ordered=True)
        return idx

    def rand(rng, batch_size, n, npoint):
        perm = jax.random.permutation(rng, n)
        jax.debug.callback(lambda p: got['perm'].append(np.asarray(p)), perm,
                           ordered=True)
        return own_rand(rng, batch_size, n, npoint)

    jax_samplers.sample_ffps, jax_samplers.sample_rand = ffps, rand
    try:
        yield got
    finally:
        jax_samplers.sample_ffps, jax_samplers.sample_rand = \
            own_ffps, own_rand


def ffps_slack(feat):
    """How far apart two F-FPS distances of ``[xyz, features]`` rows
    ``feat`` may round between the packages: ``|a|^2 + |b|^2 - 2 a.b`` in
    fp32 with the cross term summed in another order, a few ulps of the
    largest ``|a|^2`` (1e-6 of it, ~10 ulps)."""
    sq = (feat.double() ** 2).sum(-1)
    return 1e-6 * float(sq.max())


@contextlib.contextmanager
def port_replays(captured, slack_of=ffps_slack):
    """Feed the JAX run's captures into the port: each Rand draw takes the
    next JAX permutation, and each F-FPS call runs its own picks, which
    must equal JAX's, or lie, pick by pick, within ``slack_of(feat)`` of
    this run's running maximum at that step (on the port's own matrix);
    then JAX's picks are replayed. Yields a list that counts the replayed
    calls."""
    own_ffps, own_draw = samplers.sample_ffps, samplers.draw_permutation
    ffps_calls, perms, replayed = iter(captured['ffps']), \
        iter(captured['perm']), []

    def ffps(xyz, features, npoint):
        got = own_ffps(xyz, features, npoint)
        want = torch.from_numpy(np.asarray(next(ffps_calls), np.int64))
        if torch.equal(got, want):
            return got
        feat = torch.cat([xyz, features], -1).detach()
        mat = ops.calc_square_dist(feat, feat)
        slack = slack_of(feat)
        dist = torch.full(mat.shape[:2], 1e10)
        rows = torch.arange(mat.shape[0])
        for s in range(1, npoint):
            dist = torch.minimum(dist, mat[rows, want[:, s - 1]])
            gap = dist.amax(1) - dist[rows, want[:, s]]
            assert float(gap.max()) <= slack, (
                f'F-FPS step {s}: JAX\'s pick lies {float(gap.max()):.3e} '
                f'below the port\'s maximum (slack {slack:.3e})')
        replayed.append(int((got != want).sum()))
        return want

    def draw(generator, n):
        perm = np.asarray(next(perms))
        assert perm.shape == (n,)
        return torch.from_numpy(perm.astype(np.int64))

    samplers.sample_ffps, samplers.draw_permutation = ffps, draw
    try:
        yield replayed
    finally:
        samplers.sample_ffps, samplers.draw_permutation = own_ffps, own_draw


def run_both(name, size, seed, n_points):
    """One forward of each package on ``synthetic_scan_batch(seed, 2,
    n_points)`` from the same variables, and their NMS."""
    if size == 'tiny':
        jcfg, cfg = jax_zoo.tiny_iassd_cfg(), zoo.tiny_iassd_cfg()
    else:
        jcfg = jax_zoo.scale_sa_config(jax_zoo.iassd_kitti_cfg().MODEL,
                                       FACTOR)
        cfg = zoo.scale_sa_config(zoo.iassd_kitti_cfg().MODEL, FACTOR)
    apply_variant(jcfg, name, size)
    _, shared = apply_variant(cfg, name, size)
    points = synthetic_scan_batch(seed, 2, n_points)
    rngs = {'sampling': jax.random.PRNGKey(seed + 7)}
    jax_model = jax_build_detector(jcfg, num_class=3)
    with jax_msg_shared(shared):
        variables = jax.jit(lambda key, pts: jax_model.init(
            {'params': key, **rngs}, {'points': pts}, train=False))(
                jax.random.PRNGKey(seed), points)
        with jax_captures() as captured:
            jax_out = jax.jit(lambda v, pts: jax_model.apply(
                v, {'points': pts}, train=False, rngs=rngs))(
                    variables, points)
            jax.effects_barrier()
    model = build_detector(cfg, 3, device='cpu', msg_shared=shared)
    load_flax(model, jax.tree_util.tree_map(np.asarray, dict(variables)))
    with port_replays(captured) as replayed, torch.no_grad():
        out = model({'points': torch.from_numpy(points)},
                    sampling_generator=torch.Generator().manual_seed(0))
    post = cfg.POST_PROCESSING
    kw = dict(score_thresh=float(post.SCORE_THRESH),
              nms_thresh=float(post.NMS_CONFIG.NMS_THRESH),
              nms_pre=int(post.NMS_CONFIG.NMS_PRE_MAXSIZE),
              nms_post=int(post.NMS_CONFIG.NMS_POST_MAXSIZE))
    return {'cfg': cfg, 'jax': jax_out, 'out': out, 'captured': captured,
            'replayed': replayed, 'model': model,
            'jax_dets': jax_nms_batch(jax_out['batch_box_preds'],
                                      jax_out['batch_cls_preds'], **kw),
            'dets': class_agnostic_nms_batch(out['batch_box_preds'],
                                             out['batch_cls_preds'], **kw)}


def check_sampled_points(run):
    """Every SA layer's sampled points (gathered by equal indices, so bit
    for bit); F-FPS ran where the variant has it, and Rand took JAX's
    permutation."""
    cfg, jax_out, out = run['cfg'], run['jax'], run['out']
    sa = cfg.BACKBONE_3D.SA_CONFIG
    for k, methods in enumerate(sa.SAMPLE_METHOD_LIST):
        if methods:
            np.testing.assert_array_equal(
                out['encoder_xyz'][k + 1].numpy(),
                np.asarray(jax_out['encoder_xyz'][k + 1]),
                err_msg=f'layer {k} ({methods}) sampled points')
    flat = [m for layer in sa.SAMPLE_METHOD_LIST for m in layer]
    assert len(run['captured']['ffps']) == \
        sum(m in ('F-FPS', 'FS') for m in flat)
    assert len(run['captured']['perm']) == flat.count('Rand')
    print('F-FPS calls replayed (differing picks each):', run['replayed'])


def check_features_and_predictions(run):
    jax_out, out = run['jax'], run['out']
    for key in ('centers', 'centers_origin', 'ctr_offsets',
                'centers_features', 'batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jax_out[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for k, (a, b) in enumerate(zip(out['encoder_features'],
                                   jax_out['encoder_features'])):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL, err_msg=f'features {k}')


def check_nms(run):
    dets, jax_dets = run['dets'], run['jax_dets']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(),
                                      np.asarray(jax_dets[key]), err_msg=key)
    np.testing.assert_allclose(dets['boxes'].numpy(),
                               np.asarray(jax_dets['boxes']), rtol=RTOL,
                               atol=ATOL)
