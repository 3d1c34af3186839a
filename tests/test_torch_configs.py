"""The other point configs of ``tools/cfgs`` in the port against the JAX
package on the CPU: IA-SSD_SF (surface features with ctr_aware), PAGNet
(the stability hook's stds and deletion, sss_aware), Waymo IA-SSD (five
point channels) and nuScenes IA-SSD (ten classes).

Each config is built at full width in both packages with its NPOINT_LIST
cut by ``FACTOR`` (``scale_sa_config``), takes two synthetic scenes in its
dataset's point-cloud range with its own channel count, and runs through
the forward and the configured NMS. The flax variables (from fixed keys)
go through the weight bridge; inputs come from numpy seeds. Sampled points,
deletions and NMS indices must be identical; floats within ``RTOL`` /
``ATOL``: both run fp32 with sums in another order (XLA:CPU against the
CPU BLAS), ~1e-7 relative per layer.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models import samplers as jax_samplers
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.stability import hook as jax_hook
from spsnet_tpu.stability.model import GenerateCenter as JaxGenerateCenter
from spsnet_torch import zoo
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.runtime.trainer import StabilityPreprocess
from spsnet_torch.stability.model import GenerateCenter
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import generator_flax_to_torch, load_flax

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, FACTOR = 2, 16
RTOL, ATOL = 1e-4, 1e-4
# largest difference of one top-k sampler score between the packages: a
# sigmoid (times a stability score for sss_aware) a few ulps apart
SCORE_TOL = 5e-7
STDS_RTOL = 1e-5
# config file, point channels, scene points (NPOINT_LIST[0] / FACTOR of
# them taken by layer-0 FPS), data seed
CONFIGS = {
    'iassd_sf': ('tools/cfgs/kitti_models/IA-SSD_SF.yaml', 4, 2048, 11),
    'pagnet': ('tools/cfgs/kitti_models/PAGNet.yaml', 4, 2048, 12),
    'waymo_iassd': ('tools/cfgs/waymo_models/IA-SSD.yaml', 5, 2048, 13),
    'nuscenes_iassd': ('tools/cfgs/nuscenes_models/IA-SSD.yaml', 4, 2048, 14),
}


def _scenes(cfg, channels, n, seed):
    """(B, n, channels) scenes and gt boxes in the config's point-cloud
    range; channels past the fourth (Waymo's elongation) uniform in
    [0, 1)."""
    pc_range = tuple(float(v) for v in cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    pts, gt = synthetic_scene_batch(seed, B, n, pc_range)
    extra = np.random.default_rng(seed).uniform(
        0, 1, (B, n, channels - 4)).astype(np.float32)
    return np.concatenate([pts, extra], axis=-1), gt


def _jax_vars(model, key, *args, **kwargs):
    variables = jax.jit(lambda k, *a: model.init(k, *a, **kwargs))(key, *args)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _run(name):
    path, channels, n, seed = CONFIGS[name]
    jcfg, cfg = jax_zoo.load_yaml_cfg(path), zoo.load_yaml_cfg(path)
    jax_zoo.scale_sa_config(jcfg.MODEL, FACTOR)
    zoo.scale_sa_config(cfg.MODEL, FACTOR)
    num_class = len(cfg.CLASS_NAMES)
    points, gt = _scenes(cfg, channels, n, seed)
    jax_batch = {'points': jnp.asarray(points)}
    batch = {'points': torch.from_numpy(points)}
    res = {'cfg': cfg.MODEL, 'num_class': num_class}
    if 'STABILITY_HOOK' in cfg.MODEL:
        hook_cfg = cfg.MODEL.STABILITY_HOOK
        gen = JaxGenerateCenter(model_cfg=StaticConfig(
            jcfg.MODEL.STABILITY_HOOK.MODEL))
        # train=True creates every variable (eval skips obj_encoder)
        gen_vars = _jax_vars(gen, {'params': jax.random.PRNGKey(1),
                                   'latent': jax.random.PRNGKey(5)},
                             {'points': jax_batch['points']}, train=True)
        kept = jax_hook.apply_stability_hook(
            gen.apply, gen_vars, {'points': jax_batch['points'],
                                  'gt_boxes': jnp.asarray(gt)},
            jax.random.PRNGKey(3),
            delete_number=int(hook_cfg.DELETE_NUMBER))
        jax_batch = {'points': kept['points'], 'stds': kept['stds']}
        tgen = load_flax(GenerateCenter(hook_cfg.MODEL), gen_vars,
                         convert=generator_flax_to_torch).eval()
        with torch.no_grad():
            kept = StabilityPreprocess(
                tgen, int(hook_cfg.DELETE_NUMBER), hook_cfg.DELETE_METHOD)(
                    {'points': batch['points'],
                     'gt_boxes': torch.from_numpy(gt)}, torch.Generator())
        batch = {'points': kept['points'], 'stds': kept['stds']}
    model = jax_build_detector(jcfg.MODEL, num_class=num_class)
    variables = _jax_vars(model, jax.random.PRNGKey(seed), jax_batch,
                          train=False)
    stash = []
    own = jax_samplers.sample_sss_aware

    def sss(cls_features, stds, npoint):
        idx, out = own(cls_features, stds, npoint)
        stash.append((cls_features, stds))
        return idx, out
    jax_samplers.sample_sss_aware = sss
    try:
        def forward(v, b):
            stash.clear()
            out = model.apply(v, b, train=False)
            return out, jax_post_processing(
                out, StaticConfig(jcfg.MODEL.POST_PROCESSING)), list(stash)
        res['jax_out'], res['jax_dets'], res['jax_sss'] = jax.jit(forward)(
            variables, jax_batch)
    finally:
        jax_samplers.sample_sss_aware = own
    tmodel = build_detector(cfg.MODEL, num_class, device='cpu',
                            input_channels=channels)
    load_flax(tmodel, variables)
    with torch.no_grad():
        res['out'] = tmodel(batch)
    res['dets'] = post_processing(res['out'], cfg.MODEL.POST_PROCESSING)
    res['batch'], res['jax_batch'] = batch, jax_batch
    return res


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def config(request):
    return _run(request.param)


def _score_gap(scores, jax_scores, npoint, what):
    """The packages' top-k scores agree within SCORE_TOL; returns a note of
    the smallest gap among the top npoint + 1 (where it is within twice
    their difference, two picks may swap between the packages, and an
    inequality below is such a near-tie, not a fault)."""
    diff = float(np.abs(scores - jax_scores).max())
    assert diff < SCORE_TOL, f'{what}: scores differ by {diff:.2e}'
    top = -np.sort(-jax_scores, axis=-1)[:, :npoint + 1]
    gap = float((top[:, :-1] - top[:, 1:]).min())
    return f'{what}: score difference {diff:.2e}, smallest top-k gap {gap:.2e}'


def test_sampled_points_and_deletion_are_identical(config):
    """The deletion of the stability hook (PAGNet), then every layer's
    sampled points (D-FPS, prefix nesting, ctr_aware and sss_aware top-k)
    are gathered by identical indices, so they are bitwise equal."""
    out, jax_out = config['out'], config['jax_out']
    if 'stds' in config['batch']:
        np.testing.assert_array_equal(
            config['batch']['points'].numpy(),
            np.asarray(config['jax_batch']['points']))
        np.testing.assert_allclose(config['batch']['stds'].numpy(),
                                   np.asarray(config['jax_batch']['stds']),
                                   rtol=STDS_RTOL)
    sa = config['cfg'].BACKBONE_3D.SA_CONFIG
    sss = iter(config['jax_sss'])
    for k, methods in enumerate(sa.SAMPLE_METHOD_LIST):
        npoint, note = sa.NPOINT_LIST[k][0], ''
        if 'ctr_aware' in methods:
            note = _score_gap(
                torch.sigmoid(out['sa_ins_preds'][k - 1].amax(-1)).numpy(),
                np.asarray(jax.nn.sigmoid(
                    jnp.max(jax_out['sa_ins_preds'][k - 1], axis=-1))),
                npoint, f'layer {k} ctr_aware')
        if 'sss_aware' in methods:
            cls, stds = next(sss)
            js = np.asarray(jax.nn.sigmoid(jnp.max(cls, -1))
                            * jax_samplers.stability_score(stds))
            # the port's logits over the JAX package's stds: the stds agree
            # to STDS_RTOL, the logits to a few ulps
            s = (torch.sigmoid(out['sa_ins_preds'][k - 1].amax(-1))
                 * (1.0 - torch.sigmoid(torch.from_numpy(np.array(stds))
                                        / 8.0 - 3.0))).numpy()
            note = _score_gap(s, js, npoint, f'layer {k} sss_aware')
        if methods:
            np.testing.assert_array_equal(
                out['encoder_xyz'][k + 1].numpy(),
                np.asarray(jax_out['encoder_xyz'][k + 1]),
                err_msg=f'layer {k} ({methods}) sampled points; {note}')


def test_predictions_within_tolerance(config):
    out, jax_out = config['out'], config['jax_out']
    for key in ('centers', 'centers_origin', 'ctr_offsets',
                'centers_features', 'batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jax_out[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert out['batch_cls_preds'].shape[-1] == config['num_class']


def test_nms_outputs_match(config):
    dets, jax_dets = config['dets'], config['jax_dets']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(),
                                      np.asarray(jax_dets[key]), err_msg=key)
    np.testing.assert_allclose(dets['boxes'].numpy(),
                               np.asarray(jax_dets['boxes']), rtol=RTOL,
                               atol=ATOL)
