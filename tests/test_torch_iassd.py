"""The port's IA-SSD inference slice against the JAX package on the CPU.

The JAX model is initialised from a fixed key; its flax variables go through
``flax_to_torch`` into the port's model; both run the same numpy scans.
Sampled points and NMS outputs must match exactly; floats within
``RTOL``/``ATOL``: both run fp32, with matmuls summed in another order
(XLA:CPU vs the CPU BLAS), ~1e-7 relative per layer over ~20 layers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.detectors.detector3d import \
    class_agnostic_nms_batch as jax_nms_batch
from spsnet_tpu.zoo import iassd_kitti_cfg as jax_iassd_kitti_cfg
from spsnet_tpu.zoo import scale_sa_config as jax_scale_sa_config
from spsnet_tpu.zoo import tiny_iassd_cfg as jax_tiny_iassd_cfg
from spsnet_torch.models import build_detector
from spsnet_torch.models.detectors.detector3d import class_agnostic_nms_batch
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import load_flax
from spsnet_torch.zoo import iassd_kitti_cfg, scale_sa_config, tiny_iassd_cfg

RTOL, ATOL = 1e-4, 1e-4
# largest difference of one ctr_aware score (sigmoid of the max class logit)
# between the packages: fp32 logits summed in another order differ by a few
# ulps, and one ulp at 0.5 is 6e-8
SCORE_TOL = 2.5e-7


def _run_both(jax_model_cfg, model_cfg, post, seed, batch, n_points):
    points = synthetic_scan_batch(seed, batch, n_points)
    jax_model = jax_build_detector(jax_model_cfg, num_class=3)
    # jitted: as the JAX package runs, and a fraction of the eager time
    variables = jax.jit(lambda key, pts: jax_model.init(
        key, {'points': pts}, train=False))(jax.random.PRNGKey(seed), points)
    jax_out = jax.jit(lambda v, pts: jax_model.apply(
        v, {'points': pts}, train=False))(variables, points)
    model = build_detector(model_cfg, 3, device='cpu')
    load_flax(model, jax.tree_util.tree_map(np.asarray, dict(variables)))
    with torch.no_grad():
        out = model({'points': torch.from_numpy(points)})
    kw = dict(score_thresh=float(post.SCORE_THRESH),
              nms_thresh=float(post.NMS_CONFIG.NMS_THRESH),
              nms_pre=int(post.NMS_CONFIG.NMS_PRE_MAXSIZE),
              nms_post=int(post.NMS_CONFIG.NMS_POST_MAXSIZE))
    jax_dets = jax_nms_batch(jax_out['batch_box_preds'],
                             jax_out['batch_cls_preds'], **kw)
    dets = class_agnostic_nms_batch(out['batch_box_preds'],
                                    out['batch_cls_preds'], **kw)
    return model_cfg, jax_out, out, jax_dets, dets


@pytest.fixture(scope='module')
def tiny():
    cfg = tiny_iassd_cfg()
    return _run_both(jax_tiny_iassd_cfg(), cfg, cfg.POST_PROCESSING,
                     seed=0, batch=2, n_points=512)


@pytest.fixture(scope='module')
def full_width():
    """IA-SSD.yaml at full widths, NPOINT_LIST / 8, 2 scans of 2048."""
    cfg = scale_sa_config(iassd_kitti_cfg().MODEL, 8)
    jax_cfg = jax_scale_sa_config(jax_iassd_kitti_cfg().MODEL, 8)
    return _run_both(jax_cfg, cfg, cfg.POST_PROCESSING, seed=1, batch=2,
                     n_points=2048)


CONFIGS = ['tiny', 'full_width']


@pytest.mark.parametrize('config', CONFIGS)
def test_sampled_points_are_identical(config, request):
    """Per-layer sampled points (FPS, prefix nesting, ctr_aware top-k) are
    gathered by identical indices, so they are bitwise equal."""
    cfg, jax_out, out, _, _ = request.getfixturevalue(config)
    sa = cfg.BACKBONE_3D.SA_CONFIG
    for k, methods in enumerate(sa.SAMPLE_METHOD_LIST):
        if 'ctr_aware' in methods:
            s = np.asarray(jax.nn.sigmoid(
                jnp.max(jax_out['sa_ins_preds'][k - 1], axis=-1)))
            t = torch.sigmoid(out['sa_ins_preds'][k - 1].amax(-1)).numpy()
            diff = float(np.abs(s - t).max())
            assert diff < SCORE_TOL, f'layer {k}: scores differ by {diff:.2e}'
            # two of the top npoint+1 scores can swap between the packages
            # only if their gap is within twice that difference: then the
            # seed is unfit for an exact comparison, and this says so
            top = -np.sort(-s, axis=-1)[:, :sa.NPOINT_LIST[k][0] + 1]
            gap = float((top[:, :-1] - top[:, 1:]).min())
            assert gap > 2 * diff, f'layer {k}: near-tie {gap:.2e}'
        if methods:
            np.testing.assert_array_equal(
                out['encoder_xyz'][k + 1].numpy(),
                np.asarray(jax_out['encoder_xyz'][k + 1]),
                err_msg=f'layer {k} ({methods}) sampled points')


@pytest.mark.parametrize('config', CONFIGS)
def test_features_and_predictions_within_tolerance(config, request):
    _, jax_out, out, _, _ = request.getfixturevalue(config)
    for key in ('centers', 'centers_origin', 'ctr_offsets', 'centers_features',
                'batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jax_out[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for k, (a, b) in enumerate(zip(out['encoder_features'],
                                   jax_out['encoder_features'])):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL, err_msg=f'features {k}')


@pytest.mark.parametrize('config', CONFIGS)
def test_nms_outputs_match(config, request):
    _, _, _, jax_dets, dets = request.getfixturevalue(config)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(),
                                      np.asarray(jax_dets[key]), err_msg=key)
    np.testing.assert_allclose(dets['boxes'].numpy(),
                               np.asarray(jax_dets['boxes']), rtol=RTOL,
                               atol=ATOL)
