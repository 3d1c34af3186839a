"""Both Waymo PV-RCNN++ configs (``waymo_models/pv_rcnn_plusplus.yaml`` and
``pv_rcnn_plusplus_resnet.yaml``) in the port against the JAX package on
the CPU, at full model width on a cropped range (the cuts of
``tests/test_torch_voxel_configs.py``), and the two packages' three-NN
forms against each other. Tolerances as ``tests/test_torch_pvrcnnpp.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.models.model_utils import vector_pool as jax_vp
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector_from_cfg
from spsnet_torch.models.detectors import unported_modules
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_pvrcnn_train import ATOL, RTOL
from tests.test_torch_pvrcnnpp import _close, _pp_variables, _t
from tests.test_torch_voxel_configs import WAYMO_CROP, _cut, _scans

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)


def _numpy_three_nn(unknown, known):
    """The port's three-NN form in numpy fp32 (each product and sum rounded
    on its own, ``spsnet_torch/ops/interpolate.py``), the lowest index
    first among equal distances: (d2 (B, N, 3) float32, idx int32)."""
    u = [unknown[..., a][:, :, None] for a in range(3)]
    k = [known[..., a][:, None, :] for a in range(3)]
    u_sq = (u[0] * u[0] + u[1] * u[1]) + u[2] * u[2]
    k_sq = (k[0] * k[0] + k[1] * k[1]) + k[2] * k[2]
    cross = (u[0] * k[0] + u[1] * k[1]) + u[2] * k[2]
    d2 = (u_sq + k_sq) - np.float32(2.0) * cross
    idx = np.argsort(d2, axis=-1, kind='stable')[..., :3]
    return np.take_along_axis(d2, idx, -1), idx.astype(np.int32)


def _jax_three_nn_in_the_ports_form(unknown, known):
    """A ``three_nn`` for the JAX package's VectorPool module: the port's
    form through a numpy callback (under jit too)."""
    B, N, _ = unknown.shape
    shapes = (jax.ShapeDtypeStruct((B, N, 3), jnp.float32),
              jax.ShapeDtypeStruct((B, N, 3), jnp.int32))
    return jax.pure_callback(_numpy_three_nn, shapes, unknown, known)


def test_three_nn_forms_agree_within_their_rounding_slack():
    """The port's three-NN (``three_nn_plain``, each product and sum
    rounded on its own) against the JAX package's (|a|^2 + |b|^2 - 2ab
    through a batched matmul) and the numpy form of the full-width tests:
    the port equals numpy bit for bit; JAX's sorted distances lie within
    SLACK_ULPS ulps of |u|^2 + |k|^2 of the port's (an index may differ
    only between distances that close), at 70 m and with queries on
    supports (d2 = 0, which both forms round to +-ulps)."""
    from spsnet_tpu.ops.interpolate import three_nn as jax_three_nn
    from spsnet_torch.ops.interpolate import three_nn_plain
    rng = np.random.default_rng(13)
    known = rng.uniform([0, -40, -3], [70.4, 40, 1], (2, 3000, 3)).astype(
        np.float32)
    unknown = np.concatenate([known[:, :200], known[:, 200:400] + rng.normal(
        0, 0.3, (2, 200, 3)).astype(np.float32)], axis=1)
    d2, idx = three_nn_plain(_t(unknown), _t(known))
    nd2, nidx = _numpy_three_nn(unknown, known)
    np.testing.assert_array_equal(d2.numpy().view(np.int32),
                                  nd2.view(np.int32))
    np.testing.assert_array_equal(idx.numpy(), nidx)
    jd2, jidx = (np.asarray(t) for t in jax.jit(jax_three_nn)(unknown,
                                                               known))
    k_sq = (known.astype(np.float64) ** 2).sum(-1)
    norms = (unknown.astype(np.float64) ** 2).sum(-1)[..., None] + \
        np.maximum(np.take_along_axis(k_sq, idx.numpy().reshape(2, -1),
                                      1).reshape(idx.shape),
                   np.take_along_axis(k_sq, jidx.reshape(2, -1).astype(
                       np.int64), 1).reshape(jidx.shape))
    slack = SLACK_ULPS * 2.0 ** -23 * norms
    assert (np.abs(d2.numpy() - jd2) <= slack).all()
    assert (d2[:, :200, 0] <= 0).any() and (idx.numpy() != jidx).sum() < 20


# the sorted three-NN distances of the two forms: within 8 ulps of the
# norms' sum (each form rounds the two squared norms, three products and
# two sums at that scale)
SLACK_ULPS = 8


@pytest.mark.parametrize('name', ['pv_rcnn_plusplus',
                                  'pv_rcnn_plusplus_resnet'])
def test_waymo_pv_rcnn_plusplus_serves_as_jax(name):
    """The Waymo config at full width (every channel width of the yaml,
    six sectors, the VectorPool groups, the 6^3 RoI grid, 3 classes, 5
    point channels). Cuts: WAYMO_CROP, 1500 voxels a level, scans of 3000
    points, 256 keypoints, 64 / 16 proposals before / after the RoI head's
    test NMS. JAX's VectorPool three-NN is computed in the port's form
    (``_jax_three_nn_in_the_ports_form``): every keypoint is a raw point,
    so the centre cell of the 3^3 raw-point grid meets it at d2 = 0, which
    either form rounds to +-1 ulp of 2 |u|^2, each with its own sign; where
    that is the cell's only neighbour in the gate and negative, the
    weights' norm is clipped to 1e-8 and the features reach 1e11 (ROADMAP
    Queue 3; the forms are held to each other in
    ``test_three_nn_forms_agree_within_their_rounding_slack``).

    Held: the CenterHead's boxes and the RoIs, the SPC keypoints; each
    VectorPool source of the VSA against the JAX module applied to the
    same inputs; the keypoint features of the whole JAX program, but at
    the keypoints (at most 2 a frame) where that program departs from its
    own modules (XLA compiles the program otherwise than the module
    alone); the RoI head from JAX's keypoints and RoIs, and the final
    NMS."""
    path = f'tools/cfgs/waymo_models/{name}.yaml'
    cfgs = []
    for z in (jax_zoo, zoo):
        cfg = z.load_yaml_cfg(path)
        _cut(cfg, WAYMO_CROP, 1500)
        cfg.MODEL.PFE.NUM_KEYPOINTS = 256
        nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
        nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 64, 16
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    assert unported_modules(cfg.MODEL) == []
    batch = voxel_batch(_scans(cfg, 61, 3000), cfg.DATA_CONFIG)
    jm = jax_build_from_cfg(jcfg)
    variables = _pp_variables(jm, batch, seed=62)
    model = build_detector_from_cfg(cfg, device='cpu')
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    post = StaticConfig(cfg.MODEL.POST_PROCESSING)
    pfe_cfg = StaticConfig(jcfg.MODEL.PFE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vp, 'three_nn', _jax_three_nn_in_the_ports_form)
        jout, jdets = jax.jit(lambda v, b: (lambda o: (
            o, jax_post_processing(o, post)))(jm.apply(v, b, train=False)))(
                variables, batch)
        with torch.no_grad():
            out = model({k: _t(v) for k, v in batch.items()})
        _close(out['rois'], jout['roi_head_ret']['rois'], 'rois')
        for k in ('point_valid', 'point_coords'):
            np.testing.assert_array_equal(out[k].numpy(), jout[k],
                                          err_msg=k)
        kp, kv = out['point_coords'], out['point_valid']
        pfe = model.pfe
        tb = {k: _t(v) for k, v in batch.items()}
        sources = [('raw_points', 'raw_vp', pfe.SA_rawpoints,
                    tb['points'][..., :3], tb['points'][..., 3:])] + [
            (n, f'{n}_vp', pfe.SA_layers[n], pfe.voxel_centers(tb, n),
             out['multi_scale_3d_features'][n]) for n in pfe.SA_layers]
        modules = []
        for src, flax_name, group, support, feats in sources:
            jmod = jax_vp.VectorPoolAggregationMSG(
                model_cfg=pfe_cfg.SA_LAYER[src],
                input_channels=feats.shape[-1])
            jvars = {c: t['pfe'][flax_name] for c, t in variables.items()}
            want = jax.jit(lambda v, a, b, c, d, m=jmod: m.apply(
                v, a, b, c, train=False, new_valid=d))(
                    jvars, support.numpy(), feats.numpy(), kp.numpy(),
                    kv.numpy())
            with torch.no_grad():
                got = group(support, feats, kp, kv)
            _close(got, want, f'VectorPool {src}')
            modules.append(np.asarray(want))
    # the keypoints where JAX's program departs from its own modules
    bev = out['point_features_before_fusion'].shape[-1] - sum(
        m.shape[-1] for m in modules)
    jfeats = np.asarray(jout['point_features_before_fusion'])
    alone = np.concatenate([jfeats[..., :bev]] + modules, axis=-1)
    scale = np.abs(alone).max()
    off = (np.abs(jfeats - alone) > RTOL * np.abs(alone) + ATOL * scale).any(
        -1)
    assert off.sum(-1).max() <= 2, off.sum(-1)
    _close(out['point_features_before_fusion'][torch.from_numpy(~off)],
           jfeats[~off], 'keypoint features')
    _close(out['point_features_before_fusion'], alone,
           'keypoint features (the modules alone)')
    stage = {k: _t(jout[k]) for k in ('point_coords', 'point_features',
                                      'point_cls_scores', 'point_valid')}
    stage['batch_cls_preds'] = torch.zeros(2, 1, 3)
    pre = {'rois': _t(jout['roi_head_ret']['rois']),
           'roi_labels': _t(jout['batch_roi_labels']),
           'roi_valid': _t(jout['roi_head_ret']['rois'][..., 3] > 0),
           'targets': None}
    with torch.no_grad():
        head = model.roi_head(stage, pre)
    for k in ('rcnn_cls', 'rcnn_reg'):
        _close(head['roi_head_ret'][k], jout['roi_head_ret'][k], k)
    dets = post_processing(head, cfg.MODEL.POST_PROCESSING)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    _close(dets['boxes'], jdets['boxes'], 'boxes')
    assert int(dets['count'].min()) > 0 and int(kv.sum()) > 100
    assert model.roi_head.shared_fc_layer[0].in_features == 216 * 128
