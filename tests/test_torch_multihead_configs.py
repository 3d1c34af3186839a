"""The four configs of the grouped multi-head RPN and SECOND-IoU in the
port against the JAX package on the CPU, at full model width:
``kitti_models/second_multihead.yaml``, ``kitti_models/second_iou.yaml``,
``nuscenes_models/cbgs_pp_multihead.yaml`` and
``nuscenes_models/cbgs_second_multihead.yaml``.

Each config goes through the port's ``build_detector_from_cfg`` and the
JAX package's (the class names, point channels, voxel size and final grid
from its DATA_CONFIG). The only cuts are of scale: a cropped range (final
grids of 32 x 32 for the voxel configs, 64 x 64 pillars), the voxel caps
(1500 voxels a level, 800 pillars), small synthetic scans with the
dataset's point channels. Both packages get the port's host batch and the
same numpy-filled variables through the weight bridge (``_variables``,
the heads' box convolutions at 0.05). The JAX ``SECONDNet`` builds
``VoxelBackBone8x`` whatever BACKBONE_3D names, while
``cbgs_second_multihead.yaml`` names ``VoxelResBackBone8x`` (as the port
and the reference build it), so that config is held stage by stage: the
JAX package's ``VoxelResBackBone8x`` module (its CenterPoint's), then the
JAX model's HeightCompression, BEV backbone, ``AnchorHeadMulti`` and
``multi_classes_nms_batch``. Head outputs within RTOL relative plus ATOL
times each tensor's largest entry; detections' labels and counts
identical, boxes and scores within the same tolerance.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models.backbones_3d.spconv_backbone import \
    VoxelResBackBone8x as JaxVoxelResBackBone
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector_from_cfg
from spsnet_torch.models.backbones_3d.spconv_backbone import \
    VoxelResBackBone8x
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_multihead_train import BOX_LAYERS
from tests.test_torch_pvrcnn_train import _variables

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B = 2
RTOL, ATOL = 1e-4, 1e-4
# scores of two slots this close may come out of the merge in either
# order: the packages' logits differ by ~1e-6 (fp32 sums in another order)
SCORE_SLACK = 1e-5
# config: (crop, voxel or pillar cap, data seed, points a scan)
CONFIGS = {
    'kitti_models/second_multihead.yaml': ((0, -6.4, -3, 12.8, 6.4, 1),
                                           1500, 80, 3000),
    'kitti_models/second_iou.yaml': ((0, -6.4, -3, 12.8, 6.4, 1), 1500, 81,
                                     3000),
    'nuscenes_models/cbgs_pp_multihead.yaml': (
        (-6.4, -6.4, -5, 6.4, 6.4, 3), 800, 82, 3000),
    'nuscenes_models/cbgs_second_multihead.yaml': (
        (-12.8, -12.8, -5, 12.8, 12.8, 3), 1500, 83, 3000),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def _cut(cfg, crop, cap):
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
    for step in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if step.NAME == 'transform_points_to_voxels':
            step.MAX_NUMBER_OF_VOXELS = {'train': cap, 'test': cap}
        if step.NAME == 'build_sparse_conv_plan':
            step.MAX_VOXELS_PER_LEVEL = cap


def _scans(cfg, seed, n):
    pcr = tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    channels = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    scans = synthetic_scan_batch(seed, B, n, pc_range=pcr)
    extra = np.random.default_rng(seed).uniform(
        0, 1, (B, n, channels - 4)).astype(np.float32)
    return np.concatenate([scans, extra], axis=-1)


def _fill_head(variables):
    for name, layer in variables['params']['dense_head'].items():
        if name.endswith(BOX_LAYERS) or name == 'conv_box':
            layer['kernel'] = layer['kernel'] * np.float32(0.05)
    return variables


_RUNS = {}


def _run(path):
    """Both packages' eval forward of ``path`` (cut as stated) with the
    same variables, every leaf of whose tree maps onto a port key and
    back, and JAX's ``post_processing``."""
    if path in _RUNS:
        return _RUNS[path]
    crop, cap, seed, n = CONFIGS[path]
    cfgs = []
    for z in (jax_zoo, zoo):
        cfg = z.load_yaml_cfg(f'tools/cfgs/{path}')
        _cut(cfg, crop, cap)
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    batch = voxel_batch(_scans(cfg, seed, n), cfg.DATA_CONFIG)
    jm = jax_build_from_cfg(jcfg)
    variables = _fill_head(_variables(jm, batch))
    post = StaticConfig(copy.deepcopy(jcfg.MODEL.POST_PROCESSING))
    names = list(cfg.CLASS_NAMES)
    backbone = cfg.MODEL.get('BACKBONE_3D', None)
    if backbone is not None and backbone.NAME == 'VoxelResBackBone8x':
        jres = JaxVoxelResBackBone(model_cfg=StaticConfig(
            copy.deepcopy(jcfg.MODEL.BACKBONE_3D)),
            input_channels=batch['voxels'].shape[-1])
        vfe = jax.jit(lambda v, b: jm.apply(
            v, b, method=lambda m, b: m.vfe(b, train=False)))(
                variables, batch)
        res = _variables(jres, vfe)
        for c in ('params', 'batch_stats'):
            variables[c]['backbone_3d'] = res[c]

        def forward(v, b):
            b = jres.apply({c: v[c]['backbone_3d'] for c in v},
                           jm.apply(v, b,
                                    method=lambda m, b: m.vfe(b, False)),
                           train=False)
            out = jm.apply(v, b, method=lambda m, b: m.dense_head(
                m.backbone_2d(m.map_to_bev_module(b, False), False), False))
            return out, jax_post_processing(out, post)
    else:
        def forward(v, b):
            out = jm.apply(v, b, train=False)
            return out, jax_post_processing(out, post, class_names=names)
    jout, jdets = jax.jit(forward)(variables, batch)
    model = build_detector_from_cfg(cfg, device='cpu')
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    dets = post_processing(out, cfg.MODEL.POST_PROCESSING, class_names=names)
    _RUNS[path] = {'cfg': cfg, 'model': model, 'out': out, 'jout': jout,
                   'dets': dets, 'jdets': jdets}
    return _RUNS[path]


@pytest.mark.parametrize('path', sorted(CONFIGS))
def test_multihead_and_secondiou_configs_serve_as_jax(path):
    """The config at full width: the BEV map, the anchor head's
    predictions (every group's classes in the dense matrix), and the
    detections (multi-class NMS, or SECOND-IoU's RoIs, IoU logits and
    rescoring): labels and counts identical, boxes and scores within
    tolerance, detections in every frame."""
    run = _run(path)
    out, jout, dets, jdets = run['out'], run['jout'], run['dets'], \
        run['jdets']
    _close(out['spatial_features_2d'],
           np.asarray(jout['spatial_features_2d']).transpose(0, 3, 1, 2),
           'spatial_features_2d')
    ret, jret = out['anchor_head_ret'], jout['anchor_head_ret']
    for key in ('cls_preds', 'box_preds', 'dir_preds'):
        _close(ret[key], jret[key], key)
    n_class = len(run['cfg'].CLASS_NAMES)
    assert ret['cls_preds'].shape[-1] == n_class
    if 'roi_head' in run['model']._modules:
        for key in ('batch_box_preds', 'batch_cls_preds', 'batch_roi_scores'):
            _close(out[key], jout[key], key)
        np.testing.assert_array_equal(out['batch_roi_labels'].numpy(),
                                      jout['batch_roi_labels'])
        np.testing.assert_array_equal(dets['indices'].numpy(),
                                      jdets['indices'])
        _close(dets['iou_scores'], jdets['iou_scores'], 'iou_scores')
    for key in ('labels', 'count'):
        np.testing.assert_array_equal(dets[key].numpy(), jdets[key],
                                      err_msg=key)
    _close(dets['scores'], jdets['scores'], 'scores')
    hold_boxes(dets, jdets)
    assert int(dets['count'].min()) > 0


def hold_boxes(dets, jdets):
    """The kept boxes within tolerance slot by slot, or, where two slots
    hold scores within SCORE_SLACK of each other (the merge's order of
    near-equal scores of two packages rounding otherwise), each box of the
    port within tolerance of a JAX box of such a slot with its label, one
    for one. Returns the number of slots so matched."""
    boxes, jboxes = dets['boxes'].numpy(), np.asarray(jdets['boxes'])
    scores, labels = dets['scores'].numpy(), dets['labels'].numpy()
    tol = ATOL * float(np.abs(jboxes).max())

    def close(a, b):
        return np.all(np.abs(a - b) <= tol + RTOL * np.abs(b))
    moved = 0
    for b in range(boxes.shape[0]):
        free = set(range(int(dets['count'][b])))
        for i in range(int(dets['count'][b])):
            if close(boxes[b, i], jboxes[b, i]):
                free.discard(i)
                continue
            match = [j for j in free if labels[b, j] == labels[b, i] and
                     abs(scores[b, j] - scores[b, i]) <= SCORE_SLACK and
                     close(boxes[b, i], jboxes[b, j])]
            assert match, (b, i, scores[b, i])
            free.discard(match[0])
            moved += 1
    return moved


def test_cbgs_second_multihead_builds_the_residual_backbone():
    """cbgs_second_multihead.yaml: the port builds the VoxelResBackBone8x
    its BACKBONE_3D names (the JAX SECONDNet would build VoxelBackBone8x),
    a shared conv of 64, six head groups over the ten classes with
    SEPARATE_REG_CONFIG
    branches, the code of size 9 with (sin, cos) headings (10 channels)
    and boxes of 9 columns (the velocity) out of the NMS."""
    run = _run('nuscenes_models/cbgs_second_multihead.yaml')
    model = run['model']
    assert isinstance(model.backbone_3d, VoxelResBackBone8x)
    head = model.dense_head
    assert len(head.rpn_heads) == 6
    assert head.shared_conv[0].out_channels == 64
    assert set(head.rpn_heads[1].conv_box) == {
        'conv_reg', 'conv_height', 'conv_size', 'conv_angle', 'conv_velo'}
    assert run['out']['anchor_head_ret']['box_preds'].shape[-1] == 10
    assert run['dets']['boxes'].shape[-1] == 9
    assert len(run['dets']['labels'].unique()) > 1
