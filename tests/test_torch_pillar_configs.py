"""The seven pillar configs of ``tools/cfgs`` in the port against the JAX
package on the CPU, at full model width: KITTI's
``pointpillar{,_newaugs,_pyramid_aug}.yaml`` (identical MODEL blocks),
Waymo's ``pointpillar_1x.yaml``, ``centerpoint_pillar_1x.yaml`` and
``centerpoint_dyn_pillar_1x.yaml``, and nuScenes'
``cbgs_dyn_pp_centerpoint.yaml`` (its strided-conv deblock included).

Each config goes through both packages' ``build_detector_from_cfg`` (the
class names, point channels, pillar size and range from its DATA_CONFIG).
The only cuts are of scale: a cropped range of 64 x 64 pillars, small
synthetic scans with the dataset's point channels, the pillar cap
(MAX_NUMBER_OF_VOXELS 800, which cuts) and the sampled points (NUM_POINTS 2500).
Both packages get the port's host batch (the JAX processor's bit for bit:
``tests/test_torch_pointpillar.py``; range masking and shuffling are not
applied, ROADMAP item G) and the same numpy-filled variables through the
weight bridge. The BEV maps and head outputs must lie within RTOL
relative plus ATOL times each tensor's largest entry; the detections as
``hold_nms`` (anchor heads) and ``hold_detections`` (CenterHead groups)
hold them. The dynamic configs' points are checked to hold none where
jitted JAX's reciprocal floors otherwise than the true quotient
(``tests/test_torch_pointpillar.py``'s docstring).
"""
import json

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import build_detector_from_cfg
from spsnet_torch.models.backbones_2d.base_bev_backbone import \
    StridedDeblock
from spsnet_torch.models.detectors.detector3d import (head_detections,
                                                      post_processing)
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_centerpoint import _cp_variables, hold_detections
from tests.test_torch_pointpillar import (_close, _nhwc, _recip_departures,
                                          _t, hold_nms)

B, N_POINTS, N_PILLARS, N_SAMPLED = 2, 3000, 800, 2500
# crops of 64 x 64 pillars
KITTI_CROP = (0, -5.12, -3, 10.24, 5.12, 1)
WAYMO_CROP = (-10.24, -10.24, -2, 10.24, 10.24, 4)
NUSCENES_CROP = (-6.4, -6.4, -5, 6.4, 6.4, 3)
# config: (crop, data seed, head: 'anchor' or the CenterHead's groups,
# point channels, dynamic)
CONFIGS = {
    'kitti_models/pointpillar.yaml': (KITTI_CROP, 70, 'anchor', 4, False),
    'kitti_models/pointpillar_newaugs.yaml': (KITTI_CROP, 70, 'anchor', 4,
                                              False),
    'kitti_models/pointpillar_pyramid_aug.yaml': (KITTI_CROP, 70, 'anchor',
                                                  4, False),
    'waymo_models/pointpillar_1x.yaml': (WAYMO_CROP, 71, 'anchor', 5, False),
    'waymo_models/centerpoint_pillar_1x.yaml': (WAYMO_CROP, 72, 1, 5,
                                                False),
    'waymo_models/centerpoint_dyn_pillar_1x.yaml': (WAYMO_CROP, 73, 1, 5,
                                                    True),
    'nuscenes_models/cbgs_dyn_pp_centerpoint.yaml': (NUSCENES_CROP, 74, 6, 5,
                                                     True),
}
_RUNS = {}


def _cut(cfg, crop):
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
    for step in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if step.NAME == 'transform_points_to_voxels':
            step.MAX_NUMBER_OF_VOXELS = {'train': N_PILLARS,
                                         'test': N_PILLARS}
        if step.NAME == 'sample_points':
            step.NUM_POINTS = {'train': N_SAMPLED, 'test': N_SAMPLED}


def _run(path):
    """Both packages' models of ``path`` cut as stated, every leaf of the
    flax tree on a port key and back, and each one's eval forward (and
    for the anchor configs ``post_processing``) on the port's batch of B
    scans. Configs whose MODEL, range, processor steps, point channels
    and classes agree (KITTI's three, which differ in their augmentations)
    share one run."""
    crop, seed, head, channels, dynamic = CONFIGS[path]
    cfgs = []
    for z in (jax_zoo, zoo):
        cfg = z.load_yaml_cfg(f'tools/cfgs/{path}')
        _cut(cfg, crop)
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    data = cfg.DATA_CONFIG
    key = json.dumps([cfg.MODEL, data.POINT_CLOUD_RANGE, data.DATA_PROCESSOR,
                      data.POINT_FEATURE_ENCODING, cfg.CLASS_NAMES, seed],
                     sort_keys=True)
    if key in _RUNS:
        return cfg, _RUNS[key]
    scans = synthetic_scan_batch(seed, B, N_POINTS, pc_range=crop)
    scans = np.concatenate([scans, np.random.default_rng(seed).uniform(
        0, 1, (B, N_POINTS, channels - 4)).astype(np.float32)], axis=-1)
    batch = voxel_batch(scans, cfg.DATA_CONFIG,
                        rng=np.random.RandomState(seed))
    jm = jax_build_from_cfg(jcfg)
    variables = _cp_variables(jm, batch)
    model = build_detector_from_cfg(cfg, device='cpu')
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    post = StaticConfig(cfg.MODEL.POST_PROCESSING)
    jout, jdets = jax.jit(lambda v, b: (lambda o: (
        o, jax_post_processing(o, post) if head == 'anchor' else None))(
            jm.apply(v, b, train=False)))(variables, batch)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()})
    _RUNS[key] = {'batch': batch, 'model': model, 'out': out, 'jout': jout,
                  'jdets': jdets}
    return cfg, _RUNS[key]


@pytest.mark.parametrize('path', sorted(CONFIGS))
def test_pillar_config_serves_as_jax(path):
    """The config at full width: the pillar features or the dynamic
    canvas, the BEV maps, the head's outputs and its detections (anchor
    heads: ``post_processing``'s indices, counts and labels identical or
    held by ``hold_nms``; CenterHead groups: ``hold_detections``, one NMS
    segment a group), detections in every frame."""
    crop, seed, head, channels, dynamic = CONFIGS[path]
    cfg, run = _run(path)
    model, out, jout, batch = run['model'], run['out'], run['jout'], \
        run['batch']
    vfe = model.vfe
    assert type(vfe).__name__ == ('DynamicPillarVFE' if dynamic
                                  else 'PillarVFE')
    assert vfe.pfn_layers[0].linear.in_features == channels + 6
    if dynamic:
        assert set(batch) == {'points'}
        assert batch['points'].shape == (B, N_SAMPLED, channels)
        pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        vs = cfg.DATA_CONFIG.DATA_PROCESSOR[-1].VOXEL_SIZE
        assert _recip_departures(batch['points'], pcr, vs) == 0
    else:
        assert int(batch['voxel_valid'].sum(1).max()) == N_PILLARS
        _close(out['pillar_features'], jout['pillar_features'],
               'pillar_features')
    _close(out['spatial_features'], _nhwc(jout['spatial_features']),
           'spatial_features')
    assert out['spatial_features'].shape[-2:] == (64, 64)
    _close(out['spatial_features_2d'], _nhwc(jout['spatial_features_2d']),
           'spatial_features_2d')
    if head == 'anchor':
        ret, jret = out['anchor_head_ret'], jout['anchor_head_ret']
        for key in ('cls_preds', 'box_preds', 'dir_preds'):
            _close(ret[key], jret[key], key)
        post = cfg.MODEL.POST_PROCESSING
        dets = post_processing(out, post)
        if hold_nms(out, dets, run['jdets'], post) == 0:
            for key in ('indices', 'count', 'labels'):
                np.testing.assert_array_equal(
                    dets[key].numpy(), run['jdets'][key], err_msg=key)
            _close(dets['boxes'], run['jdets']['boxes'], 'boxes')
        assert int(dets['count'].min()) > 0
        return
    groups = out['center_head_iou_ret']['pred_dicts']
    assert len(groups) == head
    for g, (pd, jpd) in enumerate(zip(groups, jout['center_head_iou_ret'][
            'pred_dicts'])):
        for k in pd:
            _close(pd[k], _nhwc(jpd[k]), f'head {g} {k}')
    slots = int(out['final_valid'].shape[1]) // head
    hold_detections(out, jout, [slots * k for k in range(1, head)])
    assert int(head_detections(out)['count'].min()) > 0


def test_nuscenes_strided_deblock_is_a_conv():
    """nuScenes' UPSAMPLE_STRIDES [0.5, 1, 2]: the first deblock is a
    Conv2d of kernel and stride 2 (``StridedDeblock``), its flax kernel
    mapped as a Conv (no flip, (out, in, kh, kw)); the other two are
    ConvTransposes."""
    cfg, run = _run('nuscenes_models/cbgs_dyn_pp_centerpoint.yaml')
    deblocks = run['model'].backbone_2d.deblocks
    assert isinstance(deblocks[0][0], StridedDeblock)
    assert deblocks[0][0].weight.shape == (128, 64, 2, 2)
    assert all(isinstance(d[0], torch.nn.ConvTranspose2d)
               for d in deblocks[1:])
    assert run['out']['spatial_features_2d'].shape[-2:] == (16, 16)
