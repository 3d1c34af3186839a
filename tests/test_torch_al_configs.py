"""The AL_3D stack's configs of ``tools/cfgs`` in the port against the JAX
package on the CPU, at full model width: KITTI's ``AL.yaml`` and
``MLT_SSD.yaml`` and nuScenes' ``MLT_SSD.yaml``, and the refusal of
nuScenes' ``AL.yaml`` by both packages.

Each config goes through both packages' ``build_detector_from_cfg`` (the
class names, point channels, pillar size and range from its DATA_CONFIG).
The only cuts are of scale, each listed here:

- the range cropped to 64 x 64 pillars (``CROPS``), with
  ``BACKBONE_3D.POINT_CLOUD_RANGE`` the crop and ``BEV_SHAPE`` [64, 64]
  recomputed from it (the BEV map is the pillar grid);
- ``RANGE_SHAPE`` [32, 256], a narrower range image (2048 columns);
- synthetic scans of N_POINTS points a frame with the dataset's point
  channels, sampled to N_SAMPLED (NUM_POINTS; 16 384 or 65 536);
- the pillar cap MAX_NUMBER_OF_VOXELS N_PILLARS (16 000 to 160 000).

Both packages get the port's host batch and the same numpy-filled
variables through the weight bridge, JAX's projections the port's
coordinates after the boundary rule holds them (``tests/test_torch_al.py``
``jax_coords_of``). Stage by stage: the pillar features, the detection
features (BEV d0 | fusion), the semantic logits, RB_Fusion's map and each
head group's maps within RTOL relative plus ATOL of each tensor's largest
entry, the class-specific NMS's detections as ``hold_detections`` holds
them. nuScenes' MLT_SSD also trains: its scans' five channels (the
range embedding reads the first four) and its 10-wide gt boxes (velocity
before the class) into a head of eight code weights, the train forward on
JAX's dropout masks and its loss terms within 1e-4 relative.
"""
import copy

import numpy as np
import jax
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.models.detectors import \
    build_detector_from_cfg as jax_build_from_cfg
from spsnet_torch import zoo
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.models import blocks, build_detector_from_cfg
from spsnet_torch.models.detectors.al_net import ALNet
from spsnet_torch.models.detectors.detector3d import head_detections
from spsnet_torch.runtime.trainer import step_rngs
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax
from tests.test_torch_al import jax_coords_of
from tests.test_torch_al_train import _jax_masks
from tests.test_torch_centerpoint import _cp_variables, hold_detections
from tests.test_torch_pointpillar import _close, _nhwc, _t
from tests.test_torch_secondiou import _Replay

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, N_POINTS, N_SAMPLED, N_PILLARS = 2, 3000, 2500, 800
RANGE_SHAPE = [32, 256]
# crops of 64 x 64 pillars: KITTI's 0.16 m, nuScenes' 0.2 m
CROPS = {'kitti_models/AL.yaml': (0, -5.12, -3, 10.24, 5.12, 1),
         'kitti_models/MLT_SSD.yaml': (0, -5.12, -3, 10.24, 5.12, 1),
         'nuscenes_models/MLT_SSD.yaml': (-6.4, -6.4, -5, 6.4, 6.4, 3)}
# config: (data seed, point channels, NMS_POST_MAXSIZE)
CONFIGS = {'kitti_models/AL.yaml': (80, 4, 80),
           'kitti_models/MLT_SSD.yaml': (81, 4, 80),
           'nuscenes_models/MLT_SSD.yaml': (82, 5, 83)}
_RUNS = {}


def _cut(cfg, crop):
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
    for step in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if step.NAME == 'transform_points_to_voxels':
            step.MAX_NUMBER_OF_VOXELS = {'train': N_PILLARS,
                                         'test': N_PILLARS}
            vs = step.VOXEL_SIZE
        if step.NAME == 'sample_points':
            step.NUM_POINTS = {'train': N_SAMPLED, 'test': N_SAMPLED}
    b3 = cfg.MODEL.BACKBONE_3D
    b3.POINT_CLOUD_RANGE = list(crop)
    b3.BEV_SHAPE = [int(round((crop[4] - crop[1]) / vs[1])),
                    int(round((crop[3] - crop[0]) / vs[0]))]
    b3.RANGE_SHAPE = list(RANGE_SHAPE)


def _cfgs(path):
    cfgs = []
    for z in (jax_zoo, zoo):
        cfg = z.load_yaml_cfg(f'tools/cfgs/{path}')
        _cut(cfg, CROPS[path])
        cfgs.append(cfg)
    return cfgs


def _scans(path):
    seed, channels, _ = CONFIGS[path]
    scans = synthetic_scan_batch(seed, B, N_POINTS, pc_range=CROPS[path])
    return np.concatenate([scans, np.random.default_rng(seed).uniform(
        0, 1, (B, N_POINTS, channels - 4)).astype(np.float32)], axis=-1)


def _run(path):
    """Both packages' models of ``path`` cut as stated, every leaf of the
    flax tree on a port key and back, and each one's eval forward on the
    port's batch of B scans (JAX's on the port's coordinates)."""
    if path in _RUNS:
        return _RUNS[path]
    seed = CONFIGS[path][0]
    jcfg, cfg = _cfgs(path)
    batch = voxel_batch(_scans(path), cfg.DATA_CONFIG,
                        rng=np.random.RandomState(seed))
    jm = jax_build_from_cfg(jcfg)
    variables = _cp_variables(jm, batch)
    model = build_detector_from_cfg(cfg, device='cpu')
    assert set(flax_to_torch(variables)) == set(model.state_dict())
    load_flax(model, variables)
    tb = {k: _t(v) for k, v in batch.items()}
    with jax_coords_of(model.backbone_3d, tb) as differ:
        jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                                 batch)
    with torch.no_grad():
        out = model(tb)
    _RUNS[path] = {'cfg': cfg, 'jcfg': jcfg, 'batch': batch, 'jm': jm,
                   'variables': variables, 'model': model, 'out': out,
                   'jout': jout, 'differ': differ}
    return _RUNS[path]


@pytest.mark.parametrize('path', sorted(CONFIGS))
def test_al_config_serves_as_jax(path):
    """The config at full width on its crop: the pillar features, the
    detection features, the semantic logits, RB_Fusion's map, each head
    group's maps, and the class-specific NMS's detections a class segment
    (``hold_detections``), detections in every frame."""
    run = _run(path)
    _, channels, post = CONFIGS[path]
    model, out, jout, batch = run['model'], run['out'], run['jout'], \
        run['batch']
    assert type(model) is ALNet
    assert batch['points'].shape == (B, N_SAMPLED, channels)
    assert model.vfe.pfn_layers[0].linear.in_features == channels + 6
    assert int(batch['voxel_valid'].sum(1).max()) == N_PILLARS
    _close(out['pillar_features'], jout['pillar_features'], 'pillars')
    _close(out['spatial_features'], _nhwc(jout['spatial_features']),
           'detection features')
    assert out['spatial_features'].shape[-2:] == (16, 16)
    assert out['spatial_features'].shape[1] == \
        int(run['cfg'].MODEL.BACKBONE_2D.BEV_DIM) + \
        int(run['cfg'].MODEL.BACKBONE_2D.RANGE_DIM)
    _close(out['sem_pred'], jout['sem_pred'], 'sem_pred')
    _close(out['spatial_features_2d'], _nhwc(jout['spatial_features_2d']),
           'RB_Fusion')
    groups = out['center_head_iou_ret']['pred_dicts']
    heads = run['cfg'].MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD
    assert len(groups) == len(heads)
    for g, (pd, jpd) in enumerate(zip(
            groups, jout['center_head_iou_ret']['pred_dicts'])):
        for k in pd:
            _close(pd[k], _nhwc(jpd[k]), f'head {g} {k}')
    n_class = len(run['cfg'].CLASS_NAMES)
    assert out['final_valid'].shape[1] == post * n_class
    hold_detections(out, jout, [post * k for k in range(1, n_class)])
    assert int(head_detections(out)['count'].min()) > 0


def test_nuscenes_mlt_ssd_trains_on_velocity_gt_as_jax():
    """nuScenes' MLT_SSD in training on its five-channel scans with 10-wide
    gt boxes (x, y, z, dx, dy, dz, heading, vx, vy, class): the train
    forward on JAX's dropout masks (the semantic logits, the fused map)
    and the loss terms (each head group's heatmap, location and IoU
    terms) within 1e-4 relative, every one non-zero."""
    path = 'nuscenes_models/MLT_SSD.yaml'
    run = _run(path)
    rng = np.random.default_rng(83)
    # a box in each head group: car, truck, bus, barrier, motorcycle,
    # pedestrian
    gt = np.zeros((B, 6, 10), np.float32)
    gt[..., :2] = rng.uniform(-5, 5, (B, 6, 2))
    gt[..., 2] = -1.0
    gt[..., 3:6] = [[4.6, 1.9, 1.7], [6.9, 2.5, 2.8], [11.0, 2.9, 3.5],
                    [0.5, 2.5, 1.0], [2.1, 0.8, 1.5], [0.7, 0.7, 1.7]]
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, 6))
    gt[..., 7:9] = rng.normal(0, 2, (B, 6, 2))
    gt[..., 9] = [1, 2, 4, 6, 7, 9]
    batch = dict(run['batch'], gt_boxes=gt)
    jm, variables, model = run['jm'], run['variables'], run['model']
    tb = {k: _t(v) for k, v in batch.items()}
    with jax_coords_of(model.backbone_3d, tb):
        jout, masks = _jax_masks(jm, variables, batch)
        jl, jtb = jax.jit(lambda v, o: jm.apply(v, o, method='loss'))(
            variables, jout)
    replay = _Replay(masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks.Dropout, 'forward',
                   lambda m, x, g=None: replay(m, x, g))
        train = copy.deepcopy(model).train()
        with torch.no_grad():
            out = train(dict(tb, rngs=step_rngs(0)))
            loss, tbl = train.loss(out)
    assert not replay.masks
    _close(out['sem_pred'], jout['sem_pred'], 'sem_pred in training')
    _close(out['spatial_features_2d'], _nhwc(jout['spatial_features_2d']),
           'RB_Fusion in training')
    assert set(tbl) == set(jtb) and len(train.dense_head.heads_list) == 6
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k, v in tbl.items():
        np.testing.assert_allclose(float(v), float(jtb[k]), rtol=1e-4,
                                   err_msg=k)
        assert float(v) > 0, k


def test_nuscenes_al_yaml_is_refused_by_both_packages():
    """nuScenes' AL.yaml sets BEV_SHAPE [512, 512] over a 256 x 256 pillar
    grid (0.4 m over 102.4 m): JAX's AL_3D concatenates the BEV U-Net's d0
    (64 x 64) with the fusion (128 x 128) and fails (a TypeError when its
    shapes are traced); the port refuses the config at build with a
    ValueError naming BEV_SHAPE and the pillar grid."""
    path = 'tools/cfgs/nuscenes_models/AL.yaml'
    jcfg, cfg = jax_zoo.load_yaml_cfg(path), zoo.load_yaml_cfg(path)
    for c in (jcfg, cfg):
        c.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS = {
            'train': 64, 'test': 64}
    scans = synthetic_scan_batch(84, 1, 256, pc_range=(
        -51.2, -51.2, -5, 51.2, 51.2, 3))
    scans = np.concatenate([scans, np.zeros((1, 256, 1), np.float32)], -1)
    batch = voxel_batch(scans, cfg.DATA_CONFIG,
                        rng=np.random.RandomState(84))
    jm = jax_build_from_cfg(jcfg)
    with pytest.raises(TypeError, match='concatenate'):
        jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                         train=False), batch)
    with pytest.raises(ValueError, match=r'BEV_SHAPE \[512, 512\] is not '
                                         r'the pillar grid .* \(256, 256\)'):
        build_detector_from_cfg(cfg, device='cpu')
