"""The PyTorch port stands alone: no JAX, no ``spsnet_tpu``, no build at
import, no silent CPU fallback, and a weight bridge that maps every key.

Its own copies of the JAX package's host modules (configs, synthetic scans)
are held to the originals here.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spsnet_tpu import zoo as jax_zoo
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.stability.model import GenerateCenter as JaxGenerateCenter
from spsnet_tpu.config import EDict as jax_zoo_edict
from spsnet_tpu.data.processor import sparse_plan as jax_plan
from spsnet_tpu.utils.synthetic import synthetic_scan_batch as jax_scan_batch
from spsnet_torch import zoo
from spsnet_torch.data.processor import sparse_plan
from spsnet_torch.models import build_detector
from spsnet_torch.ops import _build
from spsnet_torch.ops.grouping import ball_query_multi_kernel
from spsnet_torch.ops.sampling import (farthest_point_sample_kernel,
                                       farthest_point_sample_seeded_kernel,
                                       seed_min_d2_kernel)
from spsnet_torch.stability.model import GenerateCenter
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import (flax_to_torch,
                                        generator_flax_to_torch, load_flax)
from tests.test_alnet import alnet_tiny_cfg
from tests.test_parta2 import parta2_free_tiny_cfg, parta2_tiny_cfg
from tests.test_pvrcnn import PCR as PV_PCR
from tests.test_pvrcnn import VS as PV_VS
from tests.test_pvrcnn import make_pv_batch, pvrcnn_tiny_cfg
from tests.test_pvrcnn_plusplus import pvrcnnpp_tiny_cfg
from tests.test_voxelrcnn import voxelrcnn_tiny_cfg

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / 'spsnet_torch').rglob('*.py')) + \
    ['chip_smoke.py', 'launch_sweep.py']
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'spsnet_tpu')


def _imported_roots(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', PORT_FILES)
def test_port_file_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{path} imports {bad}'


_CHILD = r'''
import json, subprocess, sys
started = []
class NoProcess:
    def __init__(self, *args, **kwargs):
        started.append(args)
        raise RuntimeError('a subprocess was started')
subprocess.Popen = NoProcess
import torch
import spsnet_torch
from spsnet_torch.models import build_detector
from spsnet_torch.config import EDict
from spsnet_torch.ops import FpsSeeding, _build
from spsnet_torch.runtime.optimization import build_optimizer
from spsnet_torch.runtime.trainer import (device_batch, make_eval_step,
                                          make_stability_preprocess,
                                          make_train_step)
from spsnet_torch.utils.synthetic import (synthetic_scan_batch,
                                          synthetic_scene_batch)
from spsnet_torch.models.detectors.detector3d import post_processing
from spsnet_torch.zoo import (tiny_iassd_cfg, tiny_pointrcnn_cfg,
                              tiny_spsnet_cfg, tiny_stability_model_cfg)
model = build_detector(tiny_iassd_cfg(), 3, device='cpu')
with torch.no_grad():
    out = model({'points': torch.from_numpy(synthetic_scan_batch(0, 1, 256))})
cfg = tiny_iassd_cfg()
cfg.BACKBONE_3D.SA_CONFIG.NPOINT_LIST[0] = [256]   # seeded: k0 = 128
trained = build_detector(cfg, 3, device='cpu',
                         fps_seeding=FpsSeeding(0.75, 'grid')).train()
opt_cfg = EDict({
    'OPTIMIZER': 'adam_onecycle', 'LR': 0.01, 'WEIGHT_DECAY': 0.01,
    'MOMS': [0.95, 0.85], 'PCT_START': 0.4, 'DIV_FACTOR': 10})
opt = build_optimizer(opt_cfg, trained.parameters(), 10, 1)
pts, gt = synthetic_scene_batch(0, 1, 512)
loss, _ = make_train_step(trained, opt)(
    device_batch({'points': pts, 'gt_boxes': gt}, 'cpu'))
spsnet = build_detector(tiny_spsnet_cfg(), 3, device='cpu')
hook = EDict({'CKPT': None, 'DELETE_NUMBER': 32,
              'MODEL': tiny_stability_model_cfg()})
pts, gt = synthetic_scene_batch(1, 2, 256)
dets, _ = make_eval_step(spsnet, tiny_spsnet_cfg().POST_PROCESSING,
                         make_stability_preprocess(hook, 'cpu'))(
    device_batch({'points': pts, 'gt_boxes': gt}, 'cpu'))
sps_loss, _ = make_train_step(
    spsnet, build_optimizer(opt_cfg, spsnet.parameters(), 10, 1),
    make_stability_preprocess(hook, 'cpu'))(
        device_batch({'points': pts, 'gt_boxes': gt}, 'cpu'))
from spsnet_torch.stability import GenerateCenter, make_stability_train_step
gen = GenerateCenter(tiny_stability_model_cfg())
stab_loss, _ = make_stability_train_step(
    gen, build_optimizer(opt_cfg, gen.parameters(), 10, 1), 0)(
        device_batch({'points': pts, 'gt_boxes': gt}, 'cpu'))
prcnn = build_detector(tiny_pointrcnn_cfg(), 3, device='cpu')
with torch.no_grad():
    prcnn_dets = post_processing(
        prcnn({'points': torch.from_numpy(synthetic_scan_batch(0, 1, 256))}),
        tiny_pointrcnn_cfg().POST_PROCESSING)
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.runtime.trainer import device_batch
from spsnet_torch.zoo import pv_rcnn_kitti_cfg, tiny_pvrcnn_cfg
pv_cfg = pv_rcnn_kitti_cfg()
crop = [0, -6.4, -3, 12.8, 6.4, 1]
pv_cfg.DATA_CONFIG.POINT_CLOUD_RANGE = crop
pv_model = build_detector(tiny_pvrcnn_cfg((2, 32, 32)), 1, device='cpu',
                          voxel_size=(0.05, 0.05, 0.1), point_cloud_range=crop,
                          final_grid_zyx=(2, 32, 32))
with torch.no_grad():
    pv_dets = post_processing(
        pv_model(device_batch(voxel_batch(
            synthetic_scan_batch(0, 1, 256, pc_range=crop), pv_cfg.DATA_CONFIG),
            'cpu')), tiny_pvrcnn_cfg((2, 32, 32)).POST_PROCESSING)
print(json.dumps({
    'pvrcnn_indices': list(pv_dets['indices'].shape),
    'jax_modules': sorted(m for m in sys.modules
                          if m.split('.')[0] in ('jax', 'flax', 'optax',
                                                 'orbax', 'spsnet_tpu')),
    'processes': len(started), 'libraries': len(_build._LIBS),
    'boxes': list(out['batch_box_preds'].shape),
    'finite_loss': bool(torch.isfinite(loss)),
    'spsnet_indices': list(dets['indices'].shape),
    'pointrcnn_indices': list(prcnn_dets['indices'].shape),
    'finite_train_losses': bool(torch.isfinite(sps_loss))
                           and bool(torch.isfinite(stab_loss))}))
'''


def test_import_cpu_forward_and_train_step_load_no_jax_and_build_nothing():
    """Import, an IA-SSD forward, a train step, an SPSNet eval step and
    train step with the stability preprocess, a stability-model train
    step, a PointRCNN forward with its post-processing and a PV-RCNN one
    on a batch of the port's own voxelization, all on the CPU: no JAX
    module is loaded and no kernel is built."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(ROOT)
    # one intra-op thread, as in the test modules: the child runs beside
    # the suite's other workers
    env['OMP_NUM_THREADS'] = '1'
    res = subprocess.run([sys.executable, '-c', _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {'pvrcnn_indices': [1, 8],
                   'jax_modules': [], 'processes': 0, 'libraries': 0,
                   'boxes': [1, 16, 7], 'finite_loss': True,
                   'spsnet_indices': [2, 16], 'pointrcnn_indices': [1, 8],
                   'finite_train_losses': True}


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_detector(zoo.tiny_iassd_cfg(), 3)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points never run a plain version in their place."""
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match='CUDA'):
        farthest_point_sample_kernel(xyz, 4)
    with pytest.raises(ValueError, match='CUDA'):
        ball_query_multi_kernel((0.5,), (4,), xyz, xyz[:, :2])
    with pytest.raises(ValueError, match='CUDA'):
        seed_min_d2_kernel(xyz, xyz[:, :2])
    with pytest.raises(ValueError, match='CUDA'):
        farthest_point_sample_seeded_kernel(
            xyz, 4, torch.zeros(1, 8), torch.arange(2)[None])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.find_nvcc()


def test_build_dir_is_keyed_by_sources_and_ignored_by_git():
    d = _build.build_dir()
    assert d.parent == ROOT / 'build' / 'spsnet_torch' and len(d.name) == 16
    assert 'build/' in (ROOT / '.gitignore').read_text().split()


def _jax_variables(kind):
    points = synthetic_scan_batch(0, 1, 256)
    if kind == 'generator':
        model = JaxGenerateCenter(
            model_cfg=StaticConfig(zoo.tiny_stability_model_cfg()))
        # train=True creates every variable (eval skips obj_encoder)
        variables = jax.jit(lambda key, pts: model.init(
            {'params': key, 'latent': key}, {'points': pts}, train=True))(
                jax.random.PRNGKey(0), points)
    elif kind == 'pvrcnn':
        batch, final_zyx = make_pv_batch(np.random.default_rng(0))
        model = jax_build_detector(
            jax_zoo_edict(zoo.tiny_pvrcnn_cfg(final_zyx)), num_class=1,
            voxel_size=PV_VS, point_cloud_range=PV_PCR,
            final_grid_zyx=tuple(int(v) for v in final_zyx))
        variables = jax.jit(lambda key, b: model.init(key, b, train=False))(
            jax.random.PRNGKey(0), {k: v for k, v in batch.items()
                                    if k != 'gt_boxes'})
    else:
        cfg = {'iassd': jax_zoo.tiny_iassd_cfg,
               'spsnet': jax_zoo.tiny_spsnet_cfg,
               'pointrcnn': jax_zoo.tiny_pointrcnn_cfg}[kind]()
        batch = {'points': points}
        if kind == 'spsnet':
            batch['stds'] = np.linspace(0.5, 9.0, 256,
                                        dtype=np.float32)[None]
        model = jax_build_detector(cfg, num_class=3)
        variables = jax.jit(lambda key, b: model.init(key, b, train=False))(
            jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


# the bridge of each variable tree: the port's module and its converter
BRIDGES = {
    'iassd': (lambda: build_detector(zoo.tiny_iassd_cfg(), 3, device='cpu'),
              flax_to_torch),
    'spsnet': (lambda: build_detector(zoo.tiny_spsnet_cfg(), 3,
                                      device='cpu'), flax_to_torch),
    'generator': (lambda: GenerateCenter(zoo.tiny_stability_model_cfg()),
                  generator_flax_to_torch),
    'pointrcnn': (lambda: build_detector(zoo.tiny_pointrcnn_cfg(), 3,
                                         device='cpu'), flax_to_torch),
    'pvrcnn': (lambda: build_detector(
        zoo.tiny_pvrcnn_cfg(PV_FINAL), 1, device='cpu', voxel_size=PV_VS,
        point_cloud_range=PV_PCR, final_grid_zyx=PV_FINAL), flax_to_torch),
}
# PV-RCNN's tree (tests/test_pvrcnn.py's tiny config, whose random voxels
# end on a (3, 2, 2) grid): a module that each new mapping rule places
PV_FINAL = (3, 2, 2)
PVRCNN_MODULES = [
    (('backbone_3d', 'conv3_b', 'Dense_0'), 'backbone_3d.conv3_b.0'),
    (('backbone_3d', 'conv_out', 'BatchNorm_0'), 'backbone_3d.conv_out.1'),
    (('backbone_2d', 'block0_down'), 'backbone_2d.blocks.0.1'),
    (('backbone_2d', 'block0_bn0'), 'backbone_2d.blocks.0.5'),
    (('backbone_2d', 'deblock0'), 'backbone_2d.deblocks.0.0'),
    (('dense_head', 'conv_dir_cls'), 'dense_head.conv_dir_cls'),
    (('pfe', 'raw_mlp_1', 'Dense_1'), 'pfe.SA_rawpoints.mlps.1.3'),
    (('pfe', 'x_conv4_mlp_0', 'BatchNorm_1'), 'pfe.SA_layers.x_conv4.mlps.0.4'),
    (('pfe', 'vsa_point_feature_fusion', 'Dense_0'),
     'pfe.vsa_point_feature_fusion.0'),
    (('point_head', 'cls_layers', 'Dense_0'), 'point_head.cls_layers.3'),
    (('roi_head', 'pool_mlp_0', 'Dense_1'),
     'roi_head.roi_grid_pool_layer.mlps.0.3'),
    (('roi_head', 'shared_fc', 'Dense_1'), 'roi_head.shared_fc_layer.4'),
    (('roi_head', 'shared_fc', 'BatchNorm_1'), 'roi_head.shared_fc_layer.5'),
]
# PointRCNN's trees: (flax module path, torch module name) of a Dense that
# each new mapping rule places (the FP decoder, the point head, the no-BN
# xyz-up MLP, the RoI SA layers and the towers behind their Dropout)
POINTRCNN_DENSES = [
    (('backbone_3d', 'fp_0', 'mlp', 'Dense_1'), 'backbone_3d.FP_modules.0.mlp.3'),
    (('point_head', 'box_layers', 'Dense_0'), 'point_head.box_layers.3'),
    (('roi_head', 'xyz_up', 'Dense_1'), 'roi_head.xyz_up_layer.2'),
    (('roi_head', 'merge', 'Dense_0'), 'roi_head.merge_down_layer.0'),
    (('roi_head', 'sa_2', 'mlp_0', 'Dense_1'), 'roi_head.SA_modules.2.mlps.0.3'),
    (('roi_head', 'cls_layers', 'Dense_0'), 'roi_head.cls_layers.4'),
    (('roi_head', 'reg_layers', 'SharedMLP_0', 'Dense_0'),
     'roi_head.reg_layers.0'),
]


@pytest.fixture(scope='module')
def variables_of():
    """The flax variables of a bridge kind, made once per module."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _jax_variables(kind)
        return jax.tree_util.tree_map(lambda a: a, cache[kind])
    return get


def _first_dense(kind, variables):
    """The first SA layer's first Dense kernel of a variable tree, and the
    name of the module it maps onto."""
    if kind == 'pvrcnn':
        return (variables['params']['pfe']['raw_mlp_0']['Dense_0']['kernel'],
                'pfe.SA_rawpoints.mlps.0.0')
    if kind == 'generator':
        return (variables['params']['surface_pw_feature']['mlp_0']['Dense_0']
                ['kernel'], 'surface_pw_feature.mlps.0.0')
    return (variables['params']['backbone_3d']['sa_0']['mlp_0']['Dense_0']
            ['kernel'], 'backbone_3d.SA_modules.0.mlps.0.0')


def _maps_every_key(kind, variables):
    build, convert = BRIDGES[kind]
    model = build()
    sd = convert(variables)
    assert set(sd) == set(model.state_dict())
    load_flax(model, variables, convert=convert)
    k, name = _first_dense(kind, variables)
    w = model.get_submodule(name).weight
    np.testing.assert_array_equal(w.detach().numpy(), k.T)
    if kind == 'spsnet':
        k = variables['params']['backbone_3d']['sf_extract']['conv_1'][
            'layer_1']['Dense_0']['kernel']
        w = model.backbone_3d.SF_extract.convs[1].layers[0].linear.weight
        np.testing.assert_array_equal(w.detach().numpy(), k.T)
    if kind == 'pvrcnn':
        for path, name in PVRCNN_MODULES:
            tree = variables['params']
            for key in path:
                tree = tree[key]
            module = model.get_submodule(name)
            leaf = 'scale' if 'scale' in tree else 'kernel'
            want = tree[leaf]
            if want.ndim == 2:
                want = want.T
            elif name.startswith('backbone_2d.deblocks'):
                want = want[::-1, ::-1].transpose(2, 3, 0, 1)
            elif want.ndim == 4:
                want = want.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(module.weight.detach().numpy(),
                                          want, err_msg=name)
    if kind == 'pointrcnn':
        for path, name in POINTRCNN_DENSES:
            tree = variables['params']
            for key in path:
                tree = tree[key]
            lin = model.get_submodule(name)
            np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                          tree['kernel'].T, err_msg=name)
            if 'bias' in tree:
                np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                              tree['bias'], err_msg=name)


def _module_tree(kind, variables):
    if kind == 'generator':
        return variables['params']['surface_pw_feature']
    if kind == 'pvrcnn':
        return variables['params']['pfe']
    return variables['params']['backbone_3d']['sa_0']


def _raises_on_unmapped(kind, variables, where):
    sa0 = _module_tree(kind, variables)
    mlp = 'raw_mlp_0' if kind == 'pvrcnn' else 'mlp_0'
    if where == 'flax_leaf':   # a BatchNorm leaf on a Dense module
        sa0[mlp]['Dense_0']['scale'] = np.ones(3, np.float32)
    elif where == 'flax_module':
        sa0['extra'] = {'Dense_0': {'kernel': np.ones((3, 3), np.float32)}}
    else:
        variables['cache'] = {}
    with pytest.raises(KeyError, match='unmapped|twice'):
        BRIDGES[kind][1](variables)


def _raises_on_unfilled(kind, variables):
    build, convert = BRIDGES[kind]
    del _module_tree(kind, variables)[
        'raw_mlp_0' if kind == 'pvrcnn' else 'mlp_0']['Dense_0']
    with pytest.raises(RuntimeError, match='Missing key'):
        load_flax(build(), variables, convert=convert)


def test_flax_to_torch_maps_every_key(variables_of):
    """Every flax leaf lands on a port parameter or buffer and back: the
    strict load accepts it and each Dense kernel arrives transposed."""
    _maps_every_key('iassd', variables_of('iassd'))


@pytest.mark.parametrize('kind', ['spsnet', 'generator'])
def test_flax_to_torch_maps_every_key_of_the_spsnet_trees(variables_of,
                                                          kind):
    """The same for the SPSNet detector (the surface DGCNN, the wider vote
    layer) and for the stability model, whose tree has its own converter."""
    _maps_every_key(kind, variables_of(kind))


def test_flax_to_torch_maps_every_key_of_the_pointrcnn_tree(variables_of):
    """The same for PointRCNN (PointNet2MSG with its FP decoder, the point
    head, the RoI head): every leaf lands where its rule places it."""
    _maps_every_key('pointrcnn', variables_of('pointrcnn'))


WHERE = ['flax_leaf', 'flax_module', 'collection']


@pytest.mark.parametrize('where', WHERE)
def test_flax_to_torch_raises_on_unmapped_flax_keys(variables_of, where):
    _raises_on_unmapped('iassd', variables_of('iassd'), where)


@pytest.mark.parametrize('where', WHERE)
@pytest.mark.parametrize('kind', ['spsnet', 'generator'])
def test_spsnet_trees_raise_on_unmapped_flax_keys(variables_of, kind,
                                                  where):
    _raises_on_unmapped(kind, variables_of(kind), where)


@pytest.mark.parametrize('where', WHERE + ['roi_head_module'])
def test_pointrcnn_tree_raises_on_unmapped_flax_keys(variables_of, where):
    variables = variables_of('pointrcnn')
    if where == 'roi_head_module':
        variables['params']['roi_head']['fc_extra'] = {
            'Dense_0': {'kernel': np.ones((3, 3), np.float32)}}
        with pytest.raises(KeyError, match='unmapped'):
            flax_to_torch(variables)
    else:
        _raises_on_unmapped('pointrcnn', variables, where)


def test_pointrcnn_tree_raises_on_a_port_key_left_unfilled(variables_of):
    _raises_on_unfilled('pointrcnn', variables_of('pointrcnn'))


def test_flax_to_torch_maps_every_key_of_the_pvrcnn_tree(variables_of):
    """The same for PV-RCNN (the sparse convs, the BEV convs and the
    flipped ConvTranspose, the anchor convs, the VSA, the point head, the
    RoI-grid head): every leaf lands where its rule places it."""
    _maps_every_key('pvrcnn', variables_of('pvrcnn'))


@pytest.mark.parametrize('where', WHERE + ['bev_module', 'sparse_module'])
def test_pvrcnn_tree_raises_on_unmapped_flax_keys(variables_of, where):
    variables = variables_of('pvrcnn')
    if where in ('bev_module', 'sparse_module'):
        top, name = ('backbone_2d', 'block0_extra') if where == \
            'bev_module' else ('backbone_3d', 'conv5')
        variables['params'][top][name] = {
            'kernel': np.ones((3, 3), np.float32)}
        with pytest.raises(KeyError, match='unmapped'):
            flax_to_torch(variables)
    else:
        _raises_on_unmapped('pvrcnn', variables, where)


def test_pvrcnn_tree_raises_on_a_port_key_left_unfilled(variables_of):
    _raises_on_unfilled('pvrcnn', variables_of('pvrcnn'))


def test_load_flax_raises_on_a_port_key_left_unfilled(variables_of):
    _raises_on_unfilled('iassd', variables_of('iassd'))


@pytest.mark.parametrize('kind', ['spsnet', 'generator'])
def test_spsnet_trees_raise_on_a_port_key_left_unfilled(variables_of, kind):
    _raises_on_unfilled(kind, variables_of(kind))


# the zoo's full configs that load a yaml of tools/cfgs
YAML_CFGS = {'voxel_rcnn_kitti': 'tools/cfgs/kitti_models/voxel_rcnn_car.yaml',
             'centerpoint_waymo': 'tools/cfgs/waymo_models/centerpoint.yaml',
             'pv_rcnn_plusplus_waymo':
             'tools/cfgs/waymo_models/pv_rcnn_plusplus.yaml',
             'pointpillar_kitti': 'tools/cfgs/kitti_models/pointpillar.yaml',
             'pointpillar_waymo':
             'tools/cfgs/waymo_models/pointpillar_1x.yaml',
             'centerpoint_pillar_waymo':
             'tools/cfgs/waymo_models/centerpoint_pillar_1x.yaml',
             'second_multihead_kitti':
             'tools/cfgs/kitti_models/second_multihead.yaml',
             'second_iou_kitti': 'tools/cfgs/kitti_models/second_iou.yaml',
             'second_multihead_nuscenes':
             'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml',
             'pointpillar_multihead_nuscenes':
             'tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml',
             'parta2_kitti': 'tools/cfgs/kitti_models/PartA2.yaml',
             'parta2_free_kitti': 'tools/cfgs/kitti_models/PartA2_free.yaml',
             'parta2_waymo': 'tools/cfgs/waymo_models/PartA2.yaml',
             'al_kitti': 'tools/cfgs/kitti_models/AL.yaml',
             'mlt_ssd_kitti': 'tools/cfgs/kitti_models/MLT_SSD.yaml',
             'mlt_ssd_nuscenes': 'tools/cfgs/nuscenes_models/MLT_SSD.yaml'}


@pytest.mark.parametrize('name', ['tiny', 'iassd_kitti', 'iassd_kitti_scaled',
                                  'tiny_spsnet', 'spsnet_kitti',
                                  'tiny_pointrcnn', 'pointrcnn_kitti',
                                  'pv_rcnn_kitti', 'second_kitti',
                                  'tiny_pvrcnn', 'tiny_voxelrcnn',
                                  'voxel_rcnn_kitti', 'centerpoint_waymo',
                                  'tiny_pvrcnnpp', 'pv_rcnn_plusplus_waymo',
                                  'pv_rcnn_plusplus_resnet',
                                  'tiny_pointpillar', 'tiny_centerpoint',
                                  'pointpillar_kitti', 'pointpillar_waymo',
                                  'centerpoint_pillar_waymo',
                                  'centerpoint_dyn_pillar_waymo',
                                  'second_multihead_kitti',
                                  'second_iou_kitti',
                                  'second_multihead_nuscenes',
                                  'pointpillar_multihead_nuscenes',
                                  'parta2_kitti', 'parta2_free_kitti',
                                  'parta2_waymo', 'tiny_parta2',
                                  'tiny_parta2_free', 'al_kitti',
                                  'mlt_ssd_kitti', 'mlt_ssd_nuscenes',
                                  'tiny_al'])
def test_config_copies_match_the_jax_package(name):
    """The port's own config loader and zoo give the JAX package's configs
    (``_BASE_CONFIG_`` resolution included for IA-SSD.yaml, SPSNet.yaml
    and pointrcnn.yaml)."""
    def build(z):
        if name == 'tiny':
            return z.tiny_iassd_cfg()
        if name == 'tiny_pvrcnn':
            return z.tiny_pvrcnn_cfg(PV_FINAL) if z is zoo else \
                pvrcnn_tiny_cfg(PV_FINAL)
        if name == 'tiny_pvrcnnpp':
            return z.tiny_pvrcnnpp_cfg(PV_FINAL) if z is zoo else \
                pvrcnnpp_tiny_cfg(PV_FINAL)
        if name == 'pv_rcnn_plusplus_resnet':
            return zoo.pv_rcnn_plusplus_waymo_cfg(resnet=True) if z is zoo \
                else z.load_yaml_cfg('tools/cfgs/waymo_models/'
                                     'pv_rcnn_plusplus_resnet.yaml')
        if name in ('tiny_pointpillar', 'tiny_centerpoint'):
            return getattr(z, f'{name}_cfg')()
        if name == 'centerpoint_dyn_pillar_waymo':
            return zoo.centerpoint_pillar_waymo_cfg(dynamic=True) \
                if z is zoo else z.load_yaml_cfg(
                    'tools/cfgs/waymo_models/centerpoint_dyn_pillar_1x.yaml')
        if name == 'tiny_parta2':
            return z.tiny_parta2_cfg(PV_FINAL) if z is zoo else \
                parta2_tiny_cfg(PV_FINAL)
        if name == 'tiny_al':
            return z.tiny_al_cfg() if z is zoo else alnet_tiny_cfg()
        if name == 'tiny_parta2_free':
            return z.tiny_parta2_free_cfg() if z is zoo else \
                parta2_free_tiny_cfg()
        if name == 'tiny_voxelrcnn':
            return z.tiny_voxelrcnn_cfg(PV_FINAL) if z is zoo else \
                voxelrcnn_tiny_cfg(PV_FINAL)
        if name in YAML_CFGS:
            return getattr(z, f'{name}_cfg')() if z is zoo else \
                z.load_yaml_cfg(YAML_CFGS[name])
        if name in ('pv_rcnn_kitti', 'second_kitti'):
            return getattr(z, f'{name[:-6]}_kitti_cfg')() if z is zoo else \
                z.load_yaml_cfg(f'tools/cfgs/kitti_models/{name[:-6]}.yaml')
        if name == 'tiny_pointrcnn':
            return z.tiny_pointrcnn_cfg()
        if name == 'pointrcnn_kitti':
            return z.pointrcnn_kitti_cfg() if z is zoo else \
                z.load_yaml_cfg('tools/cfgs/kitti_models/pointrcnn.yaml')
        if name == 'iassd_kitti':
            return z.iassd_kitti_cfg()
        if name == 'tiny_spsnet':
            return z.tiny_spsnet_cfg()
        if name == 'spsnet_kitti':
            return z.spsnet_kitti_cfg() if z is zoo else \
                z.load_yaml_cfg('tools/cfgs/kitti_models/SPSNet.yaml')
        return z.scale_sa_config(z.iassd_kitti_cfg().MODEL, 8)
    assert json.dumps(build(zoo), sort_keys=True) == \
        json.dumps(build(jax_zoo), sort_keys=True)


def test_synthetic_scans_match_the_jax_package():
    np.testing.assert_array_equal(synthetic_scan_batch(3, 2, 1000),
                                  jax_scan_batch(3, 2, 1000))


def test_sparse_plan_copy_matches_the_jax_package():
    """Each function of the port's copy of ``sparse_plan.py`` against the
    original on random voxels: subm and strided tables, the transposed
    (UNet) table, the final grid."""
    rng = np.random.default_rng(4)
    grid = (12, 20, 18)
    coords = np.unique(np.stack([rng.integers(0, g, 90) for g in grid], 1),
                       axis=0)
    V = 96
    pad = np.zeros((V, 3), np.int64)
    pad[:len(coords)] = coords
    valid = np.arange(V) < len(coords)
    np.testing.assert_array_equal(sparse_plan.subm_table(pad, valid, grid),
                                  jax_plan.subm_table(pad, valid, grid))
    args = (pad, valid, grid, (2, 2, 2), (1, 1, 1), (3, 3, 3))
    got = sparse_plan.spconv_down(*args, max_out=V)
    want = jax_plan.spconv_down(*args, max_out=V)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    np.testing.assert_array_equal(
        sparse_plan.spconv_up_table(pad, valid, grid, got[0], got[1], got[3],
                                    (2, 2, 2), (1, 1, 1), (3, 3, 3)),
        jax_plan.spconv_up_table(pad, valid, grid, want[0], want[1], want[3],
                                 (2, 2, 2), (1, 1, 1), (3, 3, 3)))
    assert sparse_plan.plan_final_grid((41, 1600, 1408)) == \
        jax_plan.plan_final_grid((41, 1600, 1408)) == (2, 200, 176)
