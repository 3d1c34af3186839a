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
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.utils.synthetic import synthetic_scan_batch as jax_scan_batch
from spsnet_torch import zoo
from spsnet_torch.models import build_detector
from spsnet_torch.ops import _build
from spsnet_torch.ops.grouping import ball_query_multi_kernel
from spsnet_torch.ops.sampling import farthest_point_sample_kernel
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import flax_to_torch, load_flax

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / 'spsnet_torch').rglob('*.py')) + \
    ['chip_smoke.py']
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
from spsnet_torch.ops import _build
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.zoo import tiny_iassd_cfg
model = build_detector(tiny_iassd_cfg(), 3, device='cpu')
with torch.no_grad():
    out = model({'points': torch.from_numpy(synthetic_scan_batch(0, 1, 256))})
print(json.dumps({
    'jax_modules': sorted(m for m in sys.modules
                          if m.split('.')[0] in ('jax', 'flax', 'spsnet_tpu')),
    'processes': len(started), 'libraries': len(_build._LIBS),
    'boxes': list(out['batch_box_preds'].shape)}))
'''


def test_import_and_cpu_forward_load_no_jax_and_build_nothing():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(ROOT)
    res = subprocess.run([sys.executable, '-c', _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {'jax_modules': [], 'processes': 0, 'libraries': 0,
                   'boxes': [1, 16, 7]}


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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.find_nvcc()


def test_build_dir_is_keyed_by_sources_and_ignored_by_git():
    d = _build.build_dir()
    assert d.parent == ROOT / 'build' / 'spsnet_torch' and len(d.name) == 16
    assert 'build/' in (ROOT / '.gitignore').read_text().split()


@pytest.fixture(scope='module')
def tiny_variables():
    points = synthetic_scan_batch(0, 1, 256)
    model = jax_build_detector(jax_zoo.tiny_iassd_cfg(), num_class=3)
    variables = jax.jit(lambda key, pts: model.init(
        key, {'points': pts}, train=False))(jax.random.PRNGKey(0), points)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def test_flax_to_torch_maps_every_key(tiny_variables):
    """Every flax leaf lands on a port parameter or buffer and back: the
    strict load accepts it and each Dense kernel arrives transposed."""
    model = build_detector(zoo.tiny_iassd_cfg(), 3, device='cpu')
    sd = flax_to_torch(tiny_variables)
    assert set(sd) == set(model.state_dict())
    load_flax(model, tiny_variables)
    k = tiny_variables['params']['backbone_3d']['sa_0']['mlp_0']['Dense_0'][
        'kernel']
    w = model.backbone_3d.SA_modules[0].mlps[0][0].weight
    np.testing.assert_array_equal(w.detach().numpy(), k.T)


@pytest.mark.parametrize('where', ['flax_leaf', 'flax_module',
                                   'collection'])
def test_flax_to_torch_raises_on_unmapped_flax_keys(tiny_variables, where):
    variables = jax.tree_util.tree_map(lambda a: a, tiny_variables)
    sa0 = variables['params']['backbone_3d']['sa_0']
    if where == 'flax_leaf':   # a BatchNorm leaf on a Dense module
        sa0['mlp_0']['Dense_0']['scale'] = np.ones(3, np.float32)
    elif where == 'flax_module':
        sa0['extra'] = {'Dense_0': {'kernel': np.ones((3, 3), np.float32)}}
    else:
        variables['cache'] = {}
    with pytest.raises(KeyError, match='unmapped|twice'):
        flax_to_torch(variables)


def test_load_flax_raises_on_a_port_key_left_unfilled(tiny_variables):
    variables = jax.tree_util.tree_map(lambda a: a, tiny_variables)
    del variables['params']['backbone_3d']['sa_0']['mlp_0']['Dense_0']
    model = build_detector(zoo.tiny_iassd_cfg(), 3, device='cpu')
    with pytest.raises(RuntimeError, match='Missing key'):
        load_flax(model, variables)


@pytest.mark.parametrize('name', ['tiny', 'iassd_kitti', 'iassd_kitti_scaled'])
def test_config_copies_match_the_jax_package(name):
    """The port's own config loader and zoo give the JAX package's configs
    (``_BASE_CONFIG_`` resolution included for IA-SSD.yaml)."""
    def build(z):
        if name == 'tiny':
            return z.tiny_iassd_cfg()
        if name == 'iassd_kitti':
            return z.iassd_kitti_cfg()
        return z.scale_sa_config(z.iassd_kitti_cfg().MODEL, 8)
    assert json.dumps(build(zoo), sort_keys=True) == \
        json.dumps(build(jax_zoo), sort_keys=True)


def test_synthetic_scans_match_the_jax_package():
    np.testing.assert_array_equal(synthetic_scan_batch(3, 2, 1000),
                                  jax_scan_batch(3, 2, 1000))
