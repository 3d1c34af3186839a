"""The rest of the point family in the port against the JAX package on the
CPU: tiny IA-SSD models whose sampling chain takes F-FPS and FS with
dilated grouping, Rand, ds-FPS or ry-FPS, or whose grouping shares one
gather across scales (``msg_shared``), serving two scans (this file: F-FPS
and FS, Rand, ds-FPS; ``test_torch_point_family_more.py`` and
``_configs.py`` the others, and IA-SSD.yaml at full width with each
variant, NPOINT_LIST cut by ``FACTOR``); and each variant of IA-SSD.yaml
built from its experiment config.

The JAX model is initialised from a fixed key; its flax variables go
through the weight bridge into the port's model (the variants add no
parameter); both run the same numpy scans. JAX's F-FPS picks and Rand
permutations are captured and fed to the port (``tests/point_family_
cases.py``): the port's own F-FPS picks must equal JAX's, or lie within
the rounding slack of the distances (then JAX's are replayed); Rand's
permutation cannot be drawn alike in torch. Sampled points and NMS
outputs must be identical; floats within ``test_torch_iassd.py``'s
``RTOL``/``ATOL``.
"""
import pytest
import torch

from spsnet_torch import zoo
from spsnet_torch.models import build_detector_from_cfg
from tests.point_family_cases import (VARIANTS, apply_variant,
                                      check_features_and_predictions,
                                      check_nms, check_sampled_points,
                                      run_both)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

RUNS = [('fs', 'tiny'), ('rand', 'tiny'), ('ds', 'tiny')]
_RUNS = {}


@pytest.fixture(params=RUNS, ids=lambda p: f'{p[0]}-{p[1]}', scope='module')
def run(request):
    """The run of one (variant, size): two scans of 512 points (tiny) or
    2048 (full width), the seed the variant's place in VARIANTS."""
    name, size = request.param
    if request.param not in _RUNS:
        _RUNS.clear()
        _RUNS[request.param] = run_both(
            name, size, seed=VARIANTS.index(name),
            n_points=512 if size == 'tiny' else 2048)
    return _RUNS[request.param]


def test_sampled_points_and_picks_are_identical(run):
    check_sampled_points(run)


def test_features_and_predictions_within_tolerance(run):
    check_features_and_predictions(run)


def test_nms_outputs_match(run):
    check_nms(run)


@pytest.mark.parametrize('name', VARIANTS)
def test_each_configuration_builds_from_its_experiment_config(name):
    """``build_detector_from_cfg`` builds IA-SSD.yaml with each variant at
    full width on the CPU; the variants add no parameter to IA-SSD's."""
    cfg = zoo.iassd_kitti_cfg()
    _, shared = apply_variant(cfg.MODEL, name)
    model = build_detector_from_cfg(cfg, device='cpu', msg_shared=shared)
    base = build_detector_from_cfg(zoo.iassd_kitti_cfg(), device='cpu')
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in base.state_dict().items()}
    layers = model.backbone_3d.SA_modules
    assert [m.msg_shared for m in layers[:4]] == \
        [shared and bool(m.radii) for m in layers[:4]]
    assert [m.dilated_group for m in layers[:3]] == [name == 'fs'] * 3
