"""The rest of the point family against the JAX package on the CPU, as
``test_torch_point_family.py`` (which says how): the tiny ry-FPS and
shared-gather models, and IA-SSD.yaml at full width (NPOINT_LIST cut by
``FACTOR``) with ds-FPS and ry-FPS. Split from that file so that ``--dist
loadfile`` spreads the runs over the workers.
"""
import pytest
import torch

from tests.point_family_cases import (VARIANTS,
                                      check_features_and_predictions,
                                      check_nms, check_sampled_points,
                                      run_both)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

RUNS = [('ry', 'tiny'), ('msg_shared', 'tiny'), ('ds', 'full'),
        ('ry', 'full')]
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
