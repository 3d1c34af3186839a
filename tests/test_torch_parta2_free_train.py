"""The tiny PartA2_free (``zoo.tiny_parta2_free_cfg``: a PointRCNN config
over UNetV2, built as PartA2FreeNet) against the JAX package on the CPU:
its eval forward and ``post_processing`` and one ``adam_onecycle`` step
through each package's ``make_train_step``, as
``tests/test_torch_parta2_train.py`` holds the tiny PartA2 (its helpers,
batch and tolerances).
"""
import pytest

from tests.test_torch_parta2_train import hold_step, make_step, serve_case


def test_tiny_parta2_free_serves_as_jax():
    """``serve_case``: the proposals are the part head's boxes of every
    voxel row, the padded rows' one box among them."""
    serve_case('parta2_free')


@pytest.fixture(scope='module')
def free_step():
    return make_step('parta2_free')


def test_tiny_parta2_free_train_step_matches_jax(free_step):
    """``hold_step``: one step of the tiny PartA2_free (its box branch's
    loss among the terms) against JAX's."""
    hold_step(free_step)
