"""The port's rotated BEV IoU, NMS and post-processing against the JAX
package on the CPU. Indices and counts must match exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.models.detectors.detector3d import \
    class_agnostic_nms_batch as jax_nms_batch
from spsnet_tpu.ops import boxes as jb
from spsnet_torch import ops
from spsnet_torch.models.detectors.detector3d import class_agnostic_nms_batch
from spsnet_torch.ops.boxes import topk_desc

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)


def _boxes(rng, *lead, span=10.0):
    b = np.zeros(lead + (7,), np.float32)
    b[..., 0:2] = rng.uniform(-span, span, lead + (2,))
    b[..., 2] = rng.uniform(-2, 0, lead)
    b[..., 3:6] = rng.uniform(0.5, 4.5, lead + (3,))
    b[..., 6] = rng.uniform(-np.pi, np.pi, lead)
    return b


def test_iou_bev_matches_jax():
    """Rotated BEV IoU within 1e-5 (the same fp32 arithmetic, the sums in
    another order), incl. axis-aligned pairs. Bit-identical boxes are left
    out: the boundary integration double-counts their shared edges in both
    packages (``spsnet_tpu/ops/boxes.py:118-121``)."""
    rng = np.random.default_rng(0)
    a = _boxes(rng, 48, span=4.0)
    b = _boxes(rng, 40, span=4.0)
    b[5:8, 6] = 0.0
    got = ops.boxes_iou_bev_fast(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
    want = np.asarray(jb.boxes_iou_bev_fast(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got > 0).mean() > 0.1  # the case has real overlaps


@pytest.mark.parametrize('thresh,seed', [(0.01, 1), (0.3, 2), (0.7, 3)])
def test_nms_bev_matches_jax(thresh, seed):
    """Exact kept indices and counts per frame, with a validity mask and
    tied scores (lowest index first, as jax.lax.top_k)."""
    rng = np.random.default_rng(seed)
    B, K = 3, 96
    boxes = _boxes(rng, B, K, span=6.0)
    scores = np.round(rng.uniform(0, 1, (B, K)), 1).astype(np.float32)
    valid = rng.uniform(size=(B, K)) > 0.2
    keep, num = ops.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                            thresh, pre_maxsize=64, post_maxsize=20,
                            valid=torch.from_numpy(valid))
    for f in range(B):
        wk, wn = jb.nms_bev(jnp.asarray(boxes[f]), jnp.asarray(scores[f]),
                            thresh, pre_maxsize=64, post_maxsize=20,
                            valid=jnp.asarray(valid[f]))
        np.testing.assert_array_equal(keep[f].numpy(), np.asarray(wk))
        assert int(num[f]) == int(wn)


def test_topk_desc_takes_the_lowest_index_among_ties():
    s = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0, 0.5]])
    vals, idx = topk_desc(s, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 5]]
    assert vals.tolist() == [[1.0, 1.0, 1.0, 0.5, 0.5]]


def test_class_agnostic_nms_batch_matches_jax():
    """Fixed-shape post-processing: exact indices, counts and labels; boxes
    and scores are gathers of the same inputs (scores through sigmoid,
    within 1e-6)."""
    rng = np.random.default_rng(4)
    B, M = 3, 128
    boxes = _boxes(rng, B, M, span=8.0)
    cls = rng.normal(0, 2, (B, M, 3)).astype(np.float32)
    kw = dict(score_thresh=0.1, nms_thresh=0.01, nms_pre=96, nms_post=32)
    got = class_agnostic_nms_batch(torch.from_numpy(boxes),
                                   torch.from_numpy(cls), **kw)
    want = jax_nms_batch(jnp.asarray(boxes), jnp.asarray(cls), **kw)
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(got['boxes'].numpy(),
                                  np.asarray(want['boxes']))
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), atol=1e-6)
    assert got['boxes'].shape == (B, 32, 7) and int(got['count'].min()) > 0
