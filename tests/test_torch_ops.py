"""The port's sampling and grouping ops against the JAX package on the CPU.

Inputs come from numpy with fixed seeds and go through both packages; the
port's ops run their plain PyTorch versions here (CPU tensors), which are
the versions its CUDA kernels are held to on the card (``chip_smoke.py``).
Indices must match exactly; float tolerances are stated per test.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.models import samplers as jax_samplers
from spsnet_tpu.ops import grouping as jg
from spsnet_tpu.ops import sampling as js
from spsnet_tpu.ops.pallas import d2 as jd2
from spsnet_tpu.ops.pallas import fps as jfps
from spsnet_torch import ops
from spsnet_torch.models import samplers
from spsnet_torch.ops import grouping as tg
from spsnet_torch.ops import sampling as ts
from spsnet_torch.utils.synthetic import synthetic_scan_batch

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_xyz(seed, b, n):
    return synthetic_scan_batch(seed, b, n)[..., :3].copy()


@pytest.mark.parametrize('B,N,M,seed', [(3, 300, 64, 0), (2, 197, 32, 1),
                                        (2, 640, 128, 2)])
def test_fps_matches_jax_xla_and_pallas(B, N, M, seed):
    """Exact indices against the XLA loop and both Pallas FPS kernels in
    interpret mode (K1a all-batch and K1b per-batch grid), incl. N % 128 != 0."""
    xyz = np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)
    got = ops.farthest_point_sample(_t(xyz), M).numpy()
    x = jnp.asarray(xyz)
    np.testing.assert_array_equal(got, np.asarray(js.farthest_point_sample(x, M)))
    np.testing.assert_array_equal(
        got, np.asarray(jfps._fps_pallas_allbatch(x, M, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jfps._fps_pallas_grid(x, M, interpret=True)))
    assert got.max() < N


# each experimental Pallas entry (K5a-c) and its counterpart in the port
EXPERIMENTAL_FPS = {
    'farthest_point_sample_pallas_batched': 'farthest_point_sample_batched',
    '_fps_pallas_allbatch_v2': 'farthest_point_sample_hier_argmax',
    'farthest_point_sample_pallas_batched2d': 'farthest_point_sample_batched',
}


@pytest.mark.parametrize('variant', sorted(EXPERIMENTAL_FPS))
@pytest.mark.parametrize('B,N,M,seed', [(3, 300, 64, 0), (2, 197, 32, 1)])
def test_fps_matches_the_experimental_pallas_variants(variant, B, N, M, seed):
    """K5a-c compute K1's function through other TPU layouts and are never
    dispatched; each is held to its own port entry (here its plain version;
    on the card the exact FPS kernel ``csrc/fps.cu``) in interpret mode, and
    the port's FPS gives their indices too."""
    xyz = np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)
    want = np.asarray(getattr(jfps, variant)(jnp.asarray(xyz), M,
                                             interpret=True))
    entry = getattr(ts, EXPERIMENTAL_FPS[variant])
    np.testing.assert_array_equal(entry(_t(xyz), M).numpy(), want)
    np.testing.assert_array_equal(
        ops.farthest_point_sample(_t(xyz), M).numpy(), want)


def test_fps_matches_jax_on_a_kitti_scan():
    """KITTI-range coordinates (up to 70 m), where distances are large and
    near-ties in the running max are likelier."""
    xyz = _scan_xyz(0, 2, 2048)
    got = ops.farthest_point_sample(_t(xyz), 512).numpy()
    want = np.asarray(js.farthest_point_sample(jnp.asarray(xyz), 512))
    np.testing.assert_array_equal(got, want)


def test_fps_valid_mask_matches_jax():
    """Masked FPS: seeded at the first valid point, invalid points never
    picked while a valid one remains; an all-invalid row gives zeros."""
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(3, 301, 3)).astype(np.float32) * 10
    mask = rng.uniform(size=(3, 301)) > 0.4
    mask[0, :7] = False
    mask[2] = False
    got = ops.farthest_point_sample(_t(xyz), 50, valid_mask=_t(mask)).numpy()
    want = np.asarray(js.farthest_point_sample(
        jnp.asarray(xyz), 50, valid_mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == np.argmax(mask[0]) >= 7
    assert mask[1][got[1]].all() and (got[2] == 0).all()


def test_fps_rejects_bad_npoint():
    with pytest.raises(ValueError):
        ops.farthest_point_sample(torch.zeros(1, 8, 3), 9)


def test_calc_square_dist_matches_jax():
    """The |a|^2 + |b|^2 - 2ab form: fp32 matmuls summed in another order,
    so within 1e-5 relative / 1e-3 absolute at 10 m coordinates."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(2, 50, 3)).astype(np.float32) * 10
    b = rng.normal(size=(2, 40, 3)).astype(np.float32) * 10
    got = ops.calc_square_dist(_t(a), _t(b)).numpy()
    want = np.asarray(js.calc_square_dist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_pairwise_d2_matches_pallas_d2_and_exact_form():
    """Port diff-form d2 vs the Pallas K2 kernel (interpret mode) within its
    bf16 store (8 bits: rtol 2^-8), and bit for bit vs the JAX CPU diff
    form that the exact ball query compares against r^2."""
    rng = np.random.default_rng(2)
    ctr = rng.uniform(-35, 35, (2, 256, 3)).astype(np.float32)
    xyz = rng.uniform(-35, 35, (2, 512, 3)).astype(np.float32)
    got = tg.pairwise_d2(_t(ctr), _t(xyz)).numpy()
    pallas = np.asarray(jd2.ball_d2_bf16(jnp.asarray(ctr), jnp.asarray(xyz),
                                         interpret=True), dtype=np.float64)
    np.testing.assert_allclose(got, pallas, rtol=2 ** -8, atol=1e-6)
    exact = np.asarray(jg._query_d2(jnp.asarray(ctr), jnp.asarray(xyz)))
    np.testing.assert_array_equal(got, exact)


def _lattice_case():
    """Points on a 0.5 m lattice and centers on lattice nodes: many points
    lie exactly on the r = 0.5 / 1.0 spheres, where strict d2 < r^2
    decides; the far centers have empty balls."""
    g = np.arange(-2, 2.5, 0.5, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(1, -1, 3)
    rng = np.random.default_rng(5)
    pts = pts[:, rng.permutation(pts.shape[1])]
    ctr = np.concatenate([pts[:, :20], np.full((1, 4, 3), 50.0, np.float32)],
                         axis=1)
    return pts, ctr, 4


def _random_case():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-3, 3, (2, 500, 3)).astype(np.float32)
    ctr = np.concatenate([pts[:, :60],
                          rng.uniform(20, 30, (2, 4, 3)).astype(np.float32)],
                         axis=1)
    return pts, ctr, 4


def _scan_case():
    pts = _scan_xyz(1, 2, 2048)
    idx = np.asarray(js.farthest_point_sample(jnp.asarray(pts), 256))
    return pts, np.take_along_axis(pts, idx[..., None], 1), 0


@pytest.mark.parametrize('case,radii,nsamples', [
    (_lattice_case, (0.5, 1.0), (4, 16)),
    (_random_case, (0.2, 0.8), (4, 8)),
    (_scan_case, (0.2, 0.8), (16, 32)),
    (_scan_case, (1.6, 4.8), (16, 32)),
])
def test_ball_query_multi_matches_jax(case, radii, nsamples):
    """Exact indices vs JAX ball_query_multi and ball_query: first-k hits in
    index order, first-hit padding, index 0 for an empty ball."""
    pts, ctr, n_far = case()
    got = ops.ball_query_multi(radii, nsamples, _t(pts), _t(ctr))
    want = jg.ball_query_multi(radii, nsamples, jnp.asarray(pts),
                               jnp.asarray(ctr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for r, s, g in zip(radii, nsamples, got):
        one = ops.ball_query(r, s, _t(pts), _t(ctr)).numpy()
        np.testing.assert_array_equal(one, g.numpy())
        np.testing.assert_array_equal(
            one, np.asarray(jg.ball_query(r, s, jnp.asarray(pts),
                                          jnp.asarray(ctr))))
    # the far centers (the last n_far) have empty balls
    assert (got[0].numpy()[:, ctr.shape[1] - n_far:] == 0).all()


def test_grouping_ops_match_jax():
    """gather/group/query_and_group/group_all are exact gathers; max pooling
    is exact, the mean within 1e-6."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-2, 2, (2, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 128, 5)).astype(np.float32)
    ctr = pts[:, :16].copy()
    idx = np.asarray(jg.ball_query(0.8, 8, jnp.asarray(pts), jnp.asarray(ctr)))
    ti = _t(idx.astype(np.int64))
    J = jnp.asarray
    np.testing.assert_array_equal(
        ops.gather_points(_t(feats), ti[:, :, 0]).numpy(),
        np.asarray(jg.gather_points(J(feats), J(idx[:, :, 0]))))
    np.testing.assert_array_equal(
        ops.group_points(_t(feats), ti).numpy(),
        np.asarray(jg.group_points(J(feats), J(idx))))
    for use_xyz in (True, False):
        g, _ = ops.query_and_group(0.8, 8, _t(pts), _t(ctr), _t(feats),
                                   use_xyz=use_xyz)
        w, _ = jg.query_and_group(0.8, 8, J(pts), J(ctr), J(feats),
                                  use_xyz=use_xyz)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    g, _ = ops.query_and_group(0.8, 8, _t(pts), _t(ctr))
    w, _ = jg.query_and_group(0.8, 8, J(pts), J(ctr))
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for use_xyz in (True, False):
        np.testing.assert_array_equal(
            ops.group_all(_t(pts), _t(feats), use_xyz).numpy(),
            np.asarray(jg.group_all(J(pts), J(feats), use_xyz)))
    h = rng.normal(size=(2, 16, 8, 6)).astype(np.float32)
    valid = rng.uniform(size=(2, 16, 8)) > 0.3
    valid[..., 0] = True
    for v in (None, valid):
        tv = None if v is None else _t(v)
        jv = None if v is None else J(v)
        np.testing.assert_array_equal(
            ops.masked_pool(_t(h), tv, 'max_pool').numpy(),
            np.asarray(jg.masked_pool(J(h), jv, 'max_pool')))
        np.testing.assert_allclose(
            ops.masked_pool(_t(h), tv, 'avg_pool').numpy(),
            np.asarray(jg.masked_pool(J(h), jv, 'avg_pool')), atol=1e-6)


def test_ctr_aware_ties_take_the_lowest_index():
    """sigmoid saturates to exactly 1.0 in fp32 for logits above ~17, so
    trained weights give real ties; both packages must keep jax.lax.top_k's
    order (lowest index first), which torch.topk does not promise."""
    rng = np.random.default_rng(8)
    logits = rng.choice(np.float32([-3.0, 0.5, 18.0, 25.0, 40.0]),
                        size=(3, 257, 3))
    got = samplers.sample_ctr_aware(_t(logits), 100).numpy()
    want = np.asarray(jax_samplers.sample_ctr_aware(jnp.asarray(logits), 100))
    np.testing.assert_array_equal(got, want)
    scores = 1 / (1 + np.exp(-logits.max(-1).astype(np.float64)))
    saturated = np.flatnonzero(np.float32(scores[0]) == np.float32(1.0))
    assert len(saturated) > 100  # the whole top-100 is one tie
    np.testing.assert_array_equal(got[0], saturated[:100])
