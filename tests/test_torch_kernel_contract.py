"""What the FPS, ball-query and min-distance kernels must match, pinned to
the JAX package.

The card kernels (``csrc/fps.cu``, ``csrc/ball_query.cu``,
``csrc/seed_min.cu``) are held index for index, or bit for bit, to the
port's plain versions (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Here, on the CPU, those plain versions are held to the JAX package's CPU
functions on the inputs where a kernel that splits a row (across the CTAs
of a cluster, or across tiles and warps) goes wrong first: clouds whose
maxima tie (a lattice, a cloud repeated so that equal points lie far apart
in index order), masks that leave one or no valid point, radii in
descending order, N that is no multiple of 4 (a row that is not 16-byte
aligned), and for the min distance to the seeds one seed, seed counts off
a split, one point, a point past a tile, and seeds that are points.
Inputs are made with numpy from fixed seeds; indices must be equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.ops import grouping as jg
from spsnet_tpu.ops import sampling as js
from spsnet_tpu.ops.pallas import fps as jfps
from spsnet_torch.ops import grouping as tg
from spsnet_torch.ops import sampling as ts


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lattice(b, n, seed):
    """n points of a 0.5 m lattice (exact in fp32), in index order of a
    random offset per row: equal distances to any pick recur all along the
    row, so the lowest index must win every tie."""
    side = int(np.ceil(n ** (1 / 3)))
    g = np.arange(side, dtype=np.float32) * 0.5
    pts = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)[:n]
    rng = np.random.default_rng(seed)
    return np.stack([np.roll(pts, rng.integers(n), axis=0)
                     for _ in range(b)]).astype(np.float32)


def _repeated(b, n, copies, seed):
    """``copies`` copies of one random cloud end to end (the last one cut):
    point i equals point i + n // copies, so a tied maximum lies in every
    part of the row."""
    rng = np.random.default_rng(seed)
    unique = rng.normal(size=(b, -(-n // copies), 3)).astype(np.float32) * 10
    return np.concatenate([unique] * copies, axis=1)[:, :n]


CLOUDS = {'lattice': lambda b, n: _lattice(b, n, n),
          'repeated': lambda b, n: _repeated(b, n, 4, n),
          'repeated16': lambda b, n: _repeated(b, n, 16, n + 1)}


@pytest.mark.parametrize('cloud', sorted(CLOUDS))
@pytest.mark.parametrize('B,N,M', [(2, 512, 96), (3, 1001, 64)])
def test_plain_fps_breaks_ties_as_jax_does(cloud, B, N, M):
    """Tied maxima in different parts of the row: the plain FPS (the
    kernel's reference) picks what the JAX XLA loop and the Pallas K1a
    kernel (interpret mode) pick."""
    xyz = CLOUDS[cloud](B, N)
    got = ts.farthest_point_sample_plain(_t(xyz), M).numpy()
    x = jnp.asarray(xyz)
    np.testing.assert_array_equal(
        got, np.asarray(js.farthest_point_sample(x, M)))
    np.testing.assert_array_equal(
        got, np.asarray(jfps._fps_pallas_allbatch(x, M, interpret=True)))


@pytest.mark.parametrize('mask', ['none_valid', 'one_valid', 'last_valid',
                                  'random'])
@pytest.mark.parametrize('cloud', ['lattice', 'repeated'])
def test_plain_masked_fps_matches_jax(mask, cloud):
    """Masks: no valid point (every pick 0), one valid point (every pick
    it), only the last point valid, and a random mask on a tie-heavy cloud."""
    B, N, M = 2, 777, 40
    xyz = CLOUDS[cloud](B, N)
    rng = np.random.default_rng(len(mask))
    vm = {'none_valid': np.zeros((B, N), bool),
          'one_valid': np.arange(N)[None].repeat(B, 0) == 300,
          'last_valid': np.arange(N)[None].repeat(B, 0) == N - 1,
          'random': rng.uniform(size=(B, N)) > 0.6}[mask]
    got = ts.farthest_point_sample_plain(_t(xyz), M, _t(vm)).numpy()
    want = np.asarray(js.farthest_point_sample(
        jnp.asarray(xyz), M, valid_mask=jnp.asarray(vm)))
    np.testing.assert_array_equal(got, want)
    if mask == 'one_valid':
        assert (got == 300).all()
    if mask == 'none_valid':
        assert (got == 0).all()


@pytest.mark.parametrize('cloud', ['lattice', 'repeated16'])
def test_plain_seeded_fps_breaks_ties_as_jax_does(cloud):
    """Seeded FPS on a tie-heavy cloud, seeds spread over the whole row:
    the plain completion against ``farthest_point_sample_seeded`` in
    interpret mode."""
    B, N, npoint, k0 = 2, 1000, 384, 256
    xyz = CLOUDS[cloud](B, N)
    rng = np.random.default_rng(9)
    seed_idx = np.stack([np.sort(rng.permutation(N)[:k0]) for _ in range(B)])
    got = ts.farthest_point_sample_seeded(
        _t(xyz), npoint, k0, _t(seed_idx.astype(np.int64))).numpy()
    want = np.asarray(jfps.farthest_point_sample_seeded(
        jnp.asarray(xyz), npoint, k0, jnp.asarray(seed_idx, jnp.int32),
        interpret=True))
    np.testing.assert_array_equal(got, want)


def _separately_rounded_min(xyz, seeds):
    """min over the seeds of (dx*dx + dy*dy) + dz*dz in numpy fp32, each
    product and sum rounded on its own."""
    d = xyz[:, :, None, :] - seeds[:, None, :, :]
    return ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2]).min(axis=-1)


@pytest.mark.parametrize('B,N,k0,seeds', [
    (2, 300, 1, 'random'),       # one seed
    (2, 640, 385, 'random'),     # one seed past 8 shares of 48
    (3, 333, 7, 'random'),       # k0 % 4 != 0
    (3, 1, 5, 'random'),         # one point
    (2, 1025, 64, 'random'),     # one point past 2 tiles of 128 x 4
    (1, 2049, 33, 'random'),     # one point past 4 such tiles
    (2, 1024, 256, 'points'),    # seeds that are points: d2 = +0 there
    (1, 2048, 384, 'random'),    # three seed blocks of the Pallas kernel
])
def test_plain_seed_min_d2_is_the_separately_rounded_min(B, N, k0, seeds):
    """K3's plain version (the kernel's reference) at the edges of a tiling
    that splits seeds and points: bit for bit the separately rounded numpy
    form, and where N and k0 are multiples of 128 (what the Pallas kernel
    takes) within 2 ulp of ``_seed_min_d2`` in interpret mode (XLA:CPU
    contracts the sum into FMAs)."""
    rng = np.random.default_rng(N + k0)
    xyz = (rng.normal(size=(B, N, 3)) * 20).astype(np.float32)
    if seeds == 'points':
        s = np.ascontiguousarray(xyz[:, ::N // k0][:, :k0])
    else:
        s = (rng.normal(size=(B, k0, 3)) * 20).astype(np.float32)
    got = ts.seed_min_d2(_t(xyz), _t(s)).numpy()
    np.testing.assert_array_equal(
        got.view(np.int32), _separately_rounded_min(xyz, s).view(np.int32))
    if seeds == 'points':
        assert (got[:, ::N // k0].view(np.int32) == 0).all()  # +0, not -0
    if N % 128 == 0 and k0 % 128 == 0:
        want = np.asarray(jfps._seed_min_d2(jnp.asarray(xyz), jnp.asarray(s),
                                            interpret=True))
        np.testing.assert_array_max_ulp(got, want, maxulp=2)


@pytest.mark.parametrize('radii,nsamples', [
    ((0.5, 1.0), (4, 16)),      # ascending
    ((1.0, 0.5), (16, 4)),      # descending: the first radius is the larger
    ((1.5,), (32,)),            # one radius
    ((1.0, 1.5, 0.5), (8, 64, 3)),  # three radii, one left unpaired
])
@pytest.mark.parametrize('N', [1001, 1499, 1500])
def test_plain_ball_query_matches_jax_on_the_lattice(radii, nsamples, N):
    """Lattice points lie exactly on the spheres, where strict d2 < r^2
    decides; N = 1001 and 1499 are no multiple of 4 (unaligned rows), and
    the far centers' balls are empty."""
    pts = _lattice(2, N, 3)
    ctr = np.concatenate([pts[:, ::37], np.full((2, 3, 3), 60, np.float32)],
                         axis=1)
    got = tg.ball_query_multi_plain(radii, nsamples, _t(pts), _t(ctr))
    want = jg.ball_query_multi(radii, nsamples, jnp.asarray(pts),
                               jnp.asarray(ctr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g in got:
        assert (g[:, -3:] == 0).all()


@pytest.mark.parametrize('radii,nsamples', [((0.2, 0.8), (16, 32)),
                                            ((0.8, 0.2), (32, 16))])
def test_plain_ball_query_matches_jax_on_repeated_points(radii, nsamples):
    """A cloud repeated 16 times: every hit recurs in every copy, so the
    first nsample hits in index order span copies; radii either way round,
    N = 1003 (unaligned)."""
    pts = _repeated(2, 1003, 16, 4) / 10
    ctr = np.ascontiguousarray(pts[:, 5::9])
    got = tg.ball_query_multi_plain(radii, nsamples, _t(pts), _t(ctr))
    want = jg.ball_query_multi(radii, nsamples, jnp.asarray(pts),
                               jnp.asarray(ctr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
