"""The rest of the point family's ops and samplers against the JAX package
on the CPU: F-FPS over a distance matrix, the annulus ball query of the
dilated grouping, the shared-gather MSG grouping, and the F-FPS, FS, Rand,
ds-FPS and ry-FPS samplers; and, in both packages, two properties of the
SA layer: a later sample range's picks index its own slice but are
gathered from the whole input, and Rand refuses to run without a random
stream.

Inputs come from numpy seeds; the port's ops run their plain versions
here. Indices must be equal. ``calc_square_dist`` is held within
``DIST_RTOL`` of each entry plus ``DIST_RTOL`` of the largest (JAX's
einsum at HIGHEST and the CPU BLAS sum the cross term in another order),
F-FPS bit for bit on JAX's own matrix, ds-FPS's keys bit for bit and
ry-FPS's within ``RY_KEY_ULPS`` fp32 ulps (XLA:CPU and torch round
arctan apart).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu.models import samplers as jax_samplers
from spsnet_tpu.models.sa_module import \
    SAModuleMSGWithSampling as JaxSAModule
from spsnet_tpu.ops import grouping as jg
from spsnet_tpu.ops import sampling as js
from spsnet_torch import ops
from spsnet_torch.models import samplers
from spsnet_torch.models.sa_module import SAModuleMSGWithSampling
from spsnet_torch.ops import grouping as tg
from spsnet_torch.ops import sampling as ts
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from tests.point_family_cases import jax_msg_shared
from tests.reference_impls import ball_query_dilated_ref

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

DIST_RTOL = 1e-6
RY_KEY_ULPS = 4

_jit_ffps = jax.jit(js.farthest_point_sample_with_dist,
                    static_argnames=('npoint',))
_jit_csd = jax.jit(js.calc_square_dist)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _feat(seed, b, n, c):
    """(b, n, 3 + c) rows: a synthetic scan's xyz and features of the
    scale a SA layer's aggregation gives."""
    xyz = synthetic_scan_batch(seed, b, n)[..., :3]
    f = np.random.default_rng(seed).normal(size=(b, n, c)) * 2.0
    return np.concatenate([xyz, f], -1).astype(np.float32)


def _matrix(case):
    if case == 'constant':
        return np.full((2, 40, 40), 3.0, np.float32)
    if case == 'tied':
        # duplicated rows: every pick after the first ties with its twin
        f = _feat(5, 2, 30, 4)
        f = np.concatenate([f, f], 1)
        return np.array(_jit_csd(f, f))
    f = _feat(3, 3, 200, 8)
    m = np.array(_jit_csd(f, f))
    if case == 'nan':
        m[0, 0, 17] = np.nan    # the first row read: 17 holds NaN throughout
        m[1, 5, 3] = np.nan
        m[2, :, 9] = np.nan
    return m


@pytest.mark.parametrize('case,npoint', [('random', 64), ('random', 1),
                                         ('random', 200), ('tied', 40),
                                         ('constant', 12), ('nan', 30)])
def test_fps_with_dist_matches_jax_on_its_matrix(case, npoint):
    """F-FPS, the plain version, bit for bit on JAX's own matrix: random
    rows, one pick, every point, duplicated points (ties to the lowest
    index), a constant matrix, NaN entries (NaN ranks first, as
    ``jnp.argmax`` ranks it)."""
    m = _matrix(case)
    want = np.asarray(_jit_ffps(jnp.asarray(m), npoint=npoint))
    got = ops.farthest_point_sample_with_dist(_t(m), npoint)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_with_dist_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match='N, N'):
        ops.farthest_point_sample_with_dist(torch.zeros(1, 4, 5), 2)
    with pytest.raises(ValueError, match='npoint'):
        ops.farthest_point_sample_with_dist(torch.zeros(1, 4, 4), 5)
    with pytest.raises(ValueError, match='CUDA'):
        ts.farthest_point_sample_with_dist_kernel(torch.zeros(1, 4, 4), 2)


def test_calc_square_dist_matches_jax():
    f = _feat(7, 2, 300, 64)
    want = np.asarray(_jit_csd(f, f))
    got = ops.calc_square_dist(_t(f), _t(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=DIST_RTOL,
                               atol=DIST_RTOL * float(np.abs(want).max()))


def _on_the_boundaries(seed, lo, hi):
    """Twelve centers 10 m apart; for center c, point 3c on the center
    (d2 == 0), 3c + 1 exactly on r_min (d2 == fp32(r_min) * fp32(r_min))
    and 3c + 2 exactly on r_max; then random points around the centers."""
    rng = np.random.default_rng(seed)
    ctr = np.zeros((2, 12, 3), np.float32)
    ctr[:, :, 0] = np.arange(12) * 10.0
    special = np.repeat(ctr, 3, axis=1)
    special[:, 1::3, 2] = np.float32(lo)
    special[:, 2::3, 2] = np.float32(hi)
    around = ctr[:, rng.integers(0, 12, 400)] + rng.uniform(
        -1.5, 1.5, (2, 400, 3)).astype(np.float32)
    return np.concatenate([special, around], 1), ctr


@pytest.mark.parametrize('lo,hi,nsample', [(0.0, 0.5, 16), (0.25, 0.75, 8),
                                           (0.5, 1.25, 64), (0.5, 0.5, 4)])
def test_ball_query_dilated_matches_jax_and_the_reference(lo, hi, nsample):
    """The annulus query at its three boundaries: the center itself (d2 ==
    0) always hits, a point at exactly r_min hits, one at exactly r_max
    misses; against JAX's CPU query and the reference kernel's loop."""
    xyz, ctr = _on_the_boundaries(int(hi * 100), lo, hi)
    for k, r in ((1, lo), (2, hi)):
        d = xyz[:, k::3][:, :12] - ctr
        assert (d[..., 2] * d[..., 2] == np.float32(r) * np.float32(r)).all()
    got = ops.ball_query_dilated(lo, hi, nsample, _t(xyz), _t(ctr)).numpy()
    want = np.asarray(jg.ball_query_dilated(lo, hi, nsample,
                                            jnp.asarray(xyz),
                                            jnp.asarray(ctr)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ball_query_dilated_ref(lo, hi, nsample, xyz, ctr))
    for c in range(12):
        own = set(got[0, c].tolist()) & {3 * c, 3 * c + 1, 3 * c + 2}
        assert own == ({3 * c} if lo == hi else {3 * c, 3 * c + 1})


def test_annulus_multi_query_matches_jax_per_scale():
    """The fused annulus query of a dilated layer (scale 0 [0, r0), scale
    1 [r0, r1)) gives each scale JAX's own ``ball_query_dilated``."""
    xyz, ctr = _on_the_boundaries(9, 0.4, 0.9)
    radii, nsamples, lows = (0.4, 0.9), (8, 32), (0.0, 0.4)
    got = ops.ball_query_multi(radii, nsamples, _t(xyz), _t(ctr),
                               min_radii=lows)
    for g, r, s, lo in zip(got, radii, nsamples, lows):
        np.testing.assert_array_equal(g.numpy(), np.asarray(
            jg.ball_query_dilated(lo, r, s, jnp.asarray(xyz),
                                  jnp.asarray(ctr))))
    plain = ops.ball_query_multi(radii, nsamples, _t(xyz), _t(ctr))
    assert torch.equal(got[0], plain[0])  # [0, r0) is the ball of r0
    assert not torch.equal(got[1], plain[1])


@pytest.mark.parametrize('use_features', [True, False])
def test_msg_shared_group_matches_jax(use_features):
    """One query at (max radius, max nsample), one gather, a radius mask
    plus the nearest candidate for the smaller scale; JAX's switch is
    restored afterwards."""
    xyz = synthetic_scan_batch(2, 2, 1024)[..., :3]
    ctr = np.ascontiguousarray(xyz[:, ::8])
    feats = np.random.default_rng(2).normal(size=(2, 1024, 5)).astype(
        np.float32) if use_features else None
    radii, nsamples = (0.8, 1.6), (16, 32)
    with jax_msg_shared(True):
        assert jg.msg_shared_enabled(False, 2)
        want, wvalid = jg.msg_shared_group(
            radii, nsamples, jnp.asarray(xyz), jnp.asarray(ctr),
            None if feats is None else jnp.asarray(feats))
    assert not jg.msg_shared_enabled(False, 2)
    got, valid = ops.msg_shared_group(radii, nsamples, _t(xyz), _t(ctr),
                                      None if feats is None else _t(feats))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert valid[1] is None and wvalid[1] is None
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(wvalid[0]))
    assert valid[0].any(-1).all()


# ---------------------------------------------------------------- samplers

def test_ffps_and_fs_samplers_match_jax():
    f = _feat(11, 2, 256, 16)
    xyz, feat = f[..., :3], f[..., 3:]
    want = np.asarray(jax.jit(jax_samplers.sample_ffps, static_argnums=2)(
        xyz, feat, 48))
    got = samplers.sample_ffps(_t(xyz), _t(feat), 48)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.jit(jax_samplers.sample_fs, static_argnums=2)(
        xyz, feat, 48))
    got = samplers.sample_fs(_t(xyz), _t(feat), 48)
    assert got.shape == (2, 96)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rand_sampler_takes_jax_permutation_and_a_generator(monkeypatch):
    """Fed JAX's permutation, Rand picks what JAX picks; from a CPU
    generator, the same seed gives the same picks, shared by the batch."""
    perm = np.array(jax.random.permutation(jax.random.PRNGKey(4), 300))
    want = np.asarray(jax_samplers.sample_rand(jax.random.PRNGKey(4), 3,
                                               300, 40))
    with monkeypatch.context() as m:
        m.setattr(samplers, 'draw_permutation',
                  lambda generator, n: _t(perm.astype(np.int64)))
        got = samplers.sample_rand(None, 3, 300, 40, 'cpu')
    np.testing.assert_array_equal(got.numpy(), want)
    a = samplers.sample_rand(torch.Generator().manual_seed(1), 3, 300, 40,
                             'cpu')
    b = samplers.sample_rand(torch.Generator().manual_seed(1), 3, 300, 40,
                             'cpu')
    assert torch.equal(a, b) and (a == a[:1]).all()
    assert len(set(a[0].tolist())) == 40


_jit_ds = jax.jit(jax_samplers.sample_ds_fps, static_argnums=1)
_jit_ry = jax.jit(jax_samplers.sample_ry_fps, static_argnums=1)


@pytest.mark.parametrize('seed', [0, 1])
def test_ds_fps_keys_bit_for_bit_and_picks_equal(seed):
    xyz = synthetic_scan_batch(seed, 2, 1024)[..., :3]
    want_keys = np.asarray(jax.jit(
        lambda x: jnp.linalg.norm(x, axis=-1) - 5.0)(xyz))
    np.testing.assert_array_equal(samplers.ds_fps_keys(_t(xyz)).numpy(),
                                  want_keys)
    np.testing.assert_array_equal(
        samplers.sample_ds_fps(_t(xyz), 128).numpy(),
        np.asarray(_jit_ds(xyz, 128)))


@pytest.mark.parametrize('seed', [0, 1])
def test_ry_fps_keys_within_ulps_and_picks_equal(seed, monkeypatch):
    """ry-FPS's keys within RY_KEY_ULPS ulps of JAX's; the sorted orders
    equal, or apart only where JAX's keys lie within twice that slack of
    each other, and then JAX's order replayed; the picks JAX's."""
    xyz = synthetic_scan_batch(seed, 2, 1024)[..., :3]
    want_keys = np.asarray(jax.jit(
        lambda x: jnp.arctan(x[..., 0] / (x[..., 1] + 1e-12)))(xyz))
    keys = samplers.ry_fps_keys(_t(xyz)).numpy()
    slack = RY_KEY_ULPS * np.spacing(np.float32(np.pi / 2))
    assert (np.abs(keys - want_keys) <= slack).all()
    order = samplers.partition_order(_t(keys)).numpy()
    want_order = np.argsort(want_keys, -1, kind='stable')
    apart = order != want_order
    if apart.any():
        a = np.take_along_axis(want_keys, order, -1)[apart]
        b = np.take_along_axis(want_keys, want_order, -1)[apart]
        assert np.abs(a - b).max() <= 2 * slack
        monkeypatch.setattr(samplers, 'partition_order',
                            lambda k: _t(want_order))
    np.testing.assert_array_equal(
        samplers.sample_ry_fps(_t(xyz), 128).numpy(),
        np.asarray(_jit_ry(xyz, 128)))


def test_partitioned_fps_takes_multiples_of_four():
    xyz = torch.zeros(1, 30, 3)
    with pytest.raises(ValueError, match='multiples'):
        samplers.sample_ds_fps(xyz, 8)
    with pytest.raises(ValueError, match='multiples'):
        samplers.sample_ry_fps(torch.zeros(1, 32, 3), 6)


# ----------------------------------------- properties of both packages

def _layer_kwargs(types, ranges, npoints):
    return dict(npoint_list=npoints, sample_range_list=ranges,
                sample_type_list=types, radii=[], nsamples=[], mlps=[],
                num_class=3)


def test_a_later_sample_range_indexes_its_slice_in_both_packages():
    """SAMPLE_RANGE_LIST [16, -1]: the second range's D-FPS picks index
    its own slice (points 16 on) and both packages gather them from the
    whole input without the slice's offset (``spsnet_tpu/models/
    sa_module.py:65-75,133``; ROADMAP Queue 3): the picks and points of
    the two packages are equal, and the second range's points come from
    the first 16 rows wherever its picks lie below 16."""
    rng = np.random.default_rng(12)
    xyz = rng.normal(size=(2, 40, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 40, 4)).astype(np.float32)
    kw = _layer_kwargs(['D-FPS', 'D-FPS'], [16, -1], [6, 8])
    jm = JaxSAModule(**kw)
    variables = jm.init(jax.random.PRNGKey(0), xyz, feats, train=False)
    jout = jm.apply(variables, xyz, feats, train=False)
    out = SAModuleMSGWithSampling(4, **kw)(_t(xyz), _t(feats))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    second = out[3][:, 6:]
    want = ops.farthest_point_sample(_t(xyz[:, 16:]), 8)
    assert torch.equal(second, want)
    assert (second < 16).any()
    assert torch.equal(out[0][:, 6:], ops.gather_points(_t(xyz), second))


def test_rand_refuses_without_a_random_stream_in_both_packages():
    rng = np.random.default_rng(13)
    xyz = rng.normal(size=(2, 40, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 40, 4)).astype(np.float32)
    kw = _layer_kwargs(['Rand'], [-1], [8])
    jm = JaxSAModule(**kw)
    variables = jm.init({'params': jax.random.PRNGKey(0),
                         'sampling': jax.random.PRNGKey(1)}, xyz, feats,
                        train=False)
    with pytest.raises(Exception, match='sampling'):
        jm.apply(variables, xyz, feats, train=False)
    with pytest.raises(ValueError, match='sampling_generator'):
        SAModuleMSGWithSampling(4, **kw)(_t(xyz), _t(feats))
    out = SAModuleMSGWithSampling(4, **kw)(
        _t(xyz), _t(feats), sampling_generator=torch.Generator().manual_seed(0))
    assert out[3].shape == (2, 8)
