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
a split, one point, a point past a tile, and seeds that are points. The
order key of F-FPS over a distance matrix (``csrc/fps_dist.cu``) is held
to ``argmax``'s ranking by hypothesis tests on NaN, +-0, +-inf, negatives
and ties. Inputs are made with numpy from fixed seeds; indices must be
equal.
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


# ------------------------------------------------------------- three-NN (K6)
#
# K6 scans only the rows up to a padded suffix's first three and the
# sub-tiles of 32 rows whose lower bound on the rounded d2 does not exceed a
# warp's thresholds. Its plain twins in ``ops.interpolate`` (the same
# directed roundings as ``csrc/three_nn.cu``) are held here to the rule that
# makes the skips exact: no rounded d2 of a sub-tile's point lies below its
# bound, and the tiled scan gives ``three_nn_plain``'s bits.

from hypothesis import given, settings, strategies as st  # noqa: E402

from spsnet_torch.ops import _build  # noqa: E402
from spsnet_torch.ops import interpolate as ti  # noqa: E402
from three_nn_cases import CASES as NN_CASES, three_nn_case  # noqa

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

# (offsets, scales) of a drawn cloud: squares in the subnormals, metres
# near and far from the origin, the padded rows' 1e6, squares that overflow
_REGIMES = {'subnormal': ((0.0,), (1e-20,)),
            'metres': ((0.0, 70.0, -75.2), (1e-3, 1.0, 70.0)),
            'far': ((1e6,), (1e-3, 1.0, 1e6)),
            'huge': ((0.0,), (1e18,))}
_SPECIALS = (0.0, -0.0, np.nan, np.inf, -np.inf, 1e-20, 1e19, 3e38)


@st.composite
def _nn_inputs(draw, max_n=8, max_m=96):
    """(unknown (1, n, 3), known (1, m, 3)) float32: a cloud at a drawn
    offset and scale (``_REGIMES``), its queries
    random, its own points, points a thousandth of the scale off or nudged
    by an ulp, or on a sphere around a query (near-ties); duplicated rows;
    a few coordinates set to zeros, tiny, huge, NaN or inf."""
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    n, m = draw(st.integers(1, max_n)), draw(st.integers(3, max_m))
    off, scales = _REGIMES[draw(st.sampled_from(sorted(_REGIMES)))]
    off = draw(st.sampled_from(off))
    scale = draw(st.sampled_from(scales)) * 10 ** rng.uniform(-1, 1)
    known = (off + scale * rng.normal(size=(1, m, 3))).astype(np.float32)
    kind = draw(st.sampled_from(('random', 'points', 'near', 'ulp',
                                 'sphere')))
    if kind == 'random':
        unknown = off + scale * rng.normal(size=(1, n, 3))
    else:
        unknown = known[:, rng.integers(0, m, n)].astype(np.float64)
        if kind == 'near':
            unknown += scale * 1e-3 * rng.normal(size=unknown.shape)
        if kind == 'ulp':
            unknown = np.nextafter(unknown.astype(np.float32), np.float32(
                np.inf) * rng.choice([-1, 1], unknown.shape))
        if kind == 'sphere':
            v = rng.normal(size=(1, m, 3))
            known = (unknown[:, :1] + scale * v / np.linalg.norm(
                v, axis=-1, keepdims=True)).astype(np.float32)
    if draw(st.booleans()):
        known[:, rng.integers(0, m, m // 2)] = known[:, rng.integers(0, m)]
    unknown = np.asarray(unknown, np.float32)
    for arr in (known, unknown):
        for _ in range(draw(st.integers(0, 3))):
            arr[0, rng.integers(0, arr.shape[1]), rng.integers(0, 3)] = \
                draw(st.sampled_from(_SPECIALS))
    return torch.from_numpy(unknown.copy()), torch.from_numpy(known.copy())


def _pair_d2(unknown, known):
    """(B, N, M): every rounded d2 in the plain version's form."""
    u, k = unknown[:, :, None, :], known[:, None, :, :]
    cross = (u[..., 0] * k[..., 0] + u[..., 1] * k[..., 1]) + \
        u[..., 2] * k[..., 2]
    return (ti._sq_norm(unknown)[..., None] + ti._sq_norm(known)[:, None]) \
        - 2.0 * cross


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(_nn_inputs())
def test_k6_cull_bound_lies_below_every_rounded_d2_of_its_subtile(inputs):
    """For every query and sub-tile, and for the box of the drawn queries
    together (a group of a warp) and every sub-tile, the bound is -inf (no
    skip) or no rounded d2 of the sub-tile's points lies below it or is
    NaN: a sub-tile whose bound exceeds a query's third best, or every
    third best of a group, holds no point that could enter."""
    unknown, known = inputs
    lo, hi = ti.three_nn_boxes(known)
    d2 = _pair_d2(unknown, known)
    lane = ti.three_nn_lower_bound(unknown, unknown, ti._sq_norm(unknown),
                                   lo, hi)
    glo, ghi, gsq = ti.three_nn_group_boxes(unknown)
    group = ti.three_nn_lower_bound(glo, ghi, gsq, lo, hi)[:, :1]
    for lb in (lane, group):
        assert not torch.isnan(lb).any()
        lb = lb.repeat_interleave(ti.TILE, -1)[..., :known.shape[1]]
        bad = (lb > -np.inf) & ~(d2 >= lb)
        assert not bad.any(), (lb.expand_as(d2)[bad][:4], d2[bad][:4])


def test_k6_directed_roundings_bracket_the_exact_result():
    """The twins of ``__fmul_rd`` / ``__fadd_rd`` and their round-up
    mirrors: the result at or below (above) the exact value (rational
    arithmetic) and one ulp from the other where it is inexact, at
    overflow, in the subnormals, with zeros and with far apart
    exponents."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.normal(size=600) * 10.0 ** rng.integers(
        -45, 38, 600), [3e38, -3e38, 1e-45, -1e-45, 0.0, -0.0, 1.0, 1e30]])
    b = np.concatenate([rng.normal(size=600) * 10.0 ** rng.integers(
        -45, 38, 600), [3e38, -3e38, 1e-45, 1e-45, -0.0, 0.0, -1.0, -1e-30]])
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in (a, b))

    def frac(x):
        return Fraction(x) if np.isfinite(x) else x
    for op, exact in ((ti._mul_rd, lambda x, y: Fraction(x) * Fraction(y)),
                      (ti._add_rd, lambda x, y: Fraction(x) + Fraction(y))):
        lo = op(a, b)
        hi = -op(-a, b) if op is ti._mul_rd else -op(-a, -b)
        for x, y, low, high in zip(a.tolist(), b.tolist(), lo.tolist(),
                                   hi.tolist()):
            e = exact(x, y)
            assert frac(low) <= e <= frac(high), (x, y, low, high)
            with np.errstate(over='ignore'):
                up = np.nextafter(np.float32(low), np.float32(np.inf))
            assert high == low if frac(low) == e else high == up, (x, y)


@pytest.mark.parametrize('pad', [0, 1, 2, 3, 40, 97])
def test_k6_scan_rows_stop_three_rows_into_the_padded_run(pad):
    """The run of rows bitwise equal to the last: it starts M - pad with
    ``pad`` rows padded at +0 (at the last row when none is, the rows
    being distinct), one row earlier where the row before is equal too,
    and not earlier for -0 against +0 or for an equal run in the middle;
    the scan keeps its first three rows."""
    m = 100
    known = np.random.default_rng(pad).normal(size=(2, m, 3)).astype(
        np.float32)
    known[:, 20:60] = known[:, 20:21]
    if pad:
        known[:, m - pad:] = 0.0
        known[0, m - pad - 1] = -0.0
    p1 = max(pad, 1)
    known[1, m - p1 - 1] = known[1, m - 1]
    start = ti.three_nn_run_start(torch.from_numpy(known)).tolist()
    assert start == [m - p1, m - p1 - 1]
    assert ti.three_nn_scan_rows(torch.from_numpy(known)).tolist() == [
        min(m, s + 3) for s in start]


@pytest.mark.parametrize('case', NN_CASES)
def test_k6_tiled_scan_is_the_plain_three_nn(case):
    """The kernel's scan in plain PyTorch (suffix rule, culled sub-tiles,
    warps of 32 queries) gives ``three_nn_plain``'s distances bit for bit
    and its indices, on the scan rules' edge cases; where rows are
    padded it evaluates fewer pairs than B x N x M."""
    unknown, known = (torch.from_numpy(a) for a in three_nn_case(
        case, 2, 70, 360))
    dist, idx, pairs = ti.three_nn_tiled_plain(unknown, known)
    want = ti.three_nn_plain(unknown, known)
    assert torch.equal(idx, want[1])
    assert torch.equal(dist.view(torch.int32), want[0].view(torch.int32))
    rows = ti.three_nn_scan_rows(known)
    assert (pairs <= unknown.shape[1] * rows).all()
    if case in ('suffix_m3', 'all_equal', 'voxel_order', 'queries_at_1e6'):
        assert (pairs < unknown.shape[1] * known.shape[1]).all()


@settings(max_examples=25, deadline=None, database=None, derandomize=True)
@given(_nn_inputs(max_n=70, max_m=200))
def test_k6_tiled_scan_is_the_plain_three_nn_on_drawn_inputs(inputs):
    unknown, known = inputs
    dist, idx, _ = ti.three_nn_tiled_plain(unknown, known)
    want = ti.three_nn_plain(unknown, known)
    assert torch.equal(idx, want[1])
    assert torch.equal(dist.view(torch.int32), want[0].view(torch.int32))


def _c_entries(source):
    """{name: [parameter types]} of the ``extern "C"`` functions of a
    ``csrc`` source."""
    text = source.split('extern "C" {', 1)[1]
    import re
    out = {}
    for name, params in re.findall(r'^int (spsnet_\w+)\(([^)]*)\)', text,
                                   re.M):
        out[name] = [' '.join(p.split()[:-1]) for p in params.split(',')
                     if p.strip()]
    return out


def test_kernel_c_signatures_match_their_ctypes_table():
    """Every C entry of every source under ``csrc/`` has the ctypes
    argument types ``_build.SIGNATURES`` gives it (a pointer as c_void_p,
    an int array written by the library as POINTER(c_int), int, float),
    and the table names no entry that the sources lack."""
    kinds = {'const void*': _build._P, 'void*': _build._P,
             'int*': _build._IP, 'int': _build._I, 'float': _build._F}
    for name, table in _build.SIGNATURES.items():
        entries = _c_entries((_build.CSRC / f'{name}.cu').read_text())
        assert sorted(entries) == sorted(table), name
        for fn, params in entries.items():
            assert [kinds[p] for p in params] == table[fn], fn
    assert sorted(_build.SIGNATURES) == sorted(
        p.stem for p in _build.CSRC.glob('*.cu'))


def test_k6_wrapper_refuses_what_the_kernel_does_not_take():
    """``three_nn_kernel`` launches on contiguous CUDA tensors or raises:
    CPU tensors, M < 3, other dtypes; ``three_nn`` takes the plain version
    only for CPU tensors."""
    u, k = torch.zeros(1, 4, 3), torch.zeros(1, 5, 3)
    with pytest.raises(ValueError, match='CUDA'):
        ti.three_nn_kernel(u, k)
    with pytest.raises(ValueError, match='CUDA'):
        ti.three_nn_kernel(u, k, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match='at least 3'):
        ti.three_nn_kernel(u, k[:, :2])
    with pytest.raises(ValueError, match='float32'):
        ti.three_nn_kernel(u.double(), k)
    assert torch.equal(ti.three_nn(u, k)[1], ti.three_nn_plain(u, k)[1])


# F-FPS over a distance matrix (csrc/fps_dist.cu) ranks the running minima
# by an unsigned key; ``ts.fps_dist_key`` is its CPU twin. Its order must
# be the plain version's: ``torch.minimum`` then ``argmax`` (NaN first,
# -0.0 tied with +0.0, the lowest index on ties).

_KEY_SPECIALS = (np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e10, -1e-3,
                 -1.0, 1.0, 1e-45, -1e-45, 3.4e38, -3.4e38)


@st.composite
def _key_values(draw, max_n=40):
    """float32 (n,): normal values at a drawn scale, many of them negative,
    with repeats (ties) and entries set to NaN (either sign), +-inf, +-0,
    subnormals and the extremes."""
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    n = draw(st.integers(1, max_n))
    v = (rng.normal(size=n) * 10.0 ** rng.integers(-40, 38)).astype(
        np.float32)
    if draw(st.booleans()):
        v = v[rng.integers(0, n, n)]
    for _ in range(draw(st.integers(0, n))):
        v[rng.integers(0, n)] = draw(st.sampled_from(_KEY_SPECIALS))
    return torch.from_numpy(v.astype(np.float32))


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(_key_values())
def test_fps_dist_key_orders_as_argmax_ranks(v):
    """For every pair: key above iff NaN against a number or the larger
    number; keys equal iff both NaN or equal numbers (so -0.0 == +0.0);
    the first maximal key is ``argmax``'s pick."""
    key = ts.fps_dist_key(v)
    assert int(key.min()) >= 0 and int(key.max()) <= 0xFFFFFFFF
    a, b = v[:, None], v[None, :]
    na, nb = torch.isnan(a), torch.isnan(b)
    above = (na & ~nb) | (~na & ~nb & (a > b))
    equal = (na & nb) | (a == b)
    assert torch.equal(key[:, None] > key[None, :], above)
    assert torch.equal(key[:, None] == key[None, :], equal)
    assert int(key.argmax()) == int(v.argmax())


@settings(max_examples=150, deadline=None, database=None, derandomize=True)
@given(_key_values(max_n=24), st.integers(0, 2 ** 32 - 1), st.booleans())
def test_fps_dist_by_keys_is_the_plain_f_fps(values, seed, signed_zeros):
    """The kernel's step loop on the CPU (minima by ``torch.minimum``, the
    pick as the first maximal key) gives the plain F-FPS's picks on
    matrices drawn from the same values: negatives, +-0, NaN, +-inf and
    ties; with ``signed_zeros`` every positive entry becomes -0.0 or +0.0,
    so that the maxima are zeros of both signs."""
    rng = np.random.default_rng(seed)
    n = values.shape[0]
    mat = values[torch.from_numpy(rng.integers(0, n, (2, n, n)))]
    if signed_zeros:
        zeros = torch.from_numpy(rng.choice(np.float32([-0.0, 0.0]),
                                            mat.shape))
        mat = torch.where(mat > 0, zeros, mat)
    npoint = int(rng.integers(1, n + 1))
    want = ts.farthest_point_sample_with_dist_plain(mat, npoint)
    mind = torch.full((2, n), 1e10)
    last = torch.zeros(2, dtype=torch.int64)
    got = torch.zeros((2, npoint), dtype=torch.int64)
    for j in range(1, npoint):
        mind = torch.minimum(mind, mat[torch.arange(2), last])
        last = ts.fps_dist_key(mind).argmax(1)
        got[:, j] = last
    assert torch.equal(got, want)
