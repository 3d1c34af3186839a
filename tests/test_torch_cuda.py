"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases that the main paths' shapes do not reach: N and M off the
kernels' tiles, balls that are empty or hit exactly on the radius, more
than 32 slots, one or three radii, masks with too few valid points, the
shared-memory and register limits of the FPS kernels, one seed or more
seeds than a shared-memory tile, seeds in any order, the experimental FPS
entries' kernels (``fps_rows``, ``fps_hier``) at one point, at N off the
128-lane padding, on all-equal points and with several rows a CTA. Indices
must be equal, and the min distances to the seeds bit for bit.

These tests need a CUDA card and skip without one. On the H100:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: this file needs only torch and numpy, and
``tests/conftest.py`` imports JAX.)
"""
import numpy as np
import pytest
import torch

from spsnet_torch.ops import _build
from spsnet_torch.ops.grouping import (ball_query_multi_kernel,
                                       ball_query_multi_plain)
from spsnet_torch.ops import sampling
from spsnet_torch.ops.sampling import (FpsSeeding,
                                       farthest_point_sample_kernel,
                                       farthest_point_sample_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the H100, see the README)')
    return torch.device('cuda')


def _cloud(seed, b, n, scale=20.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.normal(size=(b, n, 3)) * scale).astype(np.float32))


@pytest.mark.parametrize('B,N,M,mask', [
    (1, 1, 1, False),          # one point
    (3, 17, 17, True),         # npoint == N, fewer valid points than npoint
    (2, 1000, 1000, False),    # N below one thread's share, npoint == N
    (2, 1025, 300, True),      # one past a multiple of 1024
    (1, 19000, 64, False),     # above the shared-memory planes (global path)
    (1, 65536, 16, True),      # the largest N
])
def test_fps_kernel_matches_plain(cuda, B, N, M, mask):
    xyz = _cloud(B * N, B, N).to(cuda)
    vm = None
    if mask:
        rng = np.random.default_rng(N)
        vm = torch.from_numpy(rng.uniform(size=(B, N)) > 0.5).to(cuda)
        vm[0] = False          # an all-invalid row picks index 0 throughout
    got = farthest_point_sample_kernel(xyz, M, vm)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(xyz, M, vm))


def test_fps_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match='N <='):
        farthest_point_sample_kernel(torch.zeros(1, 65537, 3, device=cuda), 4)
    with pytest.raises(ValueError, match='contiguous'):
        farthest_point_sample_kernel(
            torch.zeros(1, 3, 64, device=cuda).transpose(1, 2), 4)


def _lattice(cuda):
    """0.5 m lattice: many points lie exactly on the r = 0.5 / 1.0 spheres,
    where strict d2 < r^2 decides; the four far centers hit nothing."""
    g = np.arange(-3, 3.5, 0.5, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(1, -1, 3)
    pts = pts[:, np.random.default_rng(0).permutation(pts.shape[1])]
    ctr = np.concatenate([pts[:, :37], np.full((1, 4, 3), 50, np.float32)], 1)
    return (torch.from_numpy(pts).to(cuda),
            torch.from_numpy(np.ascontiguousarray(ctr)).to(cuda))


@pytest.mark.parametrize('radii,nsamples', [
    ((0.5,), (4,)),                    # one radius: one launch, no pair
    ((0.5, 1.0), (1, 64)),             # one slot; more slots than a warp
    ((0.5, 1.0, 1.5), (8, 16, 40)),    # three radii: two launches
])
def test_ball_query_kernel_matches_plain_on_the_sphere(cuda, radii, nsamples):
    pts, ctr = _lattice(cuda)
    before = _build.LAUNCHES['ball_query']
    got = ball_query_multi_kernel(radii, nsamples, pts, ctr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['ball_query'] - before == (len(radii) + 1) // 2
    for g, w in zip(got, ball_query_multi_plain(radii, nsamples, pts, ctr)):
        assert torch.equal(g, w)
    assert (got[0][:, -4:] == 0).all()  # empty balls


@pytest.mark.parametrize('B,N,M', [(3, 1500, 13), (2, 37, 9), (1, 4097, 70)])
def test_ball_query_kernel_matches_plain_off_the_tiles(cuda, B, N, M):
    pts = _cloud(N, B, N, scale=1.0).to(cuda)
    ctr = pts[:, :M].contiguous()
    radii, nsamples = (0.3, 0.9), (16, 32)
    got = ball_query_multi_kernel(radii, nsamples, pts, ctr)
    torch.cuda.synchronize()
    for g, w in zip(got, ball_query_multi_plain(radii, nsamples, pts, ctr)):
        assert torch.equal(g, w)


def test_fps_counts_one_launch_per_call(cuda):
    xyz = _cloud(1, 2, 300).to(cuda)
    before = _build.LAUNCHES['fps']
    farthest_point_sample_kernel(xyz, 10)
    farthest_point_sample_plain(xyz, 10)
    assert _build.LAUNCHES['fps'] - before == 1


@pytest.mark.parametrize('B,N,k0', [
    (1, 1, 1),          # one point, one seed
    (3, 257, 5),        # one block and one point past it
    (2, 3000, 1025),    # one seed past a shared-memory tile
    (1, 70000, 64),     # many blocks along N
])
def test_seed_min_kernel_matches_plain_bit_for_bit(cuda, B, N, k0):
    xyz = _cloud(N + k0, B, N).to(cuda)
    seeds = _cloud(k0, B, k0).to(cuda)
    got = sampling.seed_min_d2_kernel(xyz, seeds)
    torch.cuda.synchronize()
    assert torch.equal(got, sampling.seed_min_d2_plain(xyz, seeds))


@pytest.mark.parametrize('B,N,npoint,k0,order', [
    (1, 2, 2, 1, 'head'),         # one step
    (2, 1000, 1000, 999, 'random'),  # npoint == N, one step left
    (3, 1025, 300, 128, 'random'),   # one past a multiple of 1024
    (1, 19000, 256, 128, 'grid'),    # above the shared-memory planes
    (1, 65536, 200, 100, 'grid'),    # the largest N
])
def test_seeded_fps_kernel_matches_plain(cuda, B, N, npoint, k0, order):
    xyz = _cloud(N + 1, B, N).to(cuda)
    if order == 'head':
        idx = torch.arange(k0, device=cuda).expand(B, k0).contiguous()
    elif order == 'random':
        rng = np.random.default_rng(N)
        idx = torch.from_numpy(np.stack([rng.permutation(N)[:k0]
                                         for _ in range(B)])).to(cuda)
    else:
        idx = sampling.grid_seed_indices(xyz, k0)
    seeds = xyz.gather(1, idx[..., None].expand(-1, -1, 3)).contiguous()
    d0 = sampling.seed_min_d2_kernel(xyz, seeds)
    got = sampling.farthest_point_sample_seeded_kernel(xyz, npoint, d0, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, sampling.farthest_point_sample_seeded_plain(
        xyz, npoint, d0, idx))
    assert torch.equal(got[:, :k0], idx)


def test_seeded_fps_kernel_rejects_what_it_cannot_take(cuda):
    xyz = _cloud(0, 1, 500).to(cuda)
    d0 = torch.zeros(1, 500, device=cuda)
    idx = torch.arange(10, device=cuda)[None]
    with pytest.raises(ValueError, match='k0 < npoint'):
        sampling.farthest_point_sample_seeded_kernel(xyz, 10, d0, idx)
    with pytest.raises(ValueError, match='N <='):
        big = torch.zeros(1, 65537, 3, device=cuda)
        sampling.farthest_point_sample_seeded_kernel(
            big, 20, torch.zeros(1, 65537, device=cuda), idx)
    with pytest.raises(ValueError, match='valid_mask'):
        sampling.farthest_point_sample(
            xyz, 256, torch.ones(1, 500, dtype=torch.bool, device=cuda),
            seeding=FpsSeeding(0.75, 'grid'))


def test_seeded_dispatch_counts_one_launch_of_each(cuda):
    """A seeded D-FPS launches K3 and K4 once each and no exact FPS; the
    same call without seeding launches the exact kernel."""
    xyz = _cloud(2, 2, 5000).to(cuda)
    _build.reset_launches()
    got = sampling.farthest_point_sample(xyz, 1024,
                                         seeding=FpsSeeding(0.75, 'grid'))
    assert {k: _build.LAUNCHES[k] for k in ('seed_min', 'fps_seeded',
                                            'fps')} == \
        {'seed_min': 1, 'fps_seeded': 1, 'fps': 0}
    assert torch.equal(got.cpu(), sampling.farthest_point_sample(
        xyz.cpu(), 1024, seeding=FpsSeeding(0.75, 'grid')))
    sampling.farthest_point_sample(xyz, 1024)
    assert _build.LAUNCHES['fps'] == 1


FPS_VARIANTS = {'fps_rows': sampling.farthest_point_sample_rows_kernel,
                'fps_hier': sampling.farthest_point_sample_hier_kernel}


@pytest.mark.parametrize('name', sorted(FPS_VARIANTS))
@pytest.mark.parametrize('B,N,M,equal', [
    (1, 1, 1, False),          # one point
    (3, 197, 64, False),       # N % 128 != 0, B not a power of two
    (2, 300, 300, True),       # all points equal: every pick is a tie
    (32, 1000, 200, False),    # many small rows: fps_rows packs 16 a CTA
    (5, 4096, 512, False),     # 4 rows a CTA, three idle in the second
    (2, 15884, 256, False),    # SPSNet's layer-0 N
    (1, 40000, 64, False),     # above the shared-memory planes
])
def test_fps_variant_kernels_match_plain(cuda, name, B, N, M, equal):
    xyz = _cloud(B + N, B, N).to(cuda)
    if equal:
        xyz = xyz[:, :1].expand(B, N, 3).contiguous()
    before = _build.LAUNCHES[name]
    got = FPS_VARIANTS[name](xyz, M)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] - before == 1
    assert torch.equal(got, farthest_point_sample_plain(xyz, M))


@pytest.mark.parametrize('B,N,G', [(1, 16384, 1), (8, 15884, 1),
                                   (32, 4096, 4), (5, 4096, 4),
                                   (32, 1000, 16), (3, 2048, 2),
                                   (64, 100, 32)])
def test_fps_rows_packs_rows_while_a_thread_holds_at_most_16_points(
        cuda, B, N, G):
    assert _build.library('fps_rows').spsnet_fps_rows_per_cta(B, N) == G
