"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases that the main paths' shapes do not reach: N and M off the
kernels' tiles, balls that are empty or hit exactly on the radius, more
than 32 slots, one or three radii, masks with too few valid points, the
shared-memory and register limits of the FPS kernels, the experimental FPS
entries at one point, at N off the 128-lane padding, on all-equal points
and with many rows, launching the exact FPS kernel. For the cluster FPS:
batch sizes that set each cluster size, tied maxima in different CTAs of a
cluster at each cluster size, masks, seeds in several shards. For the min
distance to the seeds: one seed, seed counts off the cluster shares and no
multiple of 4, one point, a point past a CTA's points, seeds that are
points, every cluster size its rule picks. For the ball query: radii
either way round, more slots than points, both numbers of centers a warp,
rows that are not 16-byte aligned. At the shapes of SPSNet training: the
stability train step's ball query, the seeded kernels at the points SPSNet
keeps, and S-FPS against the CPU. At the shapes of PointRCNN serving:
FPS and the ball query over 800 RoI rows with empty and padded RoIs, and
chunked FPS; FPS at Waymo's (2, 65536) -> 16384. At the shapes of
PV-RCNN serving: FPS to 2048 keypoints, the VSA's five fused queries (up
to 40 000 voxel centers, most padded at 1e6 on the coarse levels), the
RoI-grid query; the sparse gather and the voxel stack card against the
CPU. Indices must be equal, and the min distances to the seeds bit for
bit.

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
    (1, 19000, 64, False),     # above the first design's shared-memory planes
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


# (B, N, k0) -> the cluster size S of csrc/seed_min.cu's rule: the smallest
# power of two <= 16 that brings B * ceil(N / 512) * S to 512 CTAs while a
# share keeps 32 seeds
SEED_MIN_SPLITS = [
    (1, 1, 1, 1),
    (4, 16384, 40, 1),       # too few seeds to split
    (4, 70000, 64, 1),       # 548 tiles of points fill the card alone
    (2, 5000, 100, 2),       # a third split would leave 25 seeds a CTA
    (2, 70000, 64, 2),       # 274 tiles
    (4, 16384, 3072, 4),     # the train path's first layer
    (1, 40000, 300, 8),      # 79 tiles
    (4, 4096, 768, 16),      # the train path's second layer
    (1, 5000, 1000, 16),     # 10 tiles
]


@pytest.mark.parametrize('B,N,k0', [
    (1, 1, 1),          # one point, one seed
    (3, 257, 5),        # part of one tile of points
    (2, 3000, 1025),    # 16 shares of 68 seeds, the last one short
    (1, 70000, 64),     # many blocks along N
    (4, 16384, 3073),   # one seed past the train path's k0 (4 shares)
    (4, 4096, 769),     # the same at its second layer (16 shares)
    (3, 2000, 7),       # k0 % 4 != 0
    (3, 1, 5),          # one point
    (2, 1025, 300),     # one point past two tiles of 128 x 4 points
    (2, 70000, 4500),   # one share, staged in three chunks of 2048
])
def test_seed_min_kernel_matches_plain_bit_for_bit(cuda, B, N, k0):
    xyz = _cloud(N + k0, B, N).to(cuda)
    seeds = _cloud(k0, B, k0).to(cuda)
    got = sampling.seed_min_d2_kernel(xyz, seeds)
    torch.cuda.synchronize()
    assert torch.equal(got, sampling.seed_min_d2_plain(xyz, seeds))


@pytest.mark.parametrize('B,N,k0,S', SEED_MIN_SPLITS)
def test_seed_min_kernel_every_cluster_split(cuda, B, N, k0, S):
    """Every cluster size the rule picks, reached through (B, N, k0), on
    seeds that are points of the cloud (d2 = +0 there, never -0)."""
    assert sampling.seed_min_launch_shape(B, N, k0)[0] == S
    xyz = _cloud(S + N, B, N).to(cuda)
    rng = np.random.default_rng(k0)
    idx = torch.from_numpy(np.stack([rng.permutation(N)[:k0]
                                     for _ in range(B)])).to(cuda)
    seeds = xyz.gather(1, idx[..., None].expand(-1, -1, 3)).contiguous()
    before = _build.LAUNCHES['seed_min']
    got = sampling.seed_min_d2_kernel(xyz, seeds)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['seed_min'] - before == 1
    assert torch.equal(got, sampling.seed_min_d2_plain(xyz, seeds))
    at = got.gather(1, idx)
    assert ((at == 0) & ~torch.signbit(at)).all()


@pytest.mark.parametrize('B,N,npoint,k0,order', [
    (1, 2, 2, 1, 'head'),         # one step
    (2, 1000, 1000, 999, 'random'),  # npoint == N, one step left
    (3, 1025, 300, 128, 'random'),   # one past a multiple of 1024
    (1, 19000, 256, 128, 'grid'),    # above the first design's smem planes
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


# (B, N) -> the cluster size of csrc/fps.cu's rule at B >= 8
CLUSTER_RULE_MANY_ROWS = [(8, 16384, 16), (16, 16384, 16), (16, 4096, 8),
                          (32, 4096, 4), (33, 5000, 8), (64, 4096, 4),
                          (128, 1000, 2)]


K5_ENTRIES = ('farthest_point_sample_batched',
              'farthest_point_sample_hier_argmax')


@pytest.mark.parametrize('entry', K5_ENTRIES)
@pytest.mark.parametrize('B,N,M,equal', [
    (1, 1, 1, False),          # one point
    (3, 197, 64, False),       # N % 128 != 0, B not a power of two
    (2, 300, 300, True),       # all points equal: every pick is a tie
    (32, 1000, 200, False),    # many small rows
    (5, 4096, 512, False),     # B just past a power of two
    (2, 15884, 256, False),    # SPSNet's layer-0 N
    (1, 40000, 64, False),     # a row past the first designs' limits
])
def test_fps_entries_launch_the_exact_kernel(cuda, entry, B, N, M, equal):
    """The experimental FPS entries (K5a-c's counterparts) launch the exact
    FPS kernel once a call and nothing else, and pick what plain FPS picks."""
    xyz = _cloud(B + N, B, N).to(cuda)
    if equal:
        xyz = xyz[:, :1].expand(B, N, 3).contiguous()
    before = dict(_build.LAUNCHES)
    got = getattr(sampling, entry)(xyz, M)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in _build.LAUNCHES.items()} == \
        {k: int(k == 'fps') for k in before}
    assert torch.equal(got, farthest_point_sample_plain(xyz, M))


@pytest.mark.parametrize('B,N,C', CLUSTER_RULE_MANY_ROWS)
def test_fps_cluster_size_for_eight_rows_and_more(cuda, B, N, C):
    """The cluster rule at B >= 8 (measured on the H100, PERF.md), and the
    card can schedule each such cluster."""
    lib = _build.library('fps')
    assert lib.spsnet_fps_cluster_size(B, N) == C
    assert lib.spsnet_fps_max_active_clusters(B, N, 0) > 0


# --- the cluster FPS (csrc/fps.cu) -----------------------------------------

def _lattice_cloud(b, n, seed):
    """A 0.5 m lattice rolled by a random offset per row: equal distances
    recur all along the row, in every CTA of a cluster."""
    side = int(np.ceil(n ** (1 / 3)))
    g = np.arange(side, dtype=np.float32) * 0.5
    pts = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)[:n]
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([np.roll(pts, rng.integers(n), axis=0)
                                      for _ in range(b)]))


def _repeated(b, n, copies, seed):
    """``copies`` copies of one cloud end to end: with C = copies CTAs a
    row, each CTA holds one copy, so every maximum ties across all CTAs."""
    one = _cloud(seed, b, -(-n // copies))
    return one.repeat(1, copies, 1)[:, :n].contiguous()


@pytest.mark.parametrize('N', [37, 1000, 15884, 16384, 40000, 65536])
@pytest.mark.parametrize('B', [1, 4, 8, 33])
def test_cluster_fps_matches_plain(cuda, B, N):
    """Every batch size of the cluster rule (16 CTAs a row for B <= 8, 4 for
    B = 33) at every N up to the largest."""
    xyz = _cloud(B * 7 + N, B, N).to(cuda)
    M = min(N, 200)
    got = farthest_point_sample_kernel(xyz, M)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(xyz, M))


@pytest.mark.parametrize('mask', ['none_valid', 'one_valid', 'last_valid',
                                  'random'])
@pytest.mark.parametrize('B,N', [(4, 37), (4, 16384), (2, 65536)])
def test_cluster_fps_masks_match_plain(cuda, mask, B, N):
    """The first pick is the cluster's lowest valid index (0 when none is
    valid); one valid point in the middle, only the last one, or a random
    half."""
    xyz = _cloud(N, B, N).to(cuda)
    idx = torch.arange(N, device=cuda).expand(B, N)
    rng = np.random.default_rng(N)
    vm = {'none_valid': idx < 0, 'one_valid': idx == N // 2 + 1,
          'last_valid': idx == N - 1,
          'random': torch.from_numpy(rng.uniform(size=(B, N)) > 0.5)
          .to(cuda)}[mask].contiguous()
    M = min(N, 150)
    got = farthest_point_sample_kernel(xyz, M, vm)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(xyz, M, vm))
    if mask == 'one_valid':
        assert (got == N // 2 + 1).all()


@pytest.mark.parametrize('B,N,cluster', [(8, 8192, 16), (16, 8192, 8),
                                         (33, 4096, 4), (64, 2048, 2)])
@pytest.mark.parametrize('cloud', ['lattice', 'repeated'])
def test_cluster_fps_ties_across_ctas(cuda, cloud, B, N, cluster):
    """Tied maxima in different CTAs: the lowest global index must win, at
    every cluster size, which the batch size and N set."""
    assert sampling.fps_launch_shape(B, N) == (cluster, 256)
    xyz = (_lattice_cloud(B, N, cluster) if cloud == 'lattice'
           else _repeated(B, N, cluster, cluster)).to(cuda)
    got = farthest_point_sample_kernel(xyz, 600)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(xyz, 600))


@pytest.mark.parametrize('B,N,npoint,k0', [(4, 16384, 4096, 3072),
                                           (4, 4096, 1024, 768),
                                           (33, 5000, 300, 128),
                                           (2, 65536, 300, 200)])
def test_cluster_seeded_fps_with_seeds_in_every_shard(cuda, B, N, npoint,
                                                      k0):
    """Seeds drawn from the whole row, so every CTA of the cluster holds
    seeds, in random order: the chain starts from the last seed, which lies
    in any shard."""
    xyz = _cloud(N + k0, B, N).to(cuda)
    rng = np.random.default_rng(N)
    idx = torch.from_numpy(np.stack([rng.permutation(N)[:k0]
                                     for _ in range(B)])).to(cuda)
    shard = -(-N // sampling.fps_launch_shape(B, N)[0])
    assert len(set((idx[:, -1] // shard).tolist())) > 1
    seeds = xyz.gather(1, idx[..., None].expand(-1, -1, 3)).contiguous()
    d0 = sampling.seed_min_d2_kernel(xyz, seeds)
    got = sampling.farthest_point_sample_seeded_kernel(xyz, npoint, d0, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, sampling.farthest_point_sample_seeded_plain(
        xyz, npoint, d0, idx))


def test_cluster_seeded_fps_on_repeated_points(cuda):
    """Seeded completion on a cloud whose copies lie in different CTAs."""
    xyz = _repeated(2, 16384, 16, 3).to(cuda)
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(np.stack([rng.permutation(16384)[:1000]
                                     for _ in range(2)])).to(cuda)
    seeds = xyz.gather(1, idx[..., None].expand(-1, -1, 3)).contiguous()
    d0 = sampling.seed_min_d2_kernel(xyz, seeds)
    got = sampling.farthest_point_sample_seeded_kernel(xyz, 1500, d0, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, sampling.farthest_point_sample_seeded_plain(
        xyz, 1500, d0, idx))


def test_cluster_fps_follows_the_cluster_rule(cuda):
    """B * C <= 132 where possible, but enough CTAs for 4 points a thread
    (up to 16), and every rule's cluster can be scheduled on this card."""
    for (B, N), want in {(1, 16384): 16, (8, 16384): 16, (8, 15884): 16,
                         (16, 4096): 8, (33, 5000): 8, (64, 4096): 4,
                         (64, 65536): 16, (8, 37): 2, (4, 600): 4}.items():
        assert sampling.fps_launch_shape(B, N) == (want, 256), (B, N)
        for seeded in (0, 1):
            assert _build.library('fps').spsnet_fps_max_active_clusters(
                B, N, seeded) > 0


def test_cluster_fps_raises_and_never_falls_back(cuda):
    """What the cluster cannot hold raises, on the card, with no launch of
    any kernel: N past the largest for the exact and the seeded kernel,
    through the kernel wrappers and the dispatching entry."""
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match='N <='):
        farthest_point_sample_kernel(torch.zeros(1, 65537, 3, device=cuda), 8)
    with pytest.raises(ValueError, match='N <='):
        sampling.farthest_point_sample_seeded_kernel(
            torch.zeros(1, 65537, 3, device=cuda), 8,
            torch.zeros(1, 65537, device=cuda),
            torch.zeros(1, 2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match='N <='):
        sampling.farthest_point_sample(torch.zeros(2, 65537, 3, device=cuda),
                                       8)
    assert _build.LAUNCHES == before


# --- the ball query (csrc/ball_query.cu) -----------------------------------

@pytest.mark.parametrize('M,w', [(203, 1), (2731, 2)])
@pytest.mark.parametrize('N', [4096, 4097, 1024, 1001, 1002])
@pytest.mark.parametrize('radii,nsamples', [
    ((0.3, 0.9), (16, 32)),      # ascending
    ((0.9, 0.3), (32, 16)),      # descending
    ((0.5,), (24,)),             # one radius
])
def test_ball_query_kernel_every_warp_shape(cuda, M, w, N, radii, nsamples):
    """Both numbers of centers a warp (the rule's W by B x M), on aligned
    rows of several tiles (bulk copies) and on rows of one tile or not
    16-byte aligned (plain loads), M no multiple of any CTA's centers, a
    far center with an empty ball."""
    B = 3
    assert _build.library('ball_query').spsnet_ball_query_warp_centers(
        B, M) == w
    pts = _cloud(N + M, B, N, scale=1.0).to(cuda)
    near = torch.arange(7, 7 + M - 1, device=cuda) % N
    ctr = torch.cat([pts[:, near],
                     torch.full((B, 1, 3), 40.0, device=cuda)], 1)
    got = ball_query_multi_kernel(radii, nsamples, pts, ctr.contiguous())
    torch.cuda.synchronize()
    for g, want in zip(got, ball_query_multi_plain(radii, nsamples, pts, ctr)):
        assert torch.equal(g, want)
        assert (g[:, -1] == 0).all()


@pytest.mark.parametrize('N', [37, 40])
def test_ball_query_kernel_more_slots_than_points(cuda, N):
    """nsample > N: a ball can never fill, so every center scans the whole
    row and pads with its first hit."""
    pts = _cloud(N, 2, N, scale=0.3).to(cuda)
    got = ball_query_multi_kernel((0.8, 0.2), (64, 50), pts, pts)
    torch.cuda.synchronize()
    for g, want in zip(got, ball_query_multi_plain((0.8, 0.2), (64, 50), pts,
                                                   pts)):
        assert torch.equal(g, want)


def test_ball_query_kernel_on_an_unaligned_view(cuda):
    """A tensor whose data starts 4 bytes past a 16-byte boundary takes the
    plain-load path even when N % 4 == 0."""
    base = _cloud(5, 1, 2049, scale=1.0).to(cuda).flatten()
    pts = base[1:1 + 2048 * 3].view(1, 2048, 3)
    assert pts.data_ptr() % 16 != 0
    ctr = pts[:, :100].contiguous()
    got = ball_query_multi_kernel((0.4, 0.8), (16, 32), pts, ctr)
    torch.cuda.synchronize()
    for g, want in zip(got, ball_query_multi_plain((0.4, 0.8), (16, 32), pts,
                                                   ctr)):
        assert torch.equal(g, want)


def test_ball_query_warp_centers_rule(cuda):
    """Two centers a warp from 8192 centers on (IA-SSD's layers 0 and 1,
    the stability SA, the surface graph), one at the small layers."""
    lib = _build.library('ball_query')
    for (B, M), w in {(8, 4096): 2, (8, 16384): 2, (8, 15884): 2,
                      (8, 1024): 2, (8, 512): 1, (8, 256): 1,
                      (1, 8191): 1}.items():
        assert lib.spsnet_ball_query_warp_centers(B, M) == w, (B, M)


# the shapes of SPSNet training: the stability train step's K2, K3 and K4
# at the points SPSNet keeps after its deletion, and S-FPS (K1 then K2)


def _scans(seed, b, n):
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    return torch.from_numpy(
        np.ascontiguousarray(synthetic_scan_batch(seed, b, n)[..., :3]))


def test_ball_query_kernel_at_the_stability_train_shape(cuda):
    """Every point of 16 scans of 16384 a center, r 0.2 / 0.8, 16 / 32
    neighbours: one launch, both radii equal to plain."""
    xyz = _scans(5, 16, 16384).to(cuda)
    before = _build.LAUNCHES['ball_query']
    got = ball_query_multi_kernel((0.2, 0.8), (16, 32), xyz, xyz)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['ball_query'] - before == 1
    for g, w in zip(got, ball_query_multi_plain((0.2, 0.8), (16, 32), xyz,
                                                xyz)):
        assert torch.equal(g, w)


@pytest.mark.parametrize('order', ['grid', 'head'])
def test_seeded_kernels_at_the_spsnet_train_shape(cuda, order):
    """K3 (bit for bit, S = 4 by its rule) and K4 at SPSNet training's
    layer 0: (4, 15884) -> 4096 from 3072 seeds."""
    B, N, npoint, k0 = 4, 15884, 4096, 3072
    assert sampling.seed_min_launch_shape(B, N, k0)[0] == 4
    xyz = _scans(6, B, N).to(cuda)
    idx = sampling.grid_seed_indices(xyz, k0) if order == 'grid' else \
        torch.arange(k0, device=cuda).expand(B, k0).contiguous()
    seeds = xyz.gather(1, idx[..., None].expand(-1, -1, 3)).contiguous()
    d0 = sampling.seed_min_d2_kernel(xyz, seeds)
    got = sampling.farthest_point_sample_seeded_kernel(xyz, npoint, d0, idx)
    torch.cuda.synchronize()
    assert torch.equal(d0, sampling.seed_min_d2_plain(xyz, seeds))
    assert torch.equal(got, sampling.farthest_point_sample_seeded_plain(
        xyz, npoint, d0, idx))


@pytest.mark.parametrize('min_unique', [0, 3500, 4097])
def test_sfps_on_the_card_matches_the_cpu(cuda, min_unique):
    """S-FPS at (4, 16384) -> 4096 with SPSNet.yaml's layer-0 ball (r 0.05,
    16 neighbours): one exact-FPS and one ball-query launch, and the CPU's
    plain picks and stds; min_unique 0 keeps the swap, 4097 (above npoint)
    the D-FPS picks, 3500 whichever this data gives."""
    from spsnet_torch.models import samplers
    xyz = _scans(7, 4, 16384)
    stds = torch.from_numpy(np.random.default_rng(7).uniform(
        0.5, 30.0, (4, 16384)).astype(np.float32))
    _build.reset_launches()
    idx, got_stds = samplers.sample_sfps(xyz.to(cuda), stds.to(cuda), 4096,
                                         0.05, 16, min_unique)
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] for k in ('fps', 'ball_query', 'seed_min',
                                            'fps_seeded')} == \
        {'fps': 1, 'ball_query': 1, 'seed_min': 0, 'fps_seeded': 0}
    want, want_stds = samplers.sample_sfps(xyz, stds, 4096, 0.05, 16,
                                           min_unique)
    assert torch.equal(idx.cpu(), want)
    assert torch.equal(got_stds.cpu(), want_stds)
    base = farthest_point_sample_kernel(xyz.to(cuda), 4096).cpu()
    if min_unique == 4097:
        assert torch.equal(want, base)
    elif min_unique == 0:
        assert not torch.equal(want, base)


def _roi_rows(seed, rows, n):
    """(rows, n, 3) pooled RoI rows as PointRCNN's RoI head gives them to
    its SA layers: points of a box in its canonical frame; every fifth row
    all zero (a RoI with no point), and rows that hold 1, 3, 40 or n / 2
    distinct points, then their first point repeated (a RoI with fewer
    points than slots), so that most distances tie."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1, 1, (rows, n, 3)) * [2.0, 0.9, 0.8]).astype(
        np.float32)
    few = (1, 3, 40, n // 2)
    for r in range(rows):
        if r % 5 == 0:
            x[r] = 0.0
        elif r % 5 == 1:
            k = few[(r // 5) % len(few)]
            x[r, k:] = x[r, 0]
    return torch.from_numpy(x)


@pytest.mark.parametrize('n,npoint', [(512, 128), (128, 32)])
def test_fps_kernel_at_the_roi_shapes(cuda, n, npoint):
    """PointRCNN's RoI SA layers: (800, 512) -> 128 and (800, 128) -> 32,
    clusters of 2 CTAs by the rule (at N = 128, 192 of a CTA's 256 threads
    hold no point), all-zero and padded rows where the lowest index must
    win every tie."""
    xyz = _roi_rows(n, 800, n).to(cuda)
    assert sampling.fps_launch_shape(800, n)[0] == 2
    got = farthest_point_sample_kernel(xyz, npoint)
    torch.cuda.synchronize()
    want = farthest_point_sample_plain(xyz, npoint)
    assert torch.equal(got, want)
    assert torch.equal(want[0], torch.zeros_like(want[0]))  # an empty row


def test_fps_kernel_at_the_waymo_shape(cuda):
    """Waymo IA-SSD's layer 0: (2, 65536) -> 16384, the kernel's largest N,
    on scans in the Waymo range."""
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    xyz = torch.from_numpy(np.ascontiguousarray(synthetic_scan_batch(
        8, 2, 65536, (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0))[..., :3]))
    xyz = xyz.to(cuda)
    got = farthest_point_sample_kernel(xyz, 16384)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(xyz, 16384))


@pytest.mark.parametrize('n,m,r', [(512, 128, 0.2), (128, 32, 0.4)])
def test_ball_query_kernel_at_the_roi_shapes(cuda, n, m, r):
    """The RoI SA layers' balls: 16 neighbours at r 0.2 around 128 FPS
    picks of 512 points, at r 0.4 around 32 of 128, over 800 rows with
    empty and padded RoIs (centers on points, many duplicates)."""
    xyz = _roi_rows(n + 1, 800, n).to(cuda)
    ctr = xyz.gather(1, farthest_point_sample_kernel(xyz, m)[..., None]
                     .expand(-1, -1, 3)).contiguous()
    got = ball_query_multi_kernel((r,), (16,), xyz, ctr)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, ball_query_multi_plain((r,), (16,), xyz, ctr)[0])


@pytest.mark.parametrize('n,npoint', [(512, 128), (128, 32)])
def test_fps_kernel_at_the_roi_train_shapes(cuda, n, npoint):
    """PointRCNN training's RoI SA layers: ROI_PER_IMAGE 128 x B = 2 rows,
    (256, 512) -> 128 and (256, 128) -> 32, with empty and padded RoIs."""
    xyz = _roi_rows(n + 2, 256, n).to(cuda)
    got = farthest_point_sample_kernel(xyz, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(xyz, npoint))


@pytest.mark.parametrize('n,m,r', [(512, 128, 0.2), (128, 32, 0.4)])
def test_ball_query_kernel_at_the_roi_train_shapes(cuda, n, m, r):
    """The RoI SA layers' balls over the 256 rows of a PointRCNN train
    step (16 neighbours at r 0.2 and 0.4)."""
    xyz = _roi_rows(n + 3, 256, n).to(cuda)
    ctr = xyz.gather(1, farthest_point_sample_kernel(xyz, m)[..., None]
                     .expand(-1, -1, 3)).contiguous()
    got = ball_query_multi_kernel((r,), (16,), xyz, ctr)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, ball_query_multi_plain((r,), (16,), xyz, ctr)[0])


@pytest.mark.parametrize('layer', [0, 1, 2, 3])
def test_kernels_at_the_pointrcnn_train_backbone_shapes(cuda, layer):
    """PointRCNN training's backbone at BATCH_SIZE_PER_GPU 2: FPS (2,
    16384) -> 4096 -> 1024 -> 256 -> 64 on a scan, each layer's MSG ball
    query (radii 0.1 / 0.5 ... 2.0 / 4.0, 16 / 32 neighbours) around its
    picks."""
    radii = [(0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0)][layer]
    xyz = _scans(11, 2, 16384).to(cuda)
    for npoint in (4096, 1024, 256, 64)[:layer + 1]:
        idx = farthest_point_sample_kernel(xyz, npoint)
        torch.cuda.synchronize()
        assert torch.equal(idx, farthest_point_sample_plain(xyz, npoint))
        xyz, prev = xyz.gather(1, idx[..., None].expand(-1, -1, 3)) \
            .contiguous(), xyz
    got = ball_query_multi_kernel(radii, (16, 32), prev, xyz)
    torch.cuda.synchronize()
    for g, w in zip(got, ball_query_multi_plain(radii, (16, 32), prev, xyz)):
        assert torch.equal(g, w)


def test_chunked_fps_is_one_kernel_launch(cuda):
    """Chunked FPS of (8, 16384) -> 4096 in 4 slices: one exact-FPS launch
    over (32, 4096) -> 1024, and the CPU's plain picks."""
    xyz = _scans(9, 8, 16384)
    _build.reset_launches()
    got = sampling.farthest_point_sample_chunked(xyz.to(cuda), 4096, 4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['fps'] == 1
    assert torch.equal(got.cpu(),
                       sampling.farthest_point_sample_chunked(xyz, 4096, 4))


def _pv_rcnn_frames(seed, b):
    """``b`` synthetic scans of 16384 points, pv_rcnn.yaml's config and the
    port's host voxel batch of them."""
    from spsnet_torch.data.processor import voxel_batch
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    from spsnet_torch.zoo import pv_rcnn_kitti_cfg
    cfg = pv_rcnn_kitti_cfg()
    batch = voxel_batch(synthetic_scan_batch(seed, b, 16384), cfg.DATA_CONFIG)
    return cfg, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize('B', [2, 8])
def test_fps_kernel_at_the_pvrcnn_keypoint_shape(cuda, B):
    """The VSA's keypoints: (B, 16384) -> 2048 on a scan."""
    xyz = _scans(12, B, 16384).to(cuda)
    got = farthest_point_sample_kernel(xyz, 2048)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(xyz, 2048))


@pytest.mark.parametrize('source', ['raw_points', 'x_conv1', 'x_conv2',
                                    'x_conv3', 'x_conv4'])
def test_ball_query_kernel_at_the_vsa_shapes(cuda, source):
    """Each VSA source's fused query around 2048 keypoints of 2 scans: the
    raw points (N 16384) and the voxel centers of each sparse level (N
    40000, padded voxels at 1e6), at pv_rcnn.yaml's radii and neighbours."""
    from spsnet_torch.models.pfe.voxel_set_abstraction import \
        VoxelSetAbstraction
    cfg, batch = _pv_rcnn_frames(13, 2)
    vsa = VoxelSetAbstraction(cfg.MODEL.PFE, (0.05, 0.05, 0.1),
                              cfg.DATA_CONFIG.POINT_CLOUD_RANGE, 256,
                              1).to(cuda)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    xyz = batch['points'][..., :3].contiguous()
    kp = xyz.gather(1, farthest_point_sample_kernel(xyz, 2048)[..., None]
                    .expand(-1, -1, 3)).contiguous()
    group = vsa.SA_rawpoints if source == 'raw_points' else \
        vsa.SA_layers[source]
    support = xyz if source == 'raw_points' else \
        vsa.voxel_centers(batch, source)
    assert support.shape[1] == (16384 if source == 'raw_points' else 40000)
    got = ball_query_multi_kernel(group.radii, group.nsamples, support, kp)
    torch.cuda.synchronize()
    for g, w in zip(got, ball_query_multi_plain(group.radii, group.nsamples,
                                                support, kp)):
        assert torch.equal(g, w)


def test_ball_query_kernel_at_the_roi_grid_shape(cuda):
    """The RoI-grid pool: 100 RoIs x 6^3 grid points a frame (21 600
    centers) over 2048 keypoints, r 0.8 / 1.6, 16 neighbours each."""
    from spsnet_torch.models.roi_heads.pvrcnn_head import (grid_template,
                                                           roi_grid_points)
    xyz = _scans(14, 2, 16384).to(cuda)
    kp = xyz.gather(1, farthest_point_sample_kernel(xyz, 2048)[..., None]
                    .expand(-1, -1, 3)).contiguous()
    rng = np.random.default_rng(15)
    rois = torch.cat([kp[:, :100], torch.from_numpy(np.concatenate([
        np.broadcast_to(np.float32([3.9, 1.6, 1.56]), (2, 100, 3)),
        rng.uniform(-np.pi, np.pi, (2, 100, 1)).astype(np.float32)],
        -1)).to(cuda)], -1)
    grid = roi_grid_points(rois, torch.from_numpy(grid_template(6)).to(
        cuda)).reshape(2, -1, 3).contiguous()
    assert grid.shape == (2, 21600, 3)
    got = ball_query_multi_kernel((0.8, 1.6), (16, 16), kp, grid)
    torch.cuda.synchronize()
    for g, w in zip(got, ball_query_multi_plain((0.8, 1.6), (16, 16), kp,
                                                grid)):
        assert torch.equal(g, w)


def test_sparse_gather_on_the_card_matches_the_cpu(cuda):
    """The sparse convolutions' gather, (2, 40000, 64) features by a
    subm table of the KITTI plan, sentinel rows zero: exact."""
    from spsnet_torch.models.backbones_3d.spconv_backbone import \
        sparse_gather
    _, batch = _pv_rcnn_frames(16, 2)
    feats = torch.from_numpy(np.random.default_rng(17).normal(
        size=(2, 40000, 64)).astype(np.float32))
    table = batch['subm3_table']
    got = sparse_gather(feats.to(cuda), table.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sparse_gather(feats, table))


def test_voxel_forward_on_the_card_matches_the_cpu(cuda):
    """pv_rcnn.yaml's voxel stack at full width on one scan, seeded
    weights: voxel features, every sparse level, the BEV map and the
    anchor head's predictions card vs CPU within 1e-4 relative plus 1e-4
    of each tensor's largest entry (cuBLAS and cuDNN against the CPU's
    sums over K up to 27 x 64 and 9 x 256, TF32 off)."""
    from spsnet_torch.models import build_detector_from_cfg
    cfg, batch = _pv_rcnn_frames(18, 1)
    gpu = build_detector_from_cfg(cfg, device='cuda')
    cpu = build_detector_from_cfg(cfg, device='cpu')
    with torch.no_grad():
        g = gpu.stage_one({k: v.to(cuda) for k, v in batch.items()})
        c = cpu.stage_one(dict(batch))

    def close(a, b, what):
        scale = float(b.abs().max())
        assert scale > 0, what
        assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4 * scale), what
    close(g['voxel_features'], c['voxel_features'], 'voxel features')
    for name, t in c['multi_scale_3d_features'].items():
        close(g['multi_scale_3d_features'][name], t, name)
    for key in ('spatial_features', 'spatial_features_2d'):
        close(g[key], c[key], key)
    for key in ('cls_preds', 'box_preds', 'dir_preds'):
        close(g['anchor_head_ret'][key], c['anchor_head_ret'][key], key)
