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
CPU. At the shapes of Voxel R-CNN: the RoI grid's query over the voxel
centers of x_conv2-4 at 40 000 and 16 000 rows (KITTI serving and
training) and 150 000 (Waymo); CenterPoint's heatmap targets card against
the CPU. For the three-NN kernel: ties and duplicate points, M = 3, M off
2048, one query, padded rows at 1e6 past the valid prefix, coordinates
at 70 m, the scan rules' edge cases of ``tests/three_nn_cases.py``
(padded suffixes of 0-3 and M - 3 rows, all rows equal, an equal run in
the middle, voxel centres in z-major order, queries at 1e6, NaN and inf,
+-0 and 1e-20, M no multiple of 32), B from 1 to 8 and PV-RCNN++'s three
VectorPool shapes; its pairs counter against the plain tiled scan's, and
at x_conv3's shape below the pairs of the unculled prefix; the masked FPS
at the sector masks of a Waymo scan. Indices must be equal, and the min
distances to the seeds and the three-NN distances bit for bit.

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
from three_nn_cases import CASES as NN_CASES, three_nn_case

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


def test_anchor_targets_on_the_card_match_the_cpu(cuda):
    """pv_rcnn.yaml's 211 200 anchors against two frames of 24 synthetic
    gt boxes turned by up to pi/4, classes 1, 2, 3 in turn: the labels,
    the matched gt and the force matches identical (the same elementwise
    fp32 ops, each rounded alike), the regression targets within 1e-5
    (log and sqrt of two libraries)."""
    from spsnet_torch.models import build_detector_from_cfg
    from spsnet_torch.utils.synthetic import synthetic_scene_batch
    from spsnet_torch.zoo import pv_rcnn_kitti_cfg
    head = build_detector_from_cfg(pv_rcnn_kitti_cfg(),
                                   device='cpu').dense_head
    _, gt = synthetic_scene_batch(19, 2, 1024)
    gt[..., 6] = np.random.default_rng(20).uniform(-np.pi / 4, np.pi / 4,
                                                   gt.shape[:2])
    gt[..., 7] = np.arange(gt.shape[1]) % 3 + 1
    gt = torch.from_numpy(gt)
    cpu = head.assign_targets(gt)
    card = head.to(cuda).assign_targets(gt.to(cuda))
    torch.cuda.synchronize()
    for k in (0, 2, 3, 4):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    assert torch.allclose(card[1].cpu(), cpu[1], rtol=0, atol=1e-5)
    labels = cpu[0]
    assert set(labels.unique().tolist()) == {-1, 0, 1, 2, 3}
    assert (cpu[4] & (labels > 0)).any()


def test_tiny_pvrcnn_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``make_train_step`` step of a tiny PV-RCNN (``tiny_pvrcnn_cfg``
    on a 12.8 x 12.8 m range of 0.8 m voxels, 96 a frame) on a
    ``voxel_batch(mode='train')`` of two synthetic scenes with gt boxes,
    on the card and on the CPU from the same weights and step
    generators (two of the gt boxes on anchors): one FPS and four
    ball-query launches (the VSA's three grouped sources, the RoI grid),
    the anchor and keypoint labels identical, every loss term within 1e-3
    relative, every gradient finite and every parameter moved."""
    import copy
    from spsnet_torch.config import EDict
    from spsnet_torch.data.processor import voxel_batch
    from spsnet_torch.data.processor.sparse_plan import plan_final_grid
    from spsnet_torch.data.processor.voxelize import sparse_grid_zyx
    from spsnet_torch.models import build_detector_from_cfg
    from spsnet_torch.runtime import optimization
    from spsnet_torch.runtime.trainer import make_train_step
    from spsnet_torch.utils.synthetic import synthetic_scene_batch
    from spsnet_torch.zoo import tiny_pvrcnn_cfg
    pcr, vs = (0, -6.4, -3, 12.8, 6.4, 1), (0.8, 0.8, 0.0625)
    optim = EDict({'OPTIMIZER': 'adam_onecycle', 'LR': 0.01,
                   'WEIGHT_DECAY': 0.01, 'MOMS': [0.95, 0.85],
                   'PCT_START': 0.4, 'DIV_FACTOR': 10,
                   'GRAD_NORM_CLIP': 10})
    cfg = EDict({
        'CLASS_NAMES': ['Car'], 'OPTIMIZATION': optim,
        'MODEL': tiny_pvrcnn_cfg(plan_final_grid(sparse_grid_zyx(pcr, vs))),
        'DATA_CONFIG': {
            'POINT_CLOUD_RANGE': list(pcr), 'DATA_PROCESSOR': [
                {'NAME': 'transform_points_to_voxels',
                 'VOXEL_SIZE': list(vs), 'MAX_POINTS_PER_VOXEL': 5,
                 'MAX_NUMBER_OF_VOXELS': {'train': 96, 'test': 160}},
                {'NAME': 'build_sparse_conv_plan'}]}})
    pts, gt = synthetic_scene_batch(22, 2, 512, pc_range=pcr, n_clusters=6)
    # two cars on anchors of each frame, whose proposals stay near them
    # with the anchor head's box layer at 1e-2: foreground RoIs, so that
    # the RoI head's regression tower takes a gradient
    cars = np.float32([[0.1, -6.3, -1.0, 3.9, 1.6, 1.56, 0.05, 1],
                       [12.7, 6.3, -1.0, 3.8, 1.7, 1.5, 1.6, 1]])
    gt = np.concatenate([gt, np.broadcast_to(cars, (2, 2, 8))], 1)
    batch = {k: torch.from_numpy(v) for k, v in voxel_batch(
        pts, cfg.DATA_CONFIG, mode='train', gt_boxes=list(gt)).items()}
    cpu = build_detector_from_cfg(cfg, device='cpu').train()
    with torch.no_grad():
        for p in cpu.dense_head.conv_box.parameters():
            p.mul_(1e-2)
    gpu = copy.deepcopy(cpu).to(cuda)
    outs = {}
    for name, model in (('cpu', cpu), ('gpu', gpu)):
        model.register_forward_hook(
            lambda m, a, out, name=name: outs.__setitem__(name, out))
    results = {}
    for name, model, device in (('cpu', cpu, 'cpu'), ('gpu', gpu, cuda)):
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt = optimization.build_optimizer(optim, model.parameters(), 10, 2)
        _build.reset_launches()
        loss, tb = make_train_step(model, opt)(
            {k: v.to(device) for k, v in batch.items()})
        if device == cuda:
            torch.cuda.synchronize()
            assert _build.LAUNCHES['fps'] == 1
            assert _build.LAUNCHES['ball_query'] == 4
        for k, p in model.named_parameters():
            assert torch.isfinite(p.grad).all(), k
            assert not torch.equal(p.detach(), before[k]), k
        results[name] = {k: float(v) for k, v in dict(tb, loss=loss).items()}
    for key, c in results['cpu'].items():
        assert abs(results['gpu'][key] - c) <= 1e-3 * abs(c), key
    for get in (lambda o: o['anchor_head_ret']['box_cls_labels'],
                lambda o: o['point_head_simple_ret']['targets'].cls_labels):
        assert torch.equal(get(outs['gpu']).cpu(), get(outs['cpu']))


def _voxel_rcnn_levels(cuda, path, b, n, train, seed):
    """The port's host voxel batch of ``b`` synthetic scans of ``n``
    points (5 channels where the config reads them) at a config's test
    or train voxel limit, on the card, and each of its RoI head's source
    levels as (radii, nsamples, voxel centers)."""
    from spsnet_torch.data.processor import voxel_batch
    from spsnet_torch.models import build_detector_from_cfg
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    from spsnet_torch.zoo import load_yaml_cfg
    cfg = load_yaml_cfg(path)
    scans = synthetic_scan_batch(seed, b, n,
                                 pc_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    channels = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    if channels > 4:
        scans = np.concatenate([scans, np.full_like(scans[..., :1], 0.5)],
                               -1)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in voxel_batch(
        scans, cfg.DATA_CONFIG, mode='train' if train else 'test').items()}
    head = build_detector_from_cfg(cfg, device='cpu').roi_head.to(cuda)
    levels = [(layer.radii, layer.nsamples, head.level_centers(batch, name))
              for name, layer in head.roi_grid_pool_layers.items()]
    return batch, head, levels


@pytest.mark.parametrize('path,b,n,rois,train,rows', [
    ('kitti_models/voxel_rcnn_car.yaml', 2, 16384, 100, False, 40000),
    ('kitti_models/voxel_rcnn_car.yaml', 2, 16384, 128, True, 16000),
    ('waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml', 1, 65536,
     100, False, 150000)])
def test_ball_query_kernel_at_the_voxel_rcnn_shapes(cuda, path, b, n, rois,
                                                    train, rows):
    """Voxel R-CNN's RoI grid, ``rois`` RoIs a frame x 6^3 grid points
    (43 200 centers in serving, 55 296 in training, 21 600 on Waymo) over
    the voxel centers of x_conv2-4 (every level padded to ``rows`` rows,
    the padded ones at 1e6), r 0.4 / 0.8 / 1.6 with 16 neighbours: the
    kernel's indices equal the plain query's, which takes (B, 1024, N)
    distances a block of centers at a time."""
    from spsnet_torch.models.roi_heads.pvrcnn_head import roi_grid_points
    batch, head, levels = _voxel_rcnn_levels(cuda, f'tools/cfgs/{path}', b,
                                             n, train, 21)
    assert batch['down4_valid'].shape[1] == rows
    # RoIs of a car's size centred on the finest level's voxels
    centers = levels[0][2]
    rng = np.random.default_rng(22)
    pick = torch.from_numpy(rng.integers(0, 2000, (b, rois))).to(cuda)
    rois_t = torch.cat([centers.gather(1, pick[..., None].expand(-1, -1, 3)),
                        torch.from_numpy(np.concatenate([np.broadcast_to(
                            np.float32([3.9, 1.6, 1.56]), (b, rois, 3)),
                            rng.uniform(-np.pi, np.pi, (b, rois, 1)).astype(
                                np.float32)], -1)).to(cuda)], -1)
    grid = roi_grid_points(rois_t, head.template).reshape(b, -1, 3)
    grid = grid.contiguous()
    assert grid.shape[1] == rois * 216
    hits = 0
    for radii, nsamples, support in levels:
        got = ball_query_multi_kernel(radii, nsamples, support, grid)
        torch.cuda.synchronize()
        want = ball_query_multi_plain(radii, nsamples, support, grid)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        hits += int((got[0][..., 1] > got[0][..., 0]).sum())
    assert hits > 0


def test_center_targets_on_the_card_match_the_cpu(cuda):
    """CenterPoint's heatmap targets of waymo_models/centerpoint.yaml's
    map (188 x 188 at stride 8) for 2 frames of 40 boxes of the three
    classes, with padding rows and boxes past the range: the heatmap,
    the centre pixels, masks and raw gt bit for bit (the Gaussians' exp
    in float64, rounded once), the regression targets within 1e-6."""
    from spsnet_torch.models.dense_heads.center_head import \
        assign_center_targets
    rng = np.random.default_rng(23)
    gt = np.zeros((2, 40, 8), np.float32)
    gt[:, :36, 0:2] = rng.uniform(-80, 80, (2, 36, 2))
    gt[:, :36, 2] = rng.uniform(-1, 1, (2, 36))
    gt[:, :36, 3:6] = rng.uniform([0.5, 0.5, 1.0], [12, 3, 4], (2, 36, 3))
    gt[:, :36, 6] = rng.uniform(-np.pi, np.pi, (2, 36))
    gt[:, :36, 7] = np.arange(36) % 3 + 1
    gt = torch.from_numpy(gt)
    args = (3, (188, 188), 8, (0.1, 0.1, 0.15),
            (-75.2, -75.2, -2, 75.2, 75.2, 4))
    cpu = assign_center_targets(gt, *args, num_max_objs=500)
    card = assign_center_targets(gt.to(cuda), *args, num_max_objs=500)
    torch.cuda.synchronize()
    for k in (0, 2, 3, 4):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    assert torch.allclose(card[1].cpu(), cpu[1], rtol=0, atol=1e-6)
    assert int((cpu[0] == 1).sum()) >= 30


def _three_nn_both(unknown, known):
    from spsnet_torch.ops.interpolate import three_nn_kernel, three_nn_plain
    got = three_nn_kernel(unknown, known)
    torch.cuda.synchronize()
    want = three_nn_plain(unknown, known)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    return got


@pytest.mark.parametrize('case', ['ties', 'duplicates', 'm3', 'off_tile',
                                  'one_query', 'far_rows', 'at_70m',
                                  *NN_CASES])
def test_three_nn_kernel_matches_plain(cuda, case):
    """K6 against the plain three-NN, distances bit for bit: a lattice
    (equal distances all along the row), every known point twice (tied
    pairs far apart in index order), M = 3, M = 2049, one query, a valid
    prefix with the rows past it at 1e6 (a padded sparse level),
    coordinates out to 70 m, and the scan rules' edge cases
    (``three_nn_case``)."""
    if case in NN_CASES:
        unknown, known = three_nn_case(case, 2, 1000, 5000)
        _three_nn_both(torch.from_numpy(unknown).to(cuda),
                       torch.from_numpy(known).to(cuda))
        return
    rng = np.random.default_rng(len(case))
    n, m = 1000, 5000
    known = rng.normal(size=(2, m, 3)) * 5
    unknown = rng.normal(size=(2, n, 3)) * 5
    if case == 'ties':
        g = np.arange(18, dtype=np.float64) * 0.5
        lat = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
        known = np.stack([np.roll(lat, 7 * b, 0) for b in range(2)])
        unknown = known[:, ::5] + 0.25
    elif case == 'duplicates':
        known = np.concatenate([known[:, :m // 2]] * 2, axis=1)
    elif case == 'm3':
        known = known[:, :3]
    elif case == 'off_tile':
        known = known[:, :2049]
    elif case == 'one_query':
        unknown = unknown[:, :1]
    elif case == 'far_rows':
        known[:, 3000:] = 1e6
    else:
        known = rng.uniform([0, -40, -3], [70.4, 40, 1], (2, m, 3))
        unknown = known[:, :n] + rng.normal(size=(2, n, 3)) * 0.3
    _three_nn_both(torch.from_numpy(unknown.astype(np.float32)).to(cuda),
                   torch.from_numpy(known.astype(np.float32)).to(cuda))


@pytest.mark.parametrize('B', [1, 2, 3, 5, 8])
def test_three_nn_kernel_every_batch_size(cuda, B):
    rng = np.random.default_rng(B)
    known = torch.from_numpy((rng.normal(size=(B, 3001, 3)) * 20).astype(
        np.float32)).to(cuda)
    unknown = torch.from_numpy((rng.normal(size=(B, 777, 3)) * 20).astype(
        np.float32)).to(cuda)
    _three_nn_both(unknown, known)


def _waymo_scan(seed, b, n=65536):
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    return synthetic_scan_batch(seed, b, n, pc_range=(-75.2, -75.2, -2, 75.2,
                                                      75.2, 4))[..., :3]


@pytest.mark.parametrize('source,groups,rows', [
    ('raw_points', 8, 65536), ('x_conv3', 27, 150000),
    ('x_conv4', 27, 150000)])
def test_three_nn_kernel_at_the_vector_pool_shapes(cuda, source, groups,
                                                   rows):
    """PV-RCNN++'s VSA: the cell centres of 4096 keypoints (grids of 2^3
    or 3^3 cells) over a Waymo scan's 65 536 points, or over a level's
    150 000 rows (50 000 voxel centres, the rest padded at 1e6)."""
    from spsnet_torch.models.model_utils.vector_pool import grid_offsets
    scan = _waymo_scan(31, 1)
    if rows == 65536:
        known = scan
    else:
        known = np.full((1, rows, 3), 1e6, np.float32)
        known[:, :50000] = np.round(scan[:, :50000] / 0.4) * 0.4 + 0.2
    kp = scan[:, ::16]
    side = 2 if groups == 8 else 3
    offs = grid_offsets([side] * 3, 0.2 if groups == 8 else 1.2)
    centers = (kp[:, :, None] + offs).reshape(1, -1, 3)
    d2, _ = _three_nn_both(torch.from_numpy(centers).to(cuda),
                           torch.from_numpy(known.astype(np.float32)).to(
                               cuda))
    assert float(d2[..., 2].max()) < 1e6, source


@pytest.mark.parametrize('case', ['voxel_order', 'queries_at_1e6',
                                  'suffix_m3', 'run_in_middle', 'nan_inf',
                                  'm_off_32'])
def test_three_nn_kernel_counts_the_pairs_of_the_tiled_scan(cuda, case):
    """K6's pairs counter reads what the plain tiled scan (the same rules:
    rows to three past the padded run's start, sub-tiles culled by warps
    of 32 queries) evaluates, batch row by batch row; both give the plain
    three-NN's bits. The counter adds to what it holds."""
    from spsnet_torch.ops.interpolate import (three_nn_kernel,
                                              three_nn_tiled_plain)
    unknown, known = (torch.from_numpy(a).to(cuda) for a in three_nn_case(
        case, 2, 300, 3000))
    pairs = torch.full((2,), 5, dtype=torch.int64, device=cuda)
    got = three_nn_kernel(unknown, known, pairs)
    torch.cuda.synchronize()
    dist, idx, want = three_nn_tiled_plain(unknown, known)
    assert torch.equal(got[1], idx)
    assert torch.equal(got[0].view(torch.int32), dist.view(torch.int32))
    assert pairs.cpu().tolist() == (want + 5).tolist()
    _three_nn_both(unknown, known)


def test_three_nn_kernel_scans_fewer_pairs_at_x_conv3(cuda):
    """At the x_conv3 shape of PV-RCNN++'s VSA (4096 keypoints x 27 cells
    against a level of 150 000 rows: a Waymo scan's 0.4 m voxel centres in
    z-major key order, the rest padded at 1e6), the suffix rule leaves
    the occupied prefix and three rows, and the culling scans fewer pairs
    than that prefix holds; the answer is the plain three-NN's."""
    from spsnet_torch.models.model_utils.vector_pool import grid_offsets
    from spsnet_torch.ops.interpolate import (three_nn_kernel,
                                              three_nn_scan_rows)
    scan = _waymo_scan(31, 1)
    keys = np.unique(np.floor((scan + [75.2, 75.2, 2]) / 0.4).astype(
        np.int64) @ [1, 376, 376 * 376])
    z, rem = np.divmod(keys, 376 * 376)
    y, x = np.divmod(rem, 376)
    known = np.full((1, 150000, 3), 1e6, np.float32)
    known[0, :len(keys)] = np.stack([x, y, z], -1) * 0.4 + 0.2 - \
        [75.2, 75.2, 2]
    centers = (scan[:, ::16, None] + grid_offsets([3] * 3, 1.2)).reshape(
        1, -1, 3)
    unknown = torch.from_numpy(centers.astype(np.float32)).to(cuda)
    known = torch.from_numpy(known).to(cuda)
    pairs = torch.zeros(1, dtype=torch.int64, device=cuda)
    three_nn_kernel(unknown, known, pairs)
    torch.cuda.synchronize()
    rows = int(three_nn_scan_rows(known)[0])
    n = unknown.shape[1]
    assert rows == len(keys) + 3 < 150000
    assert 0 < int(pairs[0]) < n * rows
    _three_nn_both(unknown, known)


def test_masked_fps_kernel_at_the_sector_masks(cuda):
    """PV-RCNN++'s sector FPS: one masked FPS a sector of a 65 536-point
    Waymo scan's points near RoIs (a random half here), six sectors, the
    quota prefix and K = 4096 picks; one sector with fewer points than K
    (the points of a thin wedge)."""
    from spsnet_torch.models.pfe.voxel_set_abstraction import point_sectors
    xyz = torch.from_numpy(_waymo_scan(32, 2)).to(cuda)
    rng = np.random.default_rng(33)
    near = torch.from_numpy(rng.uniform(size=(2, 65536)) < 0.5).to(cuda)
    sector = point_sectors(xyz, 6)
    ang = torch.atan2(xyz[..., 1], xyz[..., 0])
    near[1] &= (sector[1] != 2) | (ang[1].abs() < 0.02)  # a thin sector 2
    for s in range(6):
        m = (near & (sector == s)).contiguous()
        for k in (4096, 700):
            got = farthest_point_sample_kernel(xyz, k, m)
            torch.cuda.synchronize()
            assert torch.equal(got, farthest_point_sample_plain(xyz, k, m))
    assert int((near[1] & (sector[1] == 2)).sum()) < 4096


# ---------------------------------------------------------------- pillars

def _pillar_frames(seed, b, dynamic=False, n=16384):
    """``b`` synthetic scans of ``n`` points (5 channels for Waymo) and the
    port's host batch of them: kitti_models/pointpillar.yaml's pillars, or
    with ``dynamic`` waymo_models/centerpoint_dyn_pillar_1x.yaml's sampled
    points; the config."""
    from spsnet_torch.data.processor import voxel_batch
    from spsnet_torch.utils.synthetic import synthetic_scan_batch
    from spsnet_torch.zoo import centerpoint_pillar_waymo_cfg, \
        pointpillar_kitti_cfg
    cfg = centerpoint_pillar_waymo_cfg(dynamic=True) if dynamic else \
        pointpillar_kitti_cfg()
    pcr = tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    scans = synthetic_scan_batch(seed, b, n, pc_range=pcr)
    if dynamic:
        scans = np.concatenate([scans, np.random.default_rng(seed).uniform(
            0, 1, (b, n, 1)).astype(np.float32)], axis=-1)
    batch = voxel_batch(scans, cfg.DATA_CONFIG,
                        rng=np.random.RandomState(seed))
    return cfg, {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_scaled(a, b, what):
    scale = float(b.abs().max())
    assert scale > 0, what
    assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4 * scale), what


def test_pillar_scatter_on_the_card_matches_the_cpu(cuda):
    """pointpillar.yaml's scatter of (2, 40000, 64) pillar features with
    the padded pillars dropped: bit for bit the CPU's canvas."""
    from spsnet_torch.models.map_to_bev import PointPillarScatter
    _, batch = _pillar_frames(40, 2)
    feats = torch.from_numpy(np.random.default_rng(41).normal(
        size=(2, 40000, 64)).astype(np.float32))
    scatter = PointPillarScatter((432, 496, 1))
    host = dict(batch, pillar_features=feats)
    got = scatter({k: v.to(cuda) for k, v in host.items()})
    assert torch.equal(got['spatial_features'].cpu(),
                       scatter(host)['spatial_features'])


@pytest.mark.parametrize('train', [False, True])
def test_pillar_vfe_on_the_card_matches_the_cpu(cuda, train):
    """pointpillar.yaml's PillarVFE at full width on one scan (40 000
    pillars of 32 slots), seeded weights: the features within 1e-4
    relative plus 1e-4 of the largest entry; in training the BatchNorm's
    running statistics over all 1.28 M rows alike, and the gradient at the
    pillars' points (the max's split among tied slots)."""
    from spsnet_torch.models import build_detector_from_cfg
    cfg, batch = _pillar_frames(42, 1)
    models = [build_detector_from_cfg(cfg, device=d).vfe.train(train)
              for d in ('cuda', 'cpu')]
    models[1].load_state_dict(models[0].state_dict())
    outs, grads = [], []
    for vfe, dev in zip(models, (cuda, 'cpu')):
        voxels = batch['voxels'].to(dev).requires_grad_()
        out = vfe(dict({k: v.to(dev) for k, v in batch.items()},
                       voxels=voxels))['pillar_features']
        w = torch.from_numpy(np.random.default_rng(43).normal(
            size=out.shape).astype(np.float32)).to(dev)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append(voxels.grad)
    _close_scaled(outs[0], outs[1], 'pillar features')
    _close_scaled(grads[0], grads[1], 'gradient at the points')
    if train:
        for name, t in models[1].state_dict().items():
            if name.endswith(('running_mean', 'running_var')):
                _close_scaled(models[0].state_dict()[name], t, name)


def test_dynamic_pillar_ids_on_the_card_match_the_cpu(cuda):
    """centerpoint_dyn_pillar_1x.yaml's DynamicPillarVFE on two sampled
    Waymo scans of 65 536 points with points on and an ulp from pillar
    boundaries: every point's pillar ids and mask identical (true
    quotients on both), the occupied cells identical, the canvas within
    1e-4 relative plus 1e-4 of its largest entry (the pillar means sum in
    another order)."""
    from spsnet_torch.models import build_detector_from_cfg
    cfg, batch = _pillar_frames(44, 2, dynamic=True, n=70000)
    pts = batch['points']
    k = torch.from_numpy(np.random.default_rng(45).integers(1, 468, 2000))
    edge = np.float32(-74.88) + k.float() * np.float32(0.32)
    pts[:, :2000, 0] = edge
    pts[:, 2000:4000, 1] = torch.nextafter(edge, torch.tensor(-1e9))
    gpu = build_detector_from_cfg(cfg, device='cuda').vfe
    cpu = build_detector_from_cfg(cfg, device='cpu').vfe
    cpu.load_state_dict(gpu.state_dict())
    with torch.no_grad():
        g_ids = gpu.pillar_index({'points': pts.to(cuda)})
        c_ids = cpu.pillar_index({'points': pts})
        for a, b in zip(g_ids, c_ids):
            assert torch.equal(a.cpu(), b)
        g = gpu({'points': pts.to(cuda)})['spatial_features']
        c = cpu({'points': pts})['spatial_features']
    assert torch.equal((g != 0).any(1).cpu(), (c != 0).any(1))
    _close_scaled(g, c, 'canvas')


def test_dynamic_pillar_vfe_run_to_run_spread_on_the_card(cuda):
    """Two card calls of the dynamic VFE on the same batch: the pillar
    means' segment sums take their atomics in another order, so the
    canvases may differ in the last bits; they stay within 1e-5 of the
    largest entry (the spread is printed)."""
    from spsnet_torch.models import build_detector_from_cfg
    cfg, batch = _pillar_frames(46, 2, dynamic=True, n=70000)
    vfe = build_detector_from_cfg(cfg, device='cuda').vfe
    pts = batch['points'].to(cuda)
    with torch.no_grad():
        a, b = (vfe({'points': pts})['spatial_features'] for _ in range(2))
    spread = float((a - b).abs().max())
    print(f'dynamic pillar canvas, two card calls: largest difference '
          f'{spread:.3e} of {float(a.abs().max()):.3e}')
    assert spread <= 1e-5 * float(a.abs().max())


@pytest.mark.parametrize('name', ['pointpillar', 'centerpoint_dyn'])
def test_pillar_forward_on_the_card_matches_the_cpu(cuda, name):
    """pointpillar.yaml and centerpoint_dyn_pillar_1x.yaml at full width
    on one scan, seeded weights: the BEV map, the BEV backbone's output
    and the head's maps card vs CPU within 1e-4 relative plus 1e-4 of
    each tensor's largest entry."""
    from spsnet_torch.models import build_detector_from_cfg
    cfg, batch = _pillar_frames(47, 1, dynamic=name != 'pointpillar',
                                n=65536 if name != 'pointpillar' else 16384)
    gpu = build_detector_from_cfg(cfg, device='cuda')
    cpu = build_detector_from_cfg(cfg, device='cpu')
    with torch.no_grad():
        g = gpu.stage_one({k: v.to(cuda) for k, v in batch.items()})
        c = cpu.stage_one(dict(batch))
    for key in ('spatial_features', 'spatial_features_2d'):
        _close_scaled(g[key], c[key], key)
    if name == 'pointpillar':
        for key in ('cls_preds', 'box_preds', 'dir_preds'):
            _close_scaled(g['anchor_head_ret'][key],
                          c['anchor_head_ret'][key], key)
    else:
        for pg, pc in zip(g['center_head_iou_ret']['pred_dicts'],
                          c['center_head_iou_ret']['pred_dicts']):
            for key in pg:
                _close_scaled(pg[key], pc[key], key)
