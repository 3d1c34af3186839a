"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases that the main path's shapes do not reach: N and M off the
kernels' tiles, balls that are empty or hit exactly on the radius, more
than 32 slots, one or three radii, masks with too few valid points, the
shared-memory and register limits of the FPS kernel. Indices must be equal.

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
from spsnet_torch.ops.sampling import (farthest_point_sample_kernel,
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
