"""The port's seeded FPS against the JAX package on the CPU.

Seeded FPS is the JAX package's default D-FPS on its accelerator; on the
CPU the JAX package never seeds, so its seeded functions are called
directly, the Pallas kernels in interpret mode. The port runs its plain
versions here (CPU tensors), the versions its CUDA kernels (``seed_min``,
``fps_seeded``) are held to on the card. Indices must match exactly. The
min distances to the seeds match a numpy reference that rounds every
product and sum of ``(dx*dx + dy*dy) + dz*dz`` separately bit for bit (min
is exact), and the JAX function within 2 ulp: XLA's CPU backend contracts
that sum into ``fma(dz, dz, fma(dx, dx, dy*dy))`` under jit, which rounds
twice less.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu import ops as jops
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models.backbones_3d import iassd_backbone as jax_backbone
from spsnet_tpu.ops import sampling as jsampling
from spsnet_tpu.ops.pallas import fps as jfps
from spsnet_tpu.zoo import tiny_iassd_cfg as jax_tiny_iassd_cfg
from spsnet_torch import ops
from spsnet_torch.models import build_detector
from spsnet_torch.models.backbones_3d.iassd_backbone import \
    _layer_fps_ordered
from spsnet_torch.models.sa_module import SAModuleMSGWithSampling
from spsnet_torch.ops import sampling
from spsnet_torch.ops.sampling import FpsSeeding
from spsnet_torch.utils.synthetic import synthetic_scan_batch
from spsnet_torch.utils.weights import load_flax
from spsnet_torch.zoo import tiny_iassd_cfg

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

GRID = FpsSeeding(0.75, 'grid')
# seeding engages at both D-FPS layers: k0 = 384 of 512 and 128 of 256
SEEDED_NPOINTS = [[512], [256], [128], [64], [-1], [64]]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_xyz(seed, b, n):
    return synthetic_scan_batch(seed, b, n)[..., :3].copy()


def _clustered(seed, b, n):
    """Two tight clusters and a sparse background: many points share a
    grid cell, so the filler part of the grid seeds is exercised."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    xyz[:, : n // 3] = rng.normal(5, 0.3, (b, n // 3, 3))
    xyz[:, n // 3: n // 2] = rng.normal(-8, 0.2, (b, n // 2 - n // 3, 3))
    return xyz[:, rng.permutation(n)].astype(np.float32)


@pytest.mark.parametrize('fraction,mode', [(0.75, 'grid'), (0.5, 'head'),
                                           (0.9, 'grid'), (1.0, 'grid_only')])
def test_seed_k0_follows_the_jax_rule(fraction, mode, monkeypatch):
    """k0 = int(f * npoint) // 128 * 128, engaged only for 0 < k0 < npoint
    (so npoint <= 170 disengages at f = 0.75); the JAX package's pure grid
    mode (SPSNET_FPS_SEED >= 1 with grid) is the port's explicit grid_only."""
    monkeypatch.setenv('SPSNET_FPS_SEED', str(fraction))
    monkeypatch.setenv('SPSNET_FPS_SEED_MODE',
                       'grid' if mode == 'grid_only' else mode)
    seeding = FpsSeeding(fraction, mode)
    for npoint in (1, 64, 128, 170, 171, 256, 300, 512, 1000, 1024, 4096):
        assert sampling.seed_k0(seeding, npoint) == \
            jsampling.fps_seed_k0(npoint), npoint
    assert sampling.seed_k0(seeding, 4096) > 0
    assert sampling.seed_k0(None, 4096) == 0


def test_seeding_settings_are_explicit():
    assert sampling.seed_k0(GRID, 4096) == 3072
    assert sampling.seed_k0(GRID, 1024) == 768
    assert sampling.seed_k0(GRID, 170) == 0
    assert sampling.fps_seeding_active(GRID, 4096, allow_seed=True)
    assert not sampling.fps_seeding_active(GRID, 4096, allow_seed=False)
    with pytest.raises(TypeError):  # the call site's opt-in has no default
        sampling.fps_seeding_active(GRID, 4096)
    for bad in ((1.0, 'grid'), (0.0, 'head'), (0.75, 'grid_only'),
                (0.5, 'random')):
        with pytest.raises(ValueError):
            FpsSeeding(*bad)


@pytest.mark.parametrize('case,B,N,k0', [
    ('scan', 2, 2048, 384), ('scan', 1, 1000, 128),
    ('clustered', 2, 1500, 1024), ('clustered', 3, 333, 200)])
def test_grid_seed_indices_match_jax(case, B, N, k0):
    xyz = (_scan_xyz if case == 'scan' else _clustered)(N, B, N)
    got = sampling.grid_seed_indices(_t(xyz), k0).numpy()
    want = np.asarray(jfps.grid_seed_indices(jnp.asarray(xyz), k0))
    np.testing.assert_array_equal(got, want)
    for row in got:
        assert len(np.unique(row)) == k0


@pytest.mark.parametrize('B,N,k0', [(2, 640, 128), (1, 2048, 384),
                                    (3, 384, 256)])
def test_seed_min_d2_matches_the_pallas_kernel(B, N, k0):
    """K3's plain version on grid seeds of a scan: bit for bit against the
    separately rounded numpy form, within 2 ulp of ``_seed_min_d2``
    (interpret mode; the Pallas kernel takes 128-multiples)."""
    xyz = _scan_xyz(B + N, B, N)
    idx = np.asarray(jfps.grid_seed_indices(jnp.asarray(xyz), k0))
    seeds = np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)
    got = sampling.seed_min_d2(_t(xyz), _t(seeds)).numpy()
    d = xyz[:, :, None, :] - seeds[:, None, :, :]
    exact = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
             + d[..., 2] * d[..., 2]).min(axis=-1)
    np.testing.assert_array_equal(got, exact)
    want = np.asarray(jfps._seed_min_d2(jnp.asarray(xyz), jnp.asarray(seeds),
                                        interpret=True))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert (got[np.arange(B)[:, None], idx] == 0).all()


@pytest.mark.parametrize('seeds', ['head', 'grid', 'random'])
@pytest.mark.parametrize('B,N,npoint,k0', [(2, 500, 256, 128),
                                           (2, 1024, 512, 384),
                                           (1, 777, 400, 256)])
def test_seeded_fps_matches_jax(seeds, B, N, npoint, k0):
    """K3 + K4 plain against ``farthest_point_sample_seeded`` (interpret
    mode): the seeds verbatim, then the exact completion; N % 128 != 0
    included (the TPU pads, the port does not)."""
    xyz = _scan_xyz(N, B, N)
    seed_idx = None
    if seeds == 'grid':
        seed_idx = np.asarray(jfps.grid_seed_indices(jnp.asarray(xyz), k0))
    elif seeds == 'random':
        rng = np.random.default_rng(N)
        seed_idx = np.stack([rng.permutation(N)[:k0] for _ in range(B)])
    got = sampling.farthest_point_sample_seeded(
        _t(xyz), npoint, k0,
        None if seed_idx is None else _t(seed_idx.astype(np.int64))).numpy()
    want = np.asarray(jfps.farthest_point_sample_seeded(
        jnp.asarray(xyz), npoint, k0,
        None if seed_idx is None else jnp.asarray(seed_idx, jnp.int32),
        interpret=True))
    np.testing.assert_array_equal(got, want)
    head = np.arange(k0)[None] if seed_idx is None else seed_idx
    np.testing.assert_array_equal(got[:, :k0], np.broadcast_to(head, (B, k0)))


def test_dispatch_runs_seeded_fps_only_where_it_engages():
    xyz = _t(_scan_xyz(7, 2, 2048))
    got = ops.farthest_point_sample(xyz, 512, seeding=GRID)
    seed_idx = sampling.grid_seed_indices(xyz, 384)
    assert torch.equal(got, sampling.farthest_point_sample_seeded(
        xyz, 512, 384, seed_idx))
    assert torch.equal(
        ops.farthest_point_sample(xyz, 512, seeding=FpsSeeding(0.5, 'head')),
        sampling.farthest_point_sample_seeded(xyz, 512, 256))
    # disengaged (k0 rounds to 0) and unset: exact FPS
    exact = sampling.farthest_point_sample_plain(xyz, 128)
    assert torch.equal(ops.farthest_point_sample(xyz, 128, seeding=GRID),
                       exact)
    assert torch.equal(ops.farthest_point_sample(xyz, 128), exact)
    with pytest.raises(ValueError, match='valid_mask'):
        ops.farthest_point_sample(xyz, 512, torch.ones(2, 2048, dtype=bool),
                                  seeding=GRID)


def test_grid_only_takes_every_pick_from_the_grid():
    """grid_only runs no FPS step: the picks are grid_seed_indices(npoint),
    as the JAX package's pure grid sampling; a npoint that is no multiple
    of 128 disengages it."""
    xyz = _scan_xyz(8, 2, 2048)
    only = FpsSeeding(1.0, 'grid_only')
    got = ops.farthest_point_sample(_t(xyz), 512, seeding=only).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfps.grid_seed_indices(jnp.asarray(xyz), 512)))
    assert torch.equal(
        ops.farthest_point_sample(_t(xyz), 500, seeding=only),
        sampling.farthest_point_sample_plain(_t(xyz), 500))


@pytest.mark.parametrize('sampled,seeded,prev,want', [
    (True, False, False, True), (True, True, True, False),
    (False, True, True, True), (False, False, False, False)])
def test_layer_fps_ordered(sampled, seeded, prev, want):
    """A seeded layer's output is no FPS chain; a pass-through keeps its
    input's order (``iassd_backbone.py:26-39`` of the JAX package)."""
    assert _layer_fps_ordered(sampled, seeded, prev) is want


@pytest.mark.parametrize('seeding', [None, GRID])
def test_sa_layer_takes_the_prefix_shortcut_only_for_exact_fps(seeding):
    """Told that its input is an FPS chain, an exact D-FPS layer returns
    arange(npoint) without sampling; a seeded one runs its own seeded FPS.
    The input here is a shuffled scan, so the two answers differ."""
    xyz = _t(_scan_xyz(9, 2, 512))
    layer = SAModuleMSGWithSampling(
        1, [256], [-1], ['D-FPS'], [], [], [], num_class=3,
        fps_seeding=seeding)
    idx, _ = layer._sample(xyz, None, input_fps_ordered=True)
    head = torch.arange(256).expand(2, 256)
    if seeding is None:
        assert torch.equal(idx, head)
    else:
        assert torch.equal(idx, ops.farthest_point_sample(xyz, 256,
                                                          seeding=seeding))
        assert not torch.equal(idx, head)


@pytest.fixture
def jax_seeded(monkeypatch):
    """The JAX package's seeded path on the CPU, where it never seeds on
    its own: ``fps_seeding_active`` (both names) answers as on its
    accelerator at f = 0.75, and the SA-module D-FPS (``allow_seed``) runs
    ``grid_seed_indices`` and ``farthest_point_sample_seeded`` in
    interpret mode. Nothing in ``spsnet_tpu`` is edited."""
    own = jops.farthest_point_sample

    def active(npoint, allow_seed=True):
        return allow_seed and sampling.seed_k0(GRID, npoint) > 0

    def farthest_point_sample(xyz, npoint, valid_mask=None,
                              allow_seed=False):
        if valid_mask is None and active(npoint, allow_seed):
            k0 = sampling.seed_k0(GRID, npoint)
            xyz = jax.lax.stop_gradient(xyz)
            return jfps.farthest_point_sample_seeded(
                xyz, npoint, k0, jfps.grid_seed_indices(xyz, k0),
                interpret=True)
        return own(xyz, npoint, valid_mask=valid_mask, allow_seed=allow_seed)

    monkeypatch.setattr(jsampling, 'fps_seeding_active', active)
    monkeypatch.setattr(jax_backbone, 'fps_seeding_active', active)
    monkeypatch.setattr(jops, 'farthest_point_sample', farthest_point_sample)


def test_seeded_backbone_matches_jax(jax_seeded):
    """The tiny IA-SSD at npoints 512/256 (both D-FPS layers seeded, so
    layer 1 runs its own seeded FPS instead of the prefix shortcut), port
    vs the JAX package's seeded path: sampled points identical at every
    sampling layer, vote centers and predictions within 1e-4 (fp32 sums in
    another order)."""
    points = synthetic_scan_batch(3, 2, 2048)
    jax_cfg, cfg = jax_tiny_iassd_cfg(), tiny_iassd_cfg()
    for c in (jax_cfg, cfg):
        c.BACKBONE_3D.SA_CONFIG.NPOINT_LIST = SEEDED_NPOINTS
    jax_model = jax_build_detector(jax_cfg, num_class=3)
    variables = jax.jit(lambda key, pts: jax_model.init(
        key, {'points': pts}, train=False))(jax.random.PRNGKey(3), points)
    jax_out = jax.jit(lambda v, pts: jax_model.apply(
        v, {'points': pts}, train=False))(variables, points)
    model = build_detector(cfg, 3, device='cpu', fps_seeding=GRID)
    load_flax(model, jax.tree_util.tree_map(np.asarray, dict(variables)))
    with torch.no_grad():
        out = model({'points': torch.from_numpy(points)})
    for k in range(1, 5):  # gathers of the input points
        np.testing.assert_array_equal(out['encoder_xyz'][k].numpy(),
                                      np.asarray(jax_out['encoder_xyz'][k]),
                                      err_msg=f'encoder_xyz[{k}]')
    for k in (5, 6):  # the vote layer's shifted centers
        np.testing.assert_allclose(out['encoder_xyz'][k].numpy(),
                                   np.asarray(jax_out['encoder_xyz'][k]),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f'encoder_xyz[{k}]')
    # layer 1 ran seeded FPS on layer 0's seeded output, not the shortcut
    assert not torch.equal(out['encoder_xyz'][2], out['encoder_xyz'][1][:, :256])
    for key in ('batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jax_out[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
