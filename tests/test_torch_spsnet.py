"""The port's SPSNet serving chain against the JAX package on the CPU.

The tiny SPSNet-IA (``tiny_spsnet_cfg``) and the tiny stability model of the
JAX package's chain test serve two synthetic scenes of 256 points with gt
boxes, 32 points deleted a scene: the stability model's stds, the delete
hook, the PAGNet backbone (surface features, sss_aware sampling), the MLT
head and the class-agnostic NMS. Flax variables from fixed keys go through
the weight bridge; inputs come from numpy seeds. Indices must be identical;
floats stay within the tolerances stated here: both packages run fp32, with
sums taken in another order (XLA:CPU against the CPU BLAS), ~1e-7 relative
per layer.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spsnet_tpu import ops as jops
from spsnet_tpu.config import StaticConfig
from spsnet_tpu.models import build_detector as jax_build_detector
from spsnet_tpu.models import samplers as jax_samplers
from spsnet_tpu.models import surface_feature as jax_sf
from spsnet_tpu.models.detectors.detector3d import \
    post_processing as jax_post_processing
from spsnet_tpu.stability import hook as jax_hook
from spsnet_tpu.stability.model import GenerateCenter as JaxGenerateCenter
from spsnet_tpu.utils.synthetic import synthetic_scene_batch as jax_scenes
from spsnet_tpu.zoo import tiny_spsnet_cfg as jax_tiny_spsnet_cfg
from spsnet_torch.models import build_detector, samplers
from spsnet_torch.models.surface_feature import FeatureExtraction
from spsnet_torch.runtime.trainer import StabilityPreprocess, make_eval_step
from spsnet_torch.stability import hook
from spsnet_torch.stability.model import GenerateCenter
from spsnet_torch.utils.synthetic import synthetic_scene_batch
from spsnet_torch.utils.weights import generator_flax_to_torch, load_flax
from spsnet_torch.zoo import (tiny_iassd_cfg, tiny_spsnet_cfg,
                              tiny_stability_model_cfg)

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

B, N, DELETE = 2, 256, 32
RTOL, ATOL = 1e-4, 1e-4
# stds: a sum of 4 exp(0.5 * logvar) after a 3-layer MLP, max-pool and three
# Linears, each summed in another order by the two packages
STDS_RTOL = 1e-5
# one sss_aware score is a sigmoid times a stability score, each a few ulps
# apart between the packages (one ulp at 0.5 is 6e-8)
SCORE_TOL = 5e-7


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_vars(model, key, *args, **kwargs):
    variables = jax.jit(lambda k, *a: model.init(k, *a, **kwargs))(key, *args)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _record_sss(module, stash):
    """Wrap ``module.sample_sss_aware`` so each call stores its inputs and
    picks in ``stash``; returns the original."""
    own = module.sample_sss_aware

    def sampler(cls_features, stds, npoint):
        idx, out = own(cls_features, stds, npoint)
        stash.append((cls_features, stds, idx))
        return idx, out
    module.sample_sss_aware = sampler
    return own


@pytest.fixture(scope='module')
def chain():
    points, gt = jax_scenes(0, B, N)
    jpts, jgt = jnp.asarray(points), jnp.asarray(gt)

    # the JAX package: stds, fake labels and the deletion as its hook runs
    # them, then the detector and the NMS
    gen = JaxGenerateCenter(model_cfg=StaticConfig(tiny_stability_model_cfg()))
    # train=True creates every variable (eval skips obj_encoder)
    gen_vars = _jax_vars(gen, {'params': jax.random.PRNGKey(1),
                               'latent': jax.random.PRNGKey(5)},
                         {'points': jpts}, train=True)
    jax_stds = np.asarray(gen.apply(gen_vars, {'points': jpts},
                                    train=False)['stds'])
    jax_batch = jax_hook.apply_stability_hook(
        gen.apply, gen_vars, {'points': jpts, 'gt_boxes': jgt},
        jax.random.PRNGKey(3), delete_number=DELETE)
    box_idx = np.asarray(jops.points_in_boxes(jpts[..., :3], jgt[..., :7]))
    fake = np.where(box_idx >= 0, np.take_along_axis(
        gt[..., -1].astype(np.int32), np.maximum(box_idx, 0), 1), 0)
    _, jax_keep = jax_hook.stability_delete_points(
        jpts, jnp.asarray(jax_stds), jnp.asarray(fake),
        jax.random.PRNGKey(3), delete_number=DELETE)
    cfg = jax_tiny_spsnet_cfg()
    model = jax_build_detector(cfg, num_class=3)
    det_batch = {'points': jax_batch['points'], 'stds': jax_batch['stds']}
    variables = _jax_vars(model, jax.random.PRNGKey(0), det_batch,
                          train=False)
    stash = []
    own = _record_sss(jax_samplers, stash)
    try:
        def forward(v, b):
            stash.clear()
            out = model.apply(v, b, train=False)
            return out, jax_post_processing(out, cfg.POST_PROCESSING), \
                list(stash)
        jax_out, jax_dets, jax_sss = jax.jit(forward)(variables, det_batch)
    finally:
        jax_samplers.sample_sss_aware = own

    # the port: the same weights through the bridge, its own preprocess
    # (no noise: with the stability method every background key of the JAX
    # package rounds to 1e9, so its noise decides nothing) and its eval step
    tgen = load_flax(GenerateCenter(tiny_stability_model_cfg()), gen_vars,
                     convert=generator_flax_to_torch).eval()
    tpts, tgt = (_t(a) for a in synthetic_scene_batch(0, B, N))
    with torch.no_grad():
        stds = tgen({'points': tpts})['stds']
    tfake = hook.fake_labels_from_boxes(tpts, tgt)
    _, keep = hook.stability_delete_points(tpts, stds, tfake,
                                           delete_number=DELETE)
    tmodel = build_detector(tiny_spsnet_cfg(), 3, device='cpu')
    load_flax(tmodel, variables)
    captured, sss = {}, []
    forward = tmodel.forward

    def capture(batch):
        captured['batch'] = batch
        captured['out'] = forward(batch)
        return captured['out']
    tmodel.forward = capture
    own = _record_sss(samplers, sss)
    try:
        dets, _ = make_eval_step(
            tmodel, tiny_spsnet_cfg().POST_PROCESSING,
            StabilityPreprocess(tgen, DELETE, 'stability'))(
                {'points': tpts, 'gt_boxes': tgt},
                torch.Generator().manual_seed(0))
    finally:
        samplers.sample_sss_aware = own
    return {'jax_stds': jax_stds, 'stds': stds.numpy(), 'fake': fake,
            'tfake': tfake.numpy(), 'jax_keep': np.asarray(jax_keep),
            'keep': keep.numpy(), 'jax_batch': jax_batch,
            'batch': captured['batch'], 'jax_out': jax_out,
            'out': captured['out'], 'jax_dets': jax_dets, 'dets': dets,
            'jax_sss': jax_sss, 'sss': sss}


def test_stability_stds_and_foreground_match(chain):
    np.testing.assert_allclose(chain['stds'], chain['jax_stds'],
                               rtol=STDS_RTOL)
    np.testing.assert_array_equal(chain['tfake'], chain['fake'])
    assert (chain['fake'] > 0).sum(1).min() > DELETE  # the fg branch


def test_deletion_keeps_the_same_points(chain):
    """Identical keep_idx once the DELETE-th and next foreground stds lie
    further apart than the packages' stds differ (else the seed is unfit
    for an exact comparison, and this says so)."""
    diff = float(np.abs(chain['stds'] - chain['jax_stds']).max())
    for b in range(B):
        fg = np.sort(chain['jax_stds'][b][chain['fake'][b] > 0])
        gap = fg[DELETE] - fg[DELETE - 1]
        assert gap > 2 * diff, f'scene {b}: near-tie {gap:.2e}'
    np.testing.assert_array_equal(chain['keep'], chain['jax_keep'])
    np.testing.assert_array_equal(chain['batch']['points'].numpy(),
                                  np.asarray(chain['jax_batch']['points']))
    np.testing.assert_allclose(chain['batch']['stds'].numpy(),
                               np.asarray(chain['jax_batch']['stds']),
                               rtol=STDS_RTOL)


def test_sss_aware_picks_and_sampled_points_are_identical(chain):
    """Both sss_aware layers pick the same points (guarded by the top-k gap,
    as the IA-SSD test guards ctr_aware), and every layer's sampled points
    are gathered by identical indices."""
    assert len(chain['sss']) == len(chain['jax_sss']) == 2
    for (cls, stds, idx), (jcls, jstds, jidx) in zip(chain['sss'],
                                                     chain['jax_sss']):
        s = samplers.sss_aware_scores(cls, stds).numpy()
        js = np.asarray(jax.nn.sigmoid(jnp.max(jcls, -1))
                        * jax_samplers.stability_score(jstds))
        diff = float(np.abs(s - js).max())
        assert diff < SCORE_TOL, f'scores differ by {diff:.2e}'
        top = -np.sort(-js, axis=-1)[:, :idx.shape[1] + 1]
        gap = float((top[:, :-1] - top[:, 1:]).min())
        assert gap > 2 * diff, f'near-tie {gap:.2e}'
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    sa = tiny_spsnet_cfg().BACKBONE_3D.SA_CONFIG
    for k, methods in enumerate(sa.SAMPLE_METHOD_LIST):
        if methods:
            np.testing.assert_array_equal(
                chain['out']['encoder_xyz'][k + 1].numpy(),
                np.asarray(chain['jax_out']['encoder_xyz'][k + 1]),
                err_msg=f'layer {k} ({methods}) sampled points')


def test_predictions_within_tolerance(chain):
    out, jax_out = chain['out'], chain['jax_out']
    for key in ('centers', 'centers_origin', 'ctr_offsets', 'centers_features',
                'batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jax_out[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_nms_outputs_match(chain):
    dets, jax_dets = chain['dets'], chain['jax_dets']
    for key in ('indices', 'count', 'labels'):
        np.testing.assert_array_equal(dets[key].numpy(),
                                      np.asarray(jax_dets[key]), err_msg=key)
    np.testing.assert_allclose(dets['boxes'].numpy(),
                               np.asarray(jax_dets['boxes']), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('method', ['stability', 'random'])
@pytest.mark.parametrize('n_fg', [5, 100])
def test_delete_points_matches_jax(method, n_fg):
    """Both branches: more foreground points than the deletions (the
    lowest-key foreground goes) and fewer (all foreground goes, then
    background in key order), for both methods; the noise is the one
    ``jax.random.uniform`` draws."""
    rng = np.random.default_rng(n_fg)
    pts = rng.normal(size=(B, N, 4)).astype(np.float32)
    stds = rng.uniform(0.1, 30.0, (B, N)).astype(np.float32)
    fake = np.zeros((B, N), np.int32)
    for b in range(B):
        fake[b, rng.permutation(N)[:n_fg]] = rng.integers(1, 4, n_fg)
    key = jax.random.PRNGKey(n_fg)
    noise = np.asarray(jax.random.uniform(key, (B, N)))
    want_pts, want = jax_hook.stability_delete_points(
        jnp.asarray(pts), jnp.asarray(stds), jnp.asarray(fake), key,
        delete_number=DELETE, method=method)
    got_pts, got = hook.stability_delete_points(
        _t(pts), _t(stds), _t(fake), _t(noise), delete_number=DELETE,
        method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    gone = np.sort(np.setdiff1d(np.arange(N), got[0].numpy()))
    fg = np.flatnonzero(fake[0])
    if n_fg > DELETE:
        assert np.isin(gone, fg).all()
    else:
        assert np.isin(fg, gone).all()


def test_background_ties_are_broken_by_index():
    """``1e9 + u`` rounds to exactly 1e9 in fp32 for every u in [0, 1), so
    the background points that fill the deletions are the lowest-indexed
    ones, whatever the noise, in both packages."""
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (1, N)))
    assert (np.float32(1e9) + noise == np.float32(1e9)).all()
    fake = np.zeros((1, N), np.int32)
    fake[0, [3, 200, 250]] = 1
    stds = np.ones((1, N), np.float32)
    pts = np.arange(N * 4, dtype=np.float32).reshape(1, N, 4)
    _, want = jax_hook.stability_delete_points(
        jnp.asarray(pts), jnp.asarray(stds), jnp.asarray(fake),
        jax.random.PRNGKey(7), delete_number=DELETE)
    _, got = hook.stability_delete_points(_t(pts), _t(stds), _t(fake),
                                          _t(noise), delete_number=DELETE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bg = [i for i in range(N) if i not in (3, 200, 250)]
    gone = set(range(N)) - set(got[0].tolist())
    assert gone == {3, 200, 250} | set(bg[:DELETE - 3])


def test_only_the_random_method_reads_noise():
    """The stability method draws and reads no noise; the random method
    refuses to run without it."""
    pts, gt = (_t(a) for a in synthetic_scene_batch(1, B, N))
    fake = hook.fake_labels_from_boxes(pts, gt)
    stds = torch.rand((B, N), generator=torch.Generator().manual_seed(1))
    noise = torch.rand((B, N), generator=torch.Generator().manual_seed(2))
    _, keep = hook.stability_delete_points(pts, stds, fake,
                                           delete_number=DELETE)
    _, keep_noise = hook.stability_delete_points(pts, stds, fake, noise,
                                                 delete_number=DELETE)
    assert torch.equal(keep, keep_noise)
    with pytest.raises(ValueError, match='needs noise'):
        hook.stability_delete_points(pts, stds, fake, delete_number=DELETE,
                                     method='random')


def test_feature_extraction_matches_jax():
    """The surface DGCNN: the shared graph identical, the 60-d descriptor
    within tolerance."""
    pos = jax_scenes(5, B, N)[0][..., :3].copy()
    model = jax_sf.FeatureExtraction()
    variables = _jax_vars(model, jax.random.PRNGKey(4), jnp.asarray(pos))
    want = np.asarray(model.apply(variables, jnp.asarray(pos)))
    sd = generator_flax_to_torch({'params': {'sf_extract':
                                             variables['params']}})
    port = FeatureExtraction()
    port.load_state_dict({k[len('sf_extract.'):]: v for k, v in sd.items()})
    np.testing.assert_array_equal(
        port.graph(_t(pos)).numpy(),
        np.asarray(jops.ball_query(0.8, 16, jnp.asarray(pos),
                                   jnp.asarray(pos))))
    with torch.no_grad():
        got = port(_t(pos)).numpy()
    assert got.shape == (B, N, 60)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sample_sss_aware_matches_jax_on_ties():
    """Saturated class scores and repeated stds make exact ties; both
    packages take the lowest index first."""
    rng = np.random.default_rng(9)
    logits = rng.choice(np.float32([-2.0, 20.0, 30.0]), size=(2, 300, 3))
    stds = rng.choice(np.float32([0.5, 4.0, 40.0]), size=(2, 300))
    idx, got_stds = samplers.sample_sss_aware(_t(logits), _t(stds), 64)
    want, want_stds = jax_samplers.sample_sss_aware(
        jnp.asarray(logits), jnp.asarray(stds), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_stds.numpy(), np.asarray(want_stds))


def _stability_pair(use_surface, train):
    """The tiny stability model in both packages, the port's loaded from
    the JAX package's variables through the bridge; with ``use_surface``
    the model_V3 variant (surface features in front of the SA feature)."""
    cfg = tiny_stability_model_cfg()
    cfg.USE_SURFACE = use_surface
    pts = jax_scenes(6, B, N)[0]
    model = JaxGenerateCenter(model_cfg=StaticConfig(cfg))
    variables = _jax_vars(model, {'params': jax.random.PRNGKey(8),
                                  'latent': jax.random.PRNGKey(9)},
                          {'points': jnp.asarray(pts)}, train=True)
    port = load_flax(GenerateCenter(cfg), variables,
                     convert=generator_flax_to_torch).train(train)
    return model, variables, port, pts


@pytest.mark.parametrize('use_surface', [False, True])
def test_generate_center_stds_match_jax(use_surface):
    model, variables, port, pts = _stability_pair(use_surface, train=False)
    want = model.apply(variables, {'points': jnp.asarray(pts)}, train=False)
    with torch.no_grad():
        got = port({'points': _t(pts)})
    np.testing.assert_allclose(got['stds'].numpy(), np.asarray(want['stds']),
                               rtol=STDS_RTOL)
    np.testing.assert_array_equal(got['layer_xyz'].numpy(),
                                  np.asarray(want['layer_xyz']))


def test_generate_center_training_forward_matches_jax(monkeypatch):
    """The training branch: the latent noise drawn from the port's
    generator is handed to the JAX model in place of its own draw, and
    BatchNorm normalises with the batch's statistics in both."""
    model, variables, port, pts = _stability_pair(False, train=True)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        got = port({'points': _t(pts)}, torch.Generator().manual_seed(4))
    eps = torch.randn(got['mu'].shape, generator=gen).numpy()
    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape: jnp.asarray(eps))
    want, _ = model.apply(variables, {'points': jnp.asarray(pts)},
                          train=True, rngs={'latent': jax.random.PRNGKey(0)},
                          mutable=['batch_stats'])
    np.testing.assert_allclose(got['center_pred'].numpy(),
                               np.asarray(want['center_pred']), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match='Generator'):
        port({'points': _t(pts)})


def test_preprocess_loads_a_checkpoint_and_needs_a_foreground(tmp_path):
    """``STABILITY_HOOK.CKPT`` names a state dict saved with ``torch.save``;
    without it the weights come from the given generator. A batch with
    neither 'fake_labels' nor 'gt_boxes' raises the JAX package's
    KeyError."""
    from spsnet_torch.config import EDict
    from spsnet_torch.runtime.trainer import make_stability_preprocess
    hook_cfg = EDict({'CKPT': None, 'DELETE_NUMBER': DELETE,
                      'MODEL': tiny_stability_model_cfg()})
    drawn = make_stability_preprocess(hook_cfg, 'cpu',
                                      torch.Generator().manual_seed(3))
    torch.save(drawn.model.state_dict(), tmp_path / 'generator.pt')
    hook_cfg.CKPT = str(tmp_path / 'generator.pt')
    loaded = make_stability_preprocess(hook_cfg, 'cpu')
    for (name, a), b in zip(drawn.model.state_dict().items(),
                            loaded.model.state_dict().values()):
        assert torch.equal(a, b), name
    pts, gt = synthetic_scene_batch(2, B, N)
    out = loaded({'points': _t(pts), 'gt_boxes': _t(gt)},
                 torch.Generator().manual_seed(0))
    assert out['points'].shape == (B, N - DELETE, 4)
    assert out['stds'].shape == (B, N - DELETE)
    with pytest.raises(KeyError, match='fake_labels or gt_boxes'):
        loaded({'points': _t(pts)}, torch.Generator().manual_seed(0))


@pytest.mark.parametrize('cfg,mask', [(tiny_spsnet_cfg, False),
                                      (tiny_iassd_cfg, True)])
def test_loss_masks_sa_centerness_unless_the_head_is_mlt(monkeypatch, cfg,
                                                         mask):
    """``MLT_SSD_Head`` turns off the SA centerness masking of the head
    loss, as the JAX package's loss does for that head name."""
    from spsnet_torch.models.detectors import iassd
    seen = {}
    monkeypatch.setattr(iassd, 'iassd_head_loss',
                        lambda *a, **k: seen.update(k))
    build_detector(cfg(), 3, device='cpu').loss({'head_ret': None})
    assert seen['sa_centerness_mask'] is mask
