"""The port's data-parallel train step at world 2 on the CPU for every
other detector of the registry and the stability model's own step.

Two worker processes over gloo (``tests/torch_ddp_cases.py``, suite
'zoo', spawned once for the module) each take two steps of the tiny
SECOND, PointPillar, Voxel R-CNN, CenterPoint (the plain head over
pillars, and CLASS_NAMES_EACH_HEAD over voxels with the IoU branch),
PV-RCNN++, SECOND-IoU, PartA2, PartA2_free, CaDDN, AL (the detection and
the semantic loss) and of the stability model, each on its frame of a
two-frame batch whose frames hold unequal numbers of objects, through
``make_train_step(..., group=)`` (``make_stability_train_step(...,
group=)``) under DistributedDataParallel; then, split between them, the
one-process steps over the joined batch, and the same from weights
jittered by 1e-7 (how far fp32 rounding moves each number of a step).
Three variants that keep one term per rank (CenterPoint's normalizers,
AL's Lovasz order, PartA2's MaskedBatchNorm statistics) must fall outside
the limits that the global steps meet. The ranks' shares of the semantic
loss over tied errors, of the masked BatchNorm and of the stability loss
are also held to the JAX package's functions over the joined inputs,
which run here while the ranks run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsnet_tpu.models.roi_heads import parta2_head as jax_parta2
from spsnet_tpu.stability import model as jax_stability
from spsnet_tpu.utils import loss_utils as jax_loss
from tests import torch_ddp_cases as cases

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

# world 2 against the joined step, both fp32: each number within the
# limits of tests/test_torch_ddp_train.py (loss terms LOSS_RTOL relative,
# each gradient tensor GRAD_RTOL relative L2, the parameters STEP_ATOL
# after each SGD step, the BN and MaskedBatchNorm buffers BN_RTOL relative
# L2 all at once) or within JITTER_FACTOR times what the 1e-7 weight jitter
# moves it (the loss terms: the most it moves any term of the step),
# whichever is larger (the card-vs-CPU train checks' factor). The jitter's
# share is the larger for some models at random weights, at the second
# step: the voxel CenterPoint's loss terms (6.2e-4), Voxel R-CNN's RoI
# pool's gradients (6e-2), CaDDN's depth network's (1.4e-2); world 2 came
# within 1.01 times the jitter's move or the floor everywhere
LOSS_RTOL, GRAD_RTOL, STEP_ATOL, BN_RTOL = 1e-5, 2e-4, 1e-5, 1e-6
JITTER_FACTOR = 5.0
# a gradient that is zero in exact arithmetic (a bias before training
# BatchNorm, which subtracts it again): within this of the step's largest
# gradient entry, on both sides
ZERO_GRAD_TOL = 1e-6
# a rank-local variant falls this many times beyond the limits
REFUSED = 100.0
# the direct checks against JAX: loss terms LOSS_RTOL (the semantic
# loss's absolute floor as tests/test_torch_al.py's), gradients
# DIRECT_GRAD_RTOL of their largest entry, the masked BatchNorm's output
# MBN_RTOL relative and its running statistics MBN_STAT_ATOL (the
# tolerances of tests/test_torch_al.py and tests/test_torch_parta2.py)
DIRECT_GRAD_RTOL, MBN_RTOL, MBN_STAT_ATOL = 1e-3, 1e-4, 1e-6


def _jax_semantic():
    logits, target = cases.semantic_inputs()

    def loss(x):
        out = jax_loss.cpgnet_criterion(x, target, valid=target >= 0)
        return out['loss'], out
    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(logits)
    return {k: float(v) for k, v in out.items()}, np.asarray(grad)


def _jax_masked_bn():
    x, mask, cot, (w, b, mean, var) = cases.masked_bn_inputs()
    bn = jax_parta2.MaskedBatchNorm(use_running_average=False)
    stats = {'mean': jnp.asarray(mean), 'var': jnp.asarray(var)}

    def loss(params, a):
        y, state = bn.apply({'params': params, 'batch_stats': stats}, a,
                            mask, mutable=['batch_stats'])
        return jnp.sum(y * cot), (y, state['batch_stats'])
    (_, (y, new)), (dp, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            {'scale': jnp.asarray(w), 'bias': jnp.asarray(b)}, x)
    return {'y': y, 'dx': dx, 'dw': dp['scale'], 'db': dp['bias'],
            'mean': new['mean'], 'var': new['var']}


def _jax_stability():
    ret, gt = cases.stability_inputs()
    ret, gt = {k: jnp.asarray(v) for k, v in ret.items()}, jnp.asarray(gt)
    params = [p.detach().numpy() for p in
              cases.stability_loss_model().parameters()]
    keys = ('center_pred', 'mu', 'logvar')

    def loss(params, grad_ret):
        loss, tb = jax_stability.generate_center_loss(
            params, dict(ret, **grad_ret), gt)
        return loss, tb
    (_, tb), (dp, dr) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, {k: ret[k]
                                                      for k in keys})
    return {k: float(v) for k, v in tb.items()}, dr, dp


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    """The ranks' records ({case: [step records]}, the joined steps under
    '{case}_joined', the jittered ones under '{case}_jitter', the direct
    checks' shares under 'direct') and JAX's functions over the joined
    inputs, which run here while the ranks run."""
    out = tmp_path_factory.mktemp('ddp_zoo')
    procs = cases.start('zoo', out)
    try:
        jax_rec = {'semantic': _jax_semantic(),
                   'masked_bn': _jax_masked_bn(),
                   'stability': _jax_stability()}
    finally:
        ranks = cases.finish(procs, 'zoo', out)

    def of(suffix):
        return {k[:-len(suffix)]: v for r in ranks for k, v in r.items()
                if k.endswith(suffix)}
    return {'ranks': ranks, 'joined': of('_joined'),
            'jitter': of('_jitter'), 'jax': jax_rec}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _limit(floor, jitter):
    return max(floor, JITTER_FACTOR * jitter)


def _loss_rel(got, want):
    """Each loss term's relative difference (the loss itself under
    'loss')."""
    return [abs(g - w) / max(abs(w), 1e-12) for g, w in
            zip((got['loss'], *(got['tb'][k] for k in want['tb'])),
                (want['loss'], *want['tb'].values()))]


def _loss_excess(got, want, jit):
    """The largest ratio of a loss term's relative difference to the
    limit: the floor, or the jitter's largest over the step's terms (one
    draw of it per term is noisier than the terms' spread)."""
    return max(_loss_rel(got, want)) / _limit(LOSS_RTOL,
                                              max(_loss_rel(jit, want)))


def _grad_excess(got, want, jit):
    """The largest ratio of a gradient tensor's relative L2 difference to
    its limit; a gradient that is zero in exact arithmetic counts by its
    largest entry against ZERO_GRAD_TOL of the step's largest."""
    assert set(got) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        if float(w.abs().max()) <= ZERO_GRAD_TOL * top:
            worst = max(worst, float(got[name].abs().max()) /
                        (ZERO_GRAD_TOL * top))
            continue
        worst = max(worst, _rel_l2(got[name], w) /
                    _limit(GRAD_RTOL, _rel_l2(jit[name], w)))
    return worst


def _stat_keys(state):
    return [k for k in state if k.endswith(('running_mean', 'running_var'))]


def _state_excess(got, want, jit):
    """The largest ratio, over the parameter tensors, of the largest
    difference to its limit, and that of the BN and MaskedBatchNorm
    buffers' relative L2 all at once."""
    worst = 0.0
    stats = _stat_keys(want)
    for k, w in want.items():
        if k.endswith('num_batches_tracked') or k in stats:
            continue
        worst = max(worst, float((got[k] - w).abs().max()) /
                    (STEP_ATOL + JITTER_FACTOR *
                     float((jit[k] - w).abs().max())))
    if stats:
        cat = [torch.cat([s[k].flatten() for k in stats])
               for s in (got, want, jit)]
        worst = max(worst, _rel_l2(cat[0], cat[1]) /
                    _limit(BN_RTOL, _rel_l2(cat[2], cat[1])))
    return worst


def _steps(world2, name):
    base = cases.ZOO_LOCAL.get(name, name)
    return (world2['ranks'][0][name], world2['ranks'][1][name],
            world2['joined'][base], world2['jitter'][base])


@pytest.mark.parametrize('name', cases.ZOO)
def test_world2_loss_terms_match_the_joined_step(world2, name):
    """The loss and every tb term (the joined batch's, summed from the
    ranks' shares) at each of the two steps, on both ranks."""
    r0, r1, want, jit = _steps(world2, name)
    assert len(want) == cases.ZOO_STEPS
    for s in range(cases.ZOO_STEPS):
        for rank in (r0, r1):
            assert set(rank[s]['tb']) == set(want[s]['tb'])
            assert _loss_excess(rank[s], want[s], jit[s]) <= 1.0, s
        assert np.isfinite(want[s]['loss']) and want[s]['loss'] > 0


@pytest.mark.parametrize('name', cases.ZOO)
def test_world2_gradients_match_the_joined_step(world2, name):
    """The gradients DDP leaves before the clip at each step: bit for bit
    the same on both ranks, every parameter's, and each tensor the joined
    step's."""
    r0, r1, want, jit = _steps(world2, name)
    for s in range(cases.ZOO_STEPS):
        for k, g in r0[s]['grads'].items():
            assert torch.equal(g, r1[s]['grads'][k]), (s, k)
        assert _grad_excess(r0[s]['grads'], want[s]['grads'],
                            jit[s]['grads']) <= 1.0, s


@pytest.mark.parametrize('name', cases.ZOO)
def test_world2_updates_and_bn_buffers_match_the_joined_step(world2,
                                                            name):
    """After each SGD step both ranks hold the same state, bit for bit;
    its parameters and its BN and MaskedBatchNorm running statistics are
    the joined step's, and every parameter moved."""
    r0, r1, want, jit = _steps(world2, name)
    for s in range(cases.ZOO_STEPS):
        for k, v in r0[s]['state'].items():
            assert torch.equal(v, r1[s]['state'][k]), (s, k)
        assert _state_excess(r0[s]['state'], want[s]['state'],
                             jit[s]['state']) <= 1.0, s
    moved = [k for k, v in r0[0]['grads'].items() if v.abs().max() > 0]
    assert moved and all(not torch.equal(r0[1]['state'][k],
                                         r0[0]['state'][k]) for k in moved)
    if name in ('parta2', 'parta2_free'):
        assert any('conv_part' in k for k in _stat_keys(want[0]['state']))


@pytest.mark.parametrize('name', sorted(cases.ZOO_LOCAL))
def test_rank_local_variant_is_refused(world2, name):
    """CenterPoint with its normalizers over each rank's own frame and the
    ranks' gradients averaged (plain DDP), AL with its Lovasz order over
    each rank's own points, PartA2 with its MaskedBatchNorm statistics
    over each rank's own cells: the loss terms or the gradients fall
    REFUSED times beyond the limits the global steps meet."""
    r0, _, want, jit = _steps(world2, name)
    worst = max(max(_loss_excess(r0[s], want[s], jit[s]),
                    _grad_excess(r0[s]['grads'], want[s]['grads'],
                                 jit[s]['grads']))
                for s in range(cases.ZOO_STEPS))
    assert worst > REFUSED


def _joined_rows(world2, check, key):
    return torch.cat([r['direct'][check][key]
                      for r in world2['ranks']]).numpy()


def test_world2_semantic_loss_matches_jax_over_the_joined_points(world2):
    """``cpgnet_criterion`` on two ranks, its errors tied within a rank
    and across the two: the ranks' shares of the weighted CE, the Lovasz
    term and the loss summed, and their gradients at their own logits,
    against JAX's over the joined points (a tie across the ranks keeps the
    joined order, so each tied point takes the joined point's share)."""
    want, grad = world2['jax']['semantic']
    for k, v in want.items():
        got = sum(r['direct']['semantic']['terms'][k]
                  for r in world2['ranks'])
        np.testing.assert_allclose(got, v, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(
        _joined_rows(world2, 'semantic', 'grad'), grad, rtol=0,
        atol=DIRECT_GRAD_RTOL * float(np.abs(grad).max()))
    shares = [r['direct']['semantic']['terms']['loss_ls']
              for r in world2['ranks']]
    assert min(shares) > 0


def test_world2_masked_batch_norm_matches_jax_over_the_joined_rows(world2):
    """MaskedBatchNorm on two ranks with 70 % and 20 % of their cells
    active: outputs and input gradients row for row, the scale's and
    bias's gradients summed over the ranks and the running statistics
    (torch's unbiased variance rule over the joined count, alike on both
    ranks) as JAX's over the joined rows."""
    want = world2['jax']['masked_bn']
    for k in ('y', 'dx'):
        w = np.asarray(want[k])
        np.testing.assert_allclose(
            _joined_rows(world2, 'masked_bn', k), w, rtol=MBN_RTOL,
            atol=MBN_RTOL * float(np.abs(w).max()), err_msg=k)
    r0, r1 = (r['direct']['masked_bn'] for r in world2['ranks'])
    for k in ('dw', 'db', 'mean', 'var'):
        assert torch.equal(r0[k], r1[k]), k
    for k in ('dw', 'db'):
        w = np.asarray(want[k])
        np.testing.assert_allclose(r0[k].numpy(), w, rtol=0,
                                   atol=DIRECT_GRAD_RTOL *
                                   float(np.abs(w).max()), err_msg=k)
    for k in ('mean', 'var'):
        np.testing.assert_allclose(r0[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=MBN_STAT_ATOL, err_msg=k)
    _, mask, _, _ = cases.masked_bn_inputs()
    half = mask.shape[0] // 2
    assert mask[:half].mean() > 2 * mask[half:].mean()


def test_world2_stability_loss_matches_jax_with_the_l2_term_once(world2):
    """``generate_center_loss`` on two ranks, rank 0's frames with more
    foreground: the ranks' shares of every tb term summed (the parameters'
    L2 term half of itself on each rank) and their gradients at their own
    outputs and, summed, at the parameters, against JAX's over the joined
    batch, where the term counts once."""
    want, dret, dparams = world2['jax']['stability']
    r0, r1 = (r['direct']['stability'] for r in world2['ranks'])
    for k, v in want.items():
        np.testing.assert_allclose(r0['tb'][k] + r1['tb'][k], v,
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(r0['tb']['l2_reg'], want['l2_reg'] / 2,
                               rtol=LOSS_RTOL)
    for k, w in dret.items():
        w = np.asarray(w)
        got = np.concatenate([r0['grads'][k].numpy(),
                              r1['grads'][k].numpy()])
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=DIRECT_GRAD_RTOL *
                                   float(np.abs(w).max()), err_msg=k)
    for g0, g1, w in zip(r0['params'], r1['params'], dparams):
        assert torch.equal(g0, g1)
        w = np.asarray(w)
        np.testing.assert_allclose(g0.numpy(), w, rtol=0,
                                   atol=DIRECT_GRAD_RTOL *
                                   float(np.abs(w).max()))
