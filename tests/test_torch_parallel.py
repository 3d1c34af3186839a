"""The port's data-parallel building blocks on the CPU: ``ShardedSampler``
against the JAX package's, the batch helpers of ``spsnet_torch.parallel``,
and, in two worker processes over gloo (``tests/torch_ddp_cases.py``,
spawned once for the module), global BatchNorm against flax's BatchNorm
over the joined batch, its world-1 path bit for bit, the eval merge in
the JAX package's order, the gate that admits every detector of the
registry and refuses any other module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from spsnet_tpu.data.loader import ShardedSampler as JaxShardedSampler
from spsnet_torch import parallel
from spsnet_torch.data.loader import ShardedSampler
from spsnet_torch.models import build_detector, detectors
from spsnet_torch.runtime.trainer import (dedup_by_frame_id,
                                          require_global_losses)
from spsnet_torch.zoo import tiny_iassd_cfg, tiny_pointrcnn_cfg
from tests import torch_ddp_cases as cases

# one intra-op thread: the suite runs six xdist workers on the CPU, where
# torch's OpenMP threads oversubscribe the cores (a file took ~3x as long)
torch.set_num_threads(1)

# global BatchNorm against flax over the joined batch: fp32 statistics
# summed in another order (flax's E[x^2] - E[x]^2 against the two passes
# over the ranks), as test_torch_train.py holds the one-process BN
BN_TOL = 1e-5
# the order of tests/test_multihost_init.py:50-63
MERGED = ['000000', '000001', '000002', '000003', '000004', '000005',
          '000004']


@pytest.mark.parametrize('length,shards,drop_last,shuffle', [
    (10, 2, True, True), (10, 3, True, True), (10, 3, False, True),
    (7, 4, False, False), (7, 4, True, False), (1, 2, False, True)])
def test_sharded_sampler_matches_jax(length, shards, drop_last, shuffle):
    """Every shard's indices at three epochs, seed 5: those of the JAX
    package's sampler; the shards together cover the dataset (padded by
    wrapping around without drop_last)."""
    for epoch in (0, 1, 7):
        got = []
        for shard in range(shards):
            mine = ShardedSampler(length, shards, shard, shuffle, drop_last,
                                  seed=5)
            theirs = JaxShardedSampler(length, shards, shard, shuffle,
                                       drop_last, seed=5)
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(mine.indices(), theirs.indices())
            got += mine.indices().tolist()
        if drop_last:
            assert len(got) == length // shards * shards
        else:
            assert set(got) == set(range(length))


def test_host_local_batch_size_and_local_rows():
    """One rank loads the whole batch; each rank's contiguous block of
    every leading axis the ranks divide, the rest replicated or passed
    through (the world-2 sizes: ``test_batch_helpers_in_a_world_of_two``)."""
    assert parallel.host_local_batch_size(3) == 3
    batch = {'points': torch.arange(12).reshape(4, 3),
             'gt_boxes': np.arange(8).reshape(4, 2),
             'tail': torch.arange(3), 'frame_id': ['a', 'b', 'c', 'd']}
    rows = parallel.local_rows(batch, 1, 2)
    assert torch.equal(rows['points'], batch['points'][2:])
    np.testing.assert_array_equal(rows['gt_boxes'], batch['gt_boxes'][2:])
    assert torch.equal(rows['tail'], batch['tail'])
    assert rows['frame_id'] is batch['frame_id']


def test_dedup_by_frame_id_keeps_the_first_record():
    annos = [{'frame_id': f, 'k': k} for k, f in enumerate('abcab')]
    assert [(a['frame_id'], a['k']) for a in dedup_by_frame_id(annos)] == \
        [('a', 0), ('b', 1), ('c', 2)]


def test_outside_a_step_everything_is_local():
    """No process group: one rank, ``global_sum`` and the draws are the
    local ones, ``all_gather_host`` a list of one; ``cuda`` without a card
    raises before any group is made."""
    t = torch.tensor([3.0])
    assert parallel.world() == 1 and parallel.rank() == 0
    assert parallel.global_sum(t) is t
    draw = parallel.draw_rows(lambda s, g: torch.rand(s, generator=g),
                              (2, 3), torch.Generator().manual_seed(0))
    assert torch.equal(draw, torch.rand(
        (2, 3), generator=torch.Generator().manual_seed(0)))
    assert parallel.all_gather_host({'a': 1}) == [{'a': 1}]
    with pytest.raises(RuntimeError, match='no process group'):
        parallel.world_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            parallel.init_distributed('cuda', rank=0, world_size=1)


def test_require_global_losses_admits_the_ported_detectors():
    """Every class of the detector registry (PartA2_free's and the AL
    stack's among them) is admitted; a module of another class is
    refused, its message naming the registry's classes."""
    for cfg in (tiny_iassd_cfg(), tiny_pointrcnn_cfg()):
        require_global_losses(build_detector(cfg, 3, device='cpu'))
    classes = {*detectors._DETECTORS.values(), detectors.PartA2FreeNet,
               detectors.ALNet}
    assert len(classes) == 13
    for cls in classes:
        require_global_losses(cls.__new__(cls))
    with pytest.raises(NotImplementedError, match='Linear: data parallel '
                       'trains the detectors of the registry') as e:
        require_global_losses(torch.nn.Linear(2, 2))
    assert all(cls.__name__ in str(e.value) for cls in classes)


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp('parallel')
    procs = cases.start('parallel', out)
    return cases.finish(procs, 'parallel', out)


def _flax_bn(layout, x, cot):
    """flax BatchNorm over the joined batch: output, input and parameter
    gradients, the updated statistics (the port's momentum and eps of each
    layout; NCHW moved to NHWC and back)."""
    channels = x.shape[-1] if layout == 'last' else x.shape[1]
    momentum, eps = (0.9, 1e-5) if layout == 'last' else (0.99, 1e-3)
    if layout == 'nchw':
        x, cot = x.transpose(0, 2, 3, 1), cot.transpose(0, 2, 3, 1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=eps)
    params = {'scale': jnp.linspace(0.5, 1.5, channels),
              'bias': jnp.linspace(-0.2, 0.3, channels)}
    stats = {'mean': jnp.full(channels, 0.3), 'var': jnp.full(channels, 2.0)}

    @jax.jit
    def run(params, x):
        def f(params, x):
            return bn.apply({'params': params, 'batch_stats': stats}, x,
                            mutable=['batch_stats'])
        (y, mut), vjp = jax.vjp(f, params, x)
        dp, dx = vjp((jnp.asarray(cot), jax.tree_util.tree_map(
            jnp.zeros_like, mut)))
        return y, dx, dp, mut['batch_stats']
    y, dx, dp, new = run(params, jnp.asarray(x))
    y, dx = np.asarray(y), np.asarray(dx)
    if layout == 'nchw':
        y, dx = y.transpose(0, 3, 1, 2), dx.transpose(0, 3, 1, 2)
    return {'y': y, 'dx': dx, 'dw': np.asarray(dp['scale']),
            'db': np.asarray(dp['bias']), 'mean': np.asarray(new['mean']),
            'var': np.asarray(new['var'])}


@pytest.mark.parametrize('layout', sorted(cases.BN_CASES))
def test_global_batchnorm_matches_flax_over_the_joined_batch(world2, layout):
    """Each rank normalizes its half of a batch whose halves differ in
    mean with the joined batch's statistics: outputs and input gradients
    row for row, the parameters' gradients summed over the ranks and the
    running statistics (biased variance, on both ranks alike) as flax's
    over the joined batch."""
    x, cot = cases.bn_inputs(layout)
    want = _flax_bn(layout, x, cot)
    got = {k: torch.cat([r['bn'][layout][k] for r in world2]).numpy()
           for k in ('y', 'dx')}
    for k in ('dw', 'db', 'mean', 'var'):
        assert torch.equal(world2[0]['bn'][layout][k],
                           world2[1]['bn'][layout][k]), k
        got[k] = world2[0]['bn'][layout][k].numpy()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=BN_TOL, atol=BN_TOL,
                                   err_msg=k)
    axes = tuple(d for d in range(x.ndim)
                 if d != (x.ndim - 1 if layout == 'last' else 1))
    half = x[:x.shape[0] // 2]
    assert np.abs(half.mean(axes) - x.mean(axes)).min() > 0.1, \
        'a rank\'s own statistics must be far from the joined batch\'s'


@pytest.mark.parametrize('layout', sorted(cases.BN_CASES))
def test_batchnorm_in_a_step_of_one_rank_is_bit_identical(world2, layout):
    """Inside ``step_group`` of a one-rank group, BatchNorm takes the local
    path: outputs, gradients and statistics equal to those without a
    group, bit for bit."""
    assert all(r['bn_world1_equal'][layout] for r in world2)


def test_merge_results_dist_keeps_the_jax_order(world2):
    """Rank 0 gets the ranks' records interleaved back into dataset order
    with rank 0's ragged tail last; the other rank gets None; the dedup
    drops the sampler's repeat."""
    merged, other = world2[0]['merged'], world2[1]['merged']
    assert other is None
    assert [a['frame_id'] for a in merged] == MERGED
    assert [a['frame_id'] for a in dedup_by_frame_id(merged)] == MERGED[:6]


def test_batch_helpers_in_a_world_of_two(world2):
    for rank, rec in enumerate(world2):
        assert rec['local_batch'] == 4 and rec['ragged_raises']
        assert rec['gathered'] == [{'rank': 0}, {'rank': 1}]


def test_data_parallel_refuses_a_detector_without_global_losses(world2):
    """At world 2 ``make_train_step`` refuses a module that is no detector
    of the registry, whose losses are not known to be global, and admits
    PointPillar and IA-SSD."""
    for rec in world2:
        assert rec['gate'] is not None and 'Made_up' in rec['gate']
        assert 'PointPillar' in rec['gate'] and rec['iassd_admitted']
        assert rec['pillar_admitted']
