"""World-2 cases of the port's data parallel, run in two worker processes
over gloo on the CPU (``tests/test_torch_parallel.py``,
``tests/test_torch_ddp_train.py``): each rank writes its records to
``OUT_DIR/{suite}_rank{r}.pt`` and the test holds them to the one-process
step over the joined batch (run by the workers after the world-2 steps,
split between the ranks) and to JAX. Imports no JAX.

    python -m tests.torch_ddp_cases SUITE INIT_FILE RANK WORLD OUT_DIR
"""
from __future__ import annotations

import contextlib
import copy
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from spsnet_torch import ops, parallel, zoo
from spsnet_torch.config import EDict
from spsnet_torch.data.loader import ShardedSampler
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.data.processor.sparse_plan import plan_final_grid
from spsnet_torch.data.processor.voxelize import sparse_grid_zyx
from spsnet_torch.models import (build_detector, build_detector_from_cfg,
                                 blocks)
from spsnet_torch.models.dense_heads import iassd_head
from spsnet_torch.models.roi_heads import pointrcnn_head
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.trainer import (Trainer, make_stability_preprocess,
                                          make_train_step,
                                          merge_results_dist)
from spsnet_torch.utils.synthetic import synthetic_scene_batch

torch.set_num_threads(1)

OPTIM = {'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 2,
         'OPTIMIZER': 'adam_onecycle', 'LR': 0.002, 'WEIGHT_DECAY': 0.01,
         'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
         'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [1, 2], 'LR_DECAY': 0.1,
         'LR_CLIP': 0.0000001, 'GRAD_NORM_CLIP': 10}
ITERS, EPOCHS = 10, 2
# the joined batches: frames a rank and points a frame
IASSD_SEED, IASSD_B, IASSD_N = 0, 2, 512
SPSNET_B, SPSNET_N, DELETE = 2, 256, 32
PRCNN_N = 512
# the tiny PV-RCNN experiment's geometry (tests/test_pvrcnn.py)
PV_PCR = (0, -6.4, -3, 12.8, 6.4, 1)
PV_VS = (0.8, 0.8, 0.0625)
# the global BatchNorm cases: (layout, joined input shape)
BN_CASES = {'last': (10, 6, 5), 'nchw': (4, 3, 5, 6)}
# the train-step cases a rank runs alone over the joined batch afterwards
JOINED = {0: ('iassd', 'spsnet_stability', 'pvrcnn'),
          1: ('spsnet_random', 'pointrcnn')}
# seconds the ranks of a suite may take: a hung rank fails its tests
SPAWN_TIMEOUT = 120


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _optimizer(model):
    return optimization.build_optimizer(EDict(OPTIM), model.parameters(),
                                        ITERS, EPOCHS)


def _stability_preprocess(method):
    return make_stability_preprocess(
        EDict({'CKPT': None, 'DELETE_NUMBER': DELETE,
               'DELETE_METHOD': method,
               'MODEL': zoo.tiny_stability_model_cfg()}), 'cpu',
        torch.Generator().manual_seed(7))


def pv_experiment():
    """The tiny PV-RCNN experiment (train limit 96 voxels, DP_RATIO 0.3:
    the RoI towers draw dropout masks)."""
    data = EDict({
        'POINT_CLOUD_RANGE': list(PV_PCR),
        'POINT_FEATURE_ENCODING': {
            'used_feature_list': ['x', 'y', 'z', 'intensity']},
        'DATA_PROCESSOR': [
            {'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': list(PV_VS),
             'MAX_POINTS_PER_VOXEL': 5,
             'MAX_NUMBER_OF_VOXELS': {'train': 96, 'test': 160}},
            {'NAME': 'build_sparse_conv_plan', 'PLAN': 'backbone8x'}]})
    model = zoo.tiny_pvrcnn_cfg(plan_final_grid(sparse_grid_zyx(PV_PCR,
                                                                PV_VS)))
    model.ROI_HEAD.DP_RATIO = 0.3
    return EDict({'CLASS_NAMES': ['Car'], 'DATA_CONFIG': data,
                  'MODEL': model, 'OPTIMIZATION': OPTIM})


def _gt_at_proposals(model, batch, stage):
    """The batch's gt boxes plus three boxes a frame at the proposals of a
    train-mode forward of a copy of ``model`` (``stage`` gives its
    stage-one output), so that RoIs reach the regression threshold."""
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        rois, _, labels, _ = pointrcnn_head.proposal_layer(
            stage(probe, {k: v for k, v in batch.items()
                          if k != 'gt_boxes'}),
            model.model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
    extra = rois[:, :3].clone()
    gen = torch.Generator().manual_seed(12)
    extra[..., 0:3] += 0.02 * torch.randn(extra[..., 0:3].shape,
                                          generator=gen) * extra[..., 3:6]
    extra = torch.cat([extra, labels[:, :3, None].float()], dim=-1)
    return dict(batch, gt_boxes=torch.cat([batch['gt_boxes'], extra], 1))


def case(name, out_dir):
    """(model, joined batch, preprocess) of a train-step case, the same
    on every rank: seeded weights (IA-SSD's from the test's flax
    variables), the joined batch, SPSNet's frozen stability preprocess."""
    gen = torch.Generator().manual_seed(1)
    if name in ('iassd', 'iassd_local'):
        model = build_detector(zoo.tiny_iassd_cfg(), 3, device='cpu')
        model.load_state_dict(torch.load(Path(out_dir) / 'iassd_init.pt'))
        pts, gt = synthetic_scene_batch(IASSD_SEED, 2 * IASSD_B, IASSD_N)
        return model, {'points': _t(pts), 'gt_boxes': _t(gt)}, None
    if name.startswith('spsnet'):
        model = build_detector(zoo.tiny_spsnet_cfg(), 3, device='cpu',
                               generator=gen)
        pts, gt = synthetic_scene_batch(5, 2 * SPSNET_B, SPSNET_N)
        return model, {'points': _t(pts), 'gt_boxes': _t(gt)}, \
            _stability_preprocess(name.split('_')[1])
    if name == 'pointrcnn':
        cfg = zoo.tiny_pointrcnn_cfg()
        cfg.ROI_HEAD.DP_RATIO = 0.3
        model = build_detector(cfg, 3, device='cpu', generator=gen)
        pts, gt = synthetic_scene_batch(9, 2, PRCNN_N)
        batch = _gt_at_proposals(
            model, {'points': _t(pts), 'gt_boxes': _t(gt)},
            lambda m, b: m.point_head(m.backbone_3d(b)))
        return model, batch, None
    if name == 'pvrcnn':
        cfg = pv_experiment()
        model = build_detector_from_cfg(cfg, device='cpu', generator=gen)
        with torch.no_grad():
            for p in model.dense_head.conv_box.parameters():
                p.mul_(1e-2)
        pts, gt = synthetic_scene_batch(30, 2, 512, pc_range=PV_PCR,
                                        n_clusters=6)
        host = voxel_batch(pts, cfg.DATA_CONFIG, mode='train',
                           gt_boxes=[gt[0], gt[1][:4]])
        batch = {k: torch.from_numpy(v) for k, v in host.items()}
        batch = _gt_at_proposals(model, batch, lambda m, b: m.stage_one(b))
        return model, batch, None
    raise ValueError(name)


@contextlib.contextmanager
def recorded():
    """Record the indices a step takes: FPS picks, ball-query indices and
    the sampled RoIs."""
    rec = {'fps': [], 'ball': [], 'rois': []}
    own = {k: getattr(ops, k) for k in ('farthest_point_sample',
                                        'ball_query', 'ball_query_multi')}
    own_ptl = pointrcnn_head.proposal_target_layer

    def fps(*a, **k):
        idx = own['farthest_point_sample'](*a, **k)
        rec['fps'].append(idx.clone())
        return idx

    def ball(*a, **k):
        idx = own['ball_query'](*a, **k)
        rec['ball'].append(idx.clone())
        return idx

    def ball_multi(*a, **k):
        out = own['ball_query_multi'](*a, **k)
        rec['ball'] += [t.clone() for t in (out if isinstance(
            out, (list, tuple)) else [out])]
        return out

    def targets(*a, **k):
        t = own_ptl(*a, **k)
        rec['rois'].append(t.sampled.clone())
        return t

    ops.farthest_point_sample, ops.ball_query = fps, ball
    ops.ball_query_multi = ball_multi
    pointrcnn_head.proposal_target_layer = targets
    try:
        yield rec
    finally:
        for k, v in own.items():
            setattr(ops, k, v)
        pointrcnn_head.proposal_target_layer = own_ptl


@contextlib.contextmanager
def local_normalizers(model, world):
    """What plain DDP trains: IA-SSD's loss normalized over the rank's own
    batch, the ranks' gradients averaged (the step's ``world`` times its
    loss undone)."""
    saved = (iassd_head.global_sum, iassd_head.global_mean, model.loss)
    iassd_head.global_sum = lambda t: t
    iassd_head.global_mean = lambda x: x.mean()
    own = model.loss

    def loss(out):
        value, tb = own(out)
        return value / world, tb
    model.loss = loss
    try:
        yield
    finally:
        iassd_head.global_sum, iassd_head.global_mean, model.loss = saved


def run_step(model, batch, preprocess, group):
    """One step; the loss and tb terms, the gradients before the clip, the
    state after it, the indices it took, the points the preprocess kept and
    the rank's own positive count."""
    kept, pos = [], []
    if preprocess is not None:
        own_pre = preprocess

        def preprocess(b, g):
            out = own_pre(b, g)
            kept.append(out['points'].clone())
            return out
    opt = _optimizer(model)
    step = make_train_step(model, opt, preprocess, group)
    own_loss, own_clip = model.loss, optimization.clip_by_global_norm_
    raw = {}

    def clip(grads, max_norm):
        raw.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return own_clip(grads, max_norm)

    def counted(out):
        value, tb = own_loss(out)
        if 'center_pos_num' in tb:
            pos.append(float(tb['center_pos_num']))
        return value, tb
    model.loss, optimization.clip_by_global_norm_ = counted, clip
    try:
        with recorded() as rec:
            loss, tb = step(batch)
    finally:
        model.loss, optimization.clip_by_global_norm_ = own_loss, own_clip
    return {'loss': float(loss),
            'tb': {k: float(v) for k, v in tb.items()},
            'grads': raw,
            'state': {k: v.clone() for k, v in model.state_dict().items()},
            'idx': rec, 'kept': kept, 'pos': pos, 'lr': opt.lr_fn(0)}


def _trainer_run(root, rank, world, epochs, start=0):
    """The tiny IA-SSD ``Trainer`` at world ``world`` over 4 frames (a
    ``ShardedSampler`` hands each rank its 2 a step), ``epochs`` epochs
    from ``start`` (resumed when ``start`` > 0); returns the trainer and
    how often this rank saved."""
    cfg = EDict({'OPTIMIZATION': dict(OPTIM, NUM_EPOCHS=epochs)})
    model = build_detector(zoo.tiny_iassd_cfg(), 3, device='cpu',
                           generator=torch.Generator().manual_seed(3))
    sampler = ShardedSampler(4, world, rank, seed=4)
    pts, gt = synthetic_scene_batch(40, 4, 256)

    class Loader:
        def __iter__(self):
            idx = sampler.indices()
            yield {'points': pts[idx], 'gt_boxes': gt[idx]}

    trainer = Trainer(cfg, model, root, total_iters_each_epoch=1,
                      group=parallel.world_group(), sampler=sampler)
    saves = []
    own = trainer.ckpt.save

    def save(step, state):
        saves.append(step)
        return own(step, state)
    trainer.ckpt.save = save
    if start:
        assert trainer.maybe_resume() == start
    trainer.train(Loader(), start_epoch=start)
    return trainer, saves


def train_suite(rank, world, out_dir):
    group = parallel.world_group()
    out = {}
    for name in ('iassd', 'spsnet_stability', 'spsnet_random', 'pointrcnn',
                 'pvrcnn', 'iassd_local'):
        model, batch, pre = case(name, out_dir)
        mine = parallel.local_rows(batch, rank, world)
        if name == 'iassd_local':
            with local_normalizers(model, world):
                out[name] = run_step(model, mine, pre, group)
        else:
            out[name] = run_step(model, mine, pre, group)
    out['trainer'] = {}
    for tag, epochs, start in (('straight', 2, 0), ('first', 1, 0),
                               ('resumed', 2, 1)):
        root = Path(out_dir) / ('trainer_a' if tag == 'straight'
                                else 'trainer_b')
        trainer, saves = _trainer_run(root, rank, world, epochs, start)
        out['trainer'][tag] = {
            'saves': saves, 'count': trainer.optimizer.count,
            'state': {k: v.clone() for k, v in
                      trainer.model.state_dict().items()},
            'files': sorted(p.name for p in (root / 'ckpt').iterdir())}
    for name in JOINED[rank]:
        model, batch, pre = case(name, out_dir)
        out[f'{name}_joined'] = run_step(model, batch, pre, None)
    return out


def _bn(layout, channels):
    bn = blocks.BatchNormLast(channels) if layout == 'last' else \
        blocks.BatchNormNCHW(channels)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, channels))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, channels))
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(2.0)
    return bn.train()


def bn_inputs(layout):
    """The joined input and the output's cotangent of a BN case."""
    rng = np.random.default_rng(11)
    shape = BN_CASES[layout]
    x = rng.normal(2.0, 3.0, shape).astype(np.float32)
    x[:shape[0] // 2] += 1.5          # the ranks' halves differ in mean
    cot = rng.normal(size=shape).astype(np.float32)
    return x, cot


def _bn_run(layout, x, cot, group=None):
    channels = x.shape[-1] if layout == 'last' else x.shape[1]
    bn = _bn(layout, channels)
    x = _t(x).requires_grad_(True)
    with parallel.step_group(group):
        y = bn(x)
        (y * _t(cot)).sum().backward()
    return {'y': y.detach(), 'dx': x.grad, 'dw': bn.weight.grad,
            'db': bn.bias.grad, 'mean': bn.running_mean.clone(),
            'var': bn.running_var.clone()}


def parallel_suite(rank, world, out_dir):
    group = parallel.world_group()
    steps = parallel.new_step_group(group)
    ones = [dist.new_group([r]) for r in range(world)]
    out = {'bn': {}, 'bn_world1_equal': {}}
    for layout in BN_CASES:
        x, cot = bn_inputs(layout)
        n = x.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        rec = _bn_run(layout, x[rows], cot[rows], steps)
        for k in ('dw', 'db'):
            dist.all_reduce(rec[k], group=group)
        out['bn'][layout] = rec
        plain = _bn_run(layout, x[rows], cot[rows])
        one = _bn_run(layout, x[rows], cot[rows], ones[rank])
        out['bn_world1_equal'][layout] = all(
            torch.equal(plain[k], one[k]) for k in plain)
    annos = [{'frame_id': f'{2 * k + rank:06d}', 'score': k}
             for k in range(3)]
    if rank == 0:
        annos.append({'frame_id': '000004', 'score': 99})
    out['merged'] = merge_results_dist(annos, group)
    out['local_batch'] = parallel.host_local_batch_size(8)
    try:
        parallel.host_local_batch_size(7)
        out['ragged_raises'] = False
    except ValueError:
        out['ragged_raises'] = True
    out['gathered'] = parallel.all_gather_host({'rank': rank})
    pillar = build_detector(zoo.tiny_pointpillar_cfg(), 3, device='cpu',
                            voxel_size=(0.4, 0.4, 4),
                            point_cloud_range=(0, -12.8, -3, 25.6, 12.8, 1))
    try:
        make_train_step(pillar, _optimizer(pillar), group=group)
        out['gate'] = None
    except NotImplementedError as e:
        out['gate'] = str(e)
    iassd = build_detector(zoo.tiny_iassd_cfg(), 3, device='cpu')
    make_train_step(iassd, _optimizer(iassd), group=group)
    out['iassd_admitted'] = True
    return out


SUITES = {'train': train_suite, 'parallel': parallel_suite}


def start(suite, out_dir, world=2):
    """Start the ``world`` ranks of ``suite`` (one OpenMP thread each),
    joined through a ``file://`` store in ``out_dir``; their logs go to
    ``out_dir``."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=str(root))
    procs = []
    for rank in range(world):
        log = open(Path(out_dir) / f'{suite}_rank{rank}.log', 'w')
        procs.append((subprocess.Popen(
            [sys.executable, '-m', 'tests.torch_ddp_cases', suite,
             str(Path(out_dir) / f'{suite}.store'), str(rank), str(world),
             str(out_dir)], cwd=root, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def finish(procs, suite, out_dir, timeout=SPAWN_TIMEOUT):
    """Wait for the ranks (``timeout`` seconds in all, then kill them) and
    return their records in rank order; raise with the logs if one failed
    or hung."""
    deadline = time.monotonic() + timeout
    failed = False
    for proc, log in procs:
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            failed = True
        failed |= proc.poll() != 0
        log.close()
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if failed:
        logs = '\n'.join(
            (Path(out_dir) / f'{suite}_rank{r}.log').read_text()[-3000:]
            for r in range(len(procs)))
        raise AssertionError(f'{suite} ranks failed or hung: {logs}')
    return [torch.load(Path(out_dir) / f'{suite}_rank{r}.pt',
                       weights_only=False) for r in range(len(procs))]


def main(suite, init_file, rank, world, out_dir):
    rank, world = int(rank), int(world)
    parallel.init_distributed('cpu', init_method=f'file://{init_file}',
                              rank=rank, world_size=world)
    try:
        out = SUITES[suite](rank, world, out_dir)
        torch.save(out, Path(out_dir) / f'{suite}_rank{rank}.pt')
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main(*sys.argv[1:])
