"""World-2 cases of the port's data parallel, run in two worker processes
over gloo on the CPU (``tests/test_torch_parallel.py``,
``tests/test_torch_ddp_train.py``, ``tests/test_torch_ddp_zoo.py``): each
rank writes its records to
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

from spsnet_torch import ops, parallel, stability, zoo
from spsnet_torch.config import EDict
from spsnet_torch.data.loader import ShardedSampler
from spsnet_torch.data.processor import voxel_batch
from spsnet_torch.data.processor.voxelize import uses_up_tables
from spsnet_torch.data.processor.sparse_plan import plan_final_grid
from spsnet_torch.data.processor.voxelize import sparse_grid_zyx
from spsnet_torch.models import (build_detector, build_detector_from_cfg,
                                 blocks)
from spsnet_torch.models.dense_heads import iassd_head
from spsnet_torch.models.dense_heads import center_head, center_head_iou
from spsnet_torch.models.roi_heads import parta2_head, pointrcnn_head
from spsnet_torch.runtime import optimization
from spsnet_torch.runtime.trainer import (Trainer, make_stability_preprocess,
                                          make_train_step,
                                          merge_results_dist)
from spsnet_torch.stability import GenerateCenter, make_stability_train_step
from spsnet_torch.utils import loss_utils
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


def _optimizer(model, optim=OPTIM):
    return optimization.build_optimizer(EDict(optim), model.parameters(),
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


def _gt_at_proposals(model, batch, stage, jitter_sizes=False):
    """The batch's gt boxes plus three boxes a frame at the proposals of a
    train-mode forward of a copy of ``model`` (``stage`` gives its
    stage-one output), so that RoIs reach the regression threshold. With
    ``jitter_sizes`` their sizes and headings move by 2 % too: a
    CenterHead's size target at a proposal's own pixel is else its
    prediction to the last bit, where the L1's sign is a coin toss."""
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
    if jitter_sizes:
        extra[..., 3:6] *= torch.exp(0.02 * torch.randn(
            extra[..., 3:6].shape, generator=gen))
        extra[..., 6] += 0.02 * torch.randn(extra[..., 6].shape,
                                            generator=gen)
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
    make_train_step(pillar, _optimizer(pillar), group=group)
    out['pillar_admitted'] = True

    class Made_up(torch.nn.Linear):
        pass
    made_up = Made_up(2, 2)
    try:
        make_train_step(made_up, _optimizer(made_up), group=group)
        out['gate'] = None
    except NotImplementedError as e:
        out['gate'] = str(e)
    iassd = build_detector(zoo.tiny_iassd_cfg(), 3, device='cpu')
    make_train_step(iassd, _optimizer(iassd), group=group)
    out['iassd_admitted'] = True
    return out


# ------------------------------------------------------------ the zoo suite
# tests/test_torch_ddp_zoo.py: ZOO_STEPS world-2 steps of every other
# detector of the registry and of the stability model's own step, each rank
# on its frame of a two-frame batch (the frames with unequal gt counts),
# then the one-process steps over the joined batch, split between the
# ranks; and the ZOO_LOCAL variants, each with one term over the rank's own
# frame, which the tests must refuse
ZOO = ('second', 'pointpillar', 'voxelrcnn', 'centerpoint',
       'centerpoint_groups', 'pvrcnnpp', 'secondiou', 'parta2',
       'parta2_free', 'caddn', 'al', 'stability')
ZOO_LOCAL = {'centerpoint_local': 'centerpoint', 'al_local': 'al',
             'parta2_local': 'parta2'}
# two steps: DDP finds a parameter that got no gradient at the second.
# SGD with momentum: its update is linear in the gradient, so the ranks'
# rounding stays rounding in the parameters that the second step starts
# from (Adam's first step moves an entry whose gradient is rounding by a
# whole learning rate either way, and the second step's gradients with it)
ZOO_STEPS = 2
ZOO_OPTIM = dict(OPTIM, OPTIMIZER='sgd')
# the joined steps are also taken from weights x (1 + ZOO_JITTER N(0, 1)):
# how far fp32 rounding of the weights moves each number of the step
ZOO_JITTER = 1e-7
# keypoints of PV-RCNN++'s VSA: every slot valid (tests/test_torch_pvrcnnpp
# .py TRAIN_KEYPOINTS: an invalid keypoint's VectorPool rows sit at 1e6,
# where no two computations agree)
PP_KEYPOINTS = 32
# the geometries of the detectors' own tests: the voxel CenterPoint's
# (tests/test_torch_centerpoint.py), the pillars' and AL's (0.4 and 0.8 m
# pillars over one range), CaDDN's (tests/test_torch_caddn.py); the other
# voxel detectors take PV_PCR and PV_VS
CP_PCR, CP_VS = (0, -6.4, -3, 12.8, 6.4, 1), (0.1, 0.1, 0.1)
PILLAR_PCR, PILLAR_VS, AL_VS = (0, -12.8, -3, 25.6, 12.8, 1), \
    (0.4, 0.4, 4), (0.8, 0.8, 4)
CADDN_PCR, CADDN_VS, CADDN_IMAGE = (2.0, -12.8, -3.0, 27.6, 12.8, 1.0), \
    (0.8, 0.8, 0.5), (64, 96)
CLASSES = ['Car', 'Pedestrian', 'Cyclist']
AL_SEM_CLS = 4


def _data_cfg(pcr, vs, voxels, max_points=5, plan=False):
    steps = [{'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': list(vs),
              'MAX_POINTS_PER_VOXEL': max_points,
              'MAX_NUMBER_OF_VOXELS': {'train': voxels, 'test': voxels}}]
    if plan:
        steps.append({'NAME': 'build_sparse_conv_plan'})
    return EDict({'POINT_CLOUD_RANGE': list(pcr), 'DATA_PROCESSOR': steps})


def _frames(seed, n, pcr, classes, width=8):
    """Two scans in ``pcr`` and their gt boxes, the second frame's cut to
    four (the ranks then hold unequal counts of positives), labelled
    1 .. ``classes`` in turn; 10 wide with velocities in [-3, 3] before
    the class."""
    pts, gt = synthetic_scene_batch(seed, 2, n, pc_range=pcr, n_clusters=6)
    rng = np.random.default_rng(seed)
    gts = []
    for g in (gt[0], gt[1][:4]):
        g = g.copy()
        g[:, 7] = 1 + np.arange(len(g)) % classes
        if width == 10:
            g = np.concatenate([g[:, :7], rng.uniform(
                -3, 3, (len(g), 2)).astype(np.float32), g[:, 7:]], 1)
        gts.append(g)
    return pts, gts


def _gt_at_anchors(model, batch, k=3):
    """The batch's gt boxes plus ``k`` boxes a frame on anchors of the
    anchor head (class 1), so that anchors take positive labels."""
    anchors = model.dense_head.anchors.reshape(
        -1, model.dense_head.anchors.shape[-1])[:, :7]
    rng = np.random.default_rng(13)
    B = batch['gt_boxes'].shape[0]
    pick = anchors[torch.from_numpy(rng.choice(len(anchors), (B, k),
                                               replace=False))]
    extra = torch.cat([pick, torch.ones(B, k, 1)], -1)
    return dict(batch, gt_boxes=torch.cat([batch['gt_boxes'], extra], 1))


def _voxel_case(cfg, num_class, seed, pcr, vs, voxels, n=1536,
                max_points=5, proposals=False, class_names=None, width=8):
    """A voxel or pillar detector of ``cfg`` (seeded weights) and the
    joined train batch of ``_frames`` through ``voxel_batch``."""
    plan = cfg.get('BACKBONE_3D', None) is not None
    final = plan_final_grid(sparse_grid_zyx(pcr, vs)) if plan else None
    model = build_detector(cfg, num_class, device='cpu',
                           generator=torch.Generator().manual_seed(1),
                           voxel_size=vs, point_cloud_range=pcr,
                           final_grid_zyx=final, class_names=class_names)
    pts, gts = _frames(seed, n, pcr, num_class, width)
    host = voxel_batch(pts, _data_cfg(pcr, vs, voxels, max_points, plan),
                       mode='train', gt_boxes=gts,
                       up_tables=uses_up_tables(cfg))
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    if proposals:
        batch = _gt_at_proposals(model, batch, lambda m, b: m.stage_one(b))
    return model, batch


def _caddn_batch(seed):
    """Two camera frames as the JAX package's ``tests/test_caddn.py``
    makes them (a 40 px focal length over a CADDN_IMAGE image, uniform
    depths), two cars and one 2D box in the first, one of each in the
    second."""
    rng = np.random.default_rng(seed)
    h, w = CADDN_IMAGE
    l2c = np.tile(np.float32([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                              [0, 0, 0, 1]]), (2, 1, 1))
    c2i = np.zeros((2, 3, 4), np.float32)
    c2i[:, 0, 0] = c2i[:, 1, 1] = 40.0
    c2i[:, 0, 2], c2i[:, 1, 2], c2i[:, 2, 2] = w / 2, h / 2, 1.0
    gt2d = np.zeros((2, 2, 4), np.float32)
    gt2d[0] = [[10, 10, 40, 30], [50, 20, 80, 50]]
    gt2d[1, 0] = [20, 12, 44, 40]
    gt = np.zeros((2, 2, 8), np.float32)
    gt[0, :, 0] = rng.uniform(5, 25, 2)
    gt[1, 0, 0] = rng.uniform(5, 25)
    gt[..., 1] = rng.uniform(-8, 8, (2, 2))
    gt[..., 2], gt[..., 3:6] = -1.0, [3.9, 1.6, 1.56]
    gt[0, :, 7] = gt[1, 0, 7] = 1
    gt[1, 1] = 0
    arrays = {'images': rng.uniform(0, 1, (2, h, w, 3)),
              'trans_lidar_to_cam': l2c, 'trans_cam_to_img': c2i,
              'depth_maps': rng.uniform(2, 27, (2, h, w)),
              'gt_boxes2d': gt2d, 'gt_boxes': gt}
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in arrays.items()}


def zoo_case(name):
    """(model, joined batch) of a zoo case, the same on every rank; the
    stability case's model is a ``GenerateCenter``."""
    if name == 'second':
        cfg = zoo.tiny_pvrcnn_cfg(plan_final_grid(sparse_grid_zyx(PV_PCR,
                                                                  PV_VS)))
        cfg = EDict({'NAME': 'SECONDNet', **{
            k: cfg[k] for k in ('VFE', 'BACKBONE_3D', 'MAP_TO_BEV',
                                'BACKBONE_2D', 'DENSE_HEAD')}})
        model, batch = _voxel_case(cfg, 1, 40, PV_PCR, PV_VS, 96, n=512)
        return model, _gt_at_anchors(model, batch)
    if name in ('voxelrcnn', 'pvrcnnpp', 'secondiou', 'parta2'):
        final = plan_final_grid(sparse_grid_zyx(PV_PCR, PV_VS))
        cfg = getattr(zoo, f'tiny_{name}_cfg')(final)
        if name in ('voxelrcnn', 'secondiou', 'parta2'):
            cfg.ROI_HEAD.DP_RATIO = 0.3
        if name == 'pvrcnnpp':
            cfg.PFE.NUM_KEYPOINTS = PP_KEYPOINTS
        model, batch = _voxel_case(cfg, 1, 41, PV_PCR, PV_VS, 96, n=512,
                                   proposals=name != 'pvrcnnpp')
        if name == 'pvrcnnpp':
            # the scales of tests/test_torch_pvrcnnpp.py: sizes are exp
            # of the 'dim' map, and the RoI head's boxes stay near the RoIs
            with torch.no_grad():
                for module, scale in ((model.dense_head.center, 0.1),
                                      (model.dense_head.dim, 0.1),
                                      (model.roi_head.reg_layers[-1], 1e-2)):
                    for p in module.parameters():
                        p.mul_(scale)
            batch = _gt_at_proposals(model, batch,
                                     lambda m, b: m.stage_one(b), True)
        return model, batch
    if name == 'parta2_free':
        return _voxel_case(zoo.tiny_parta2_free_cfg(), 3, 41, PV_PCR, PV_VS,
                           96, n=512, proposals=True)
    if name in ('pointpillar', 'centerpoint'):
        cfg = getattr(zoo, f'tiny_{name}_cfg')()
        return _voxel_case(cfg, 3, 43, PILLAR_PCR, PILLAR_VS, 800, n=1500,
                           max_points=8)
    if name == 'centerpoint_groups':
        return _voxel_case(zoo.tiny_centerpoint_voxel_cfg(
            plan_final_grid(sparse_grid_zyx(CP_PCR, CP_VS))), 3, 44, CP_PCR,
            CP_VS, 700, class_names=CLASSES, width=10)
    if name == 'al':
        cfg = zoo.tiny_al_cfg()
        cfg.DENSE_HEAD.USE_DET_FOR_SEM = True
        model, batch = _voxel_case(cfg, 3, 45, PILLAR_PCR, AL_VS, 256, n=512,
                                   max_points=8, class_names=CLASSES)
        rng = np.random.default_rng(45)
        batch['sem_labels'] = torch.from_numpy(rng.integers(
            -1, AL_SEM_CLS, batch['points'].shape[:2]).astype(np.int32))
        return model, batch
    if name == 'caddn':
        model = build_detector(zoo.tiny_caddn_cfg(), 1, device='cpu',
                               generator=torch.Generator().manual_seed(1),
                               voxel_size=CADDN_VS,
                               point_cloud_range=CADDN_PCR)
        return model, _caddn_batch(46)
    if name == 'stability':
        model = GenerateCenter(zoo.tiny_stability_model_cfg())
        blocks.init_weights(model, torch.Generator().manual_seed(1))
        pts, gt = synthetic_scene_batch(47, 2, 256)
        gt[1, 4:] = 0
        return model, {'points': _t(pts), 'gt_boxes': _t(gt)}
    raise ValueError(name)


def _local_lovasz_weights(err, fg):
    """The Lovasz weights of a sort over the rank's own points alone."""
    order = torch.argsort(-err, dim=1, stable=True)
    grad = loss_utils.lovasz_grad(fg.gather(1, order))
    return torch.zeros_like(grad).scatter_(1, order, grad)


@contextlib.contextmanager
def zoo_fault(name, model, world):
    """A ZOO_LOCAL variant: CenterPoint's normalizers over the rank's own
    frame and the ranks' gradients averaged (what plain DDP trains), AL's
    Lovasz order over the rank's own points, PartA2's MaskedBatchNorm
    statistics over the rank's own cells."""
    saved = (center_head.global_sum, center_head_iou.global_sum,
             loss_utils._joined_lovasz_weights, parta2_head.step_world)
    if name == 'centerpoint_local':
        center_head.global_sum = center_head_iou.global_sum = lambda t: t
        own = model.loss

        def loss(out):
            value, tb = own(out)
            return value / world, tb
        model.loss = loss
    elif name == 'al_local':
        loss_utils._joined_lovasz_weights = _local_lovasz_weights
    elif name == 'parta2_local':
        parta2_head.step_world = lambda: 1
    try:
        yield
    finally:
        (center_head.global_sum, center_head_iou.global_sum,
         loss_utils._joined_lovasz_weights, parta2_head.step_world) = saved
        if name == 'centerpoint_local':
            del model.loss


def run_steps(name, model, batch, group, steps=ZOO_STEPS):
    """``steps`` steps of the zoo case ``name`` (``make_train_step``, or
    ``make_stability_train_step`` for the stability model) over ``batch``:
    each step's loss and tb terms, gradients before the clip, state after
    it and learning rate."""
    opt = _optimizer(model, ZOO_OPTIM)
    if name == 'stability':
        step = make_stability_train_step(model, opt, 3, group)
    else:
        step = make_train_step(model, opt, group=group)
    own_clip = optimization.clip_by_global_norm_
    out = []
    for _ in range(steps):
        raw = {}

        def clip(grads, max_norm):
            raw.update({n: p.grad.clone()
                        for n, p in model.named_parameters()})
            return own_clip(grads, max_norm)
        lr = opt.lr_fn(opt.count)
        optimization.clip_by_global_norm_ = clip
        try:
            loss, tb = step(batch)
        finally:
            optimization.clip_by_global_norm_ = own_clip
        out.append({'loss': float(loss),
                    'tb': {k: float(v) for k, v in tb.items()},
                    'grads': raw, 'lr': lr,
                    'state': {k: v.clone()
                              for k, v in model.state_dict().items()}})
    return out


# the direct checks against JAX: the semantic loss of SEM_P points a rank
# over SEM_C classes, the masked BatchNorm of MBN_N RoI grids a rank, the
# stability loss of STAB_B frames of STAB_M points a rank
SEM_P, SEM_C = 150, 4
MBN_N, MBN_G, MBN_C = 3, 4, 8
STAB_B, STAB_M, STAB_LATENT = 2, 64, 8


def semantic_inputs():
    """Joined (P, C) logits and (P,) labels (-1 ignored) of 2 SEM_P points
    with tied errors: rows repeated within a rank's block, rank 1 rows
    that repeat rank 0's row 0 and rank 0 rows that repeat rank 1's row
    50, so that ties cross the ranks in both directions."""
    rng = np.random.default_rng(24)
    logits = rng.normal(size=(2 * SEM_P, SEM_C)).astype(np.float32)
    target = rng.integers(-1, SEM_C, 2 * SEM_P).astype(np.int32)
    target[[0, 1, SEM_P + 50]] = [1, 2, 3]
    for rows, src in ((slice(40, 60), 1), (slice(SEM_P + 10, SEM_P + 40), 0),
                      (slice(100, 120), SEM_P + 50)):
        logits[rows], target[rows] = logits[src], target[src]
    return logits, target


def masked_bn_inputs():
    """Joined (N, G, G, G, C) grids, their (N, G, G, G, 1) mask with about
    70 % of rank 0's cells active and 20 % of rank 1's (rank 1's values
    1.5 higher), the output's cotangent weights and the BatchNorm's
    scale, bias, running mean and running variance."""
    rng = np.random.default_rng(50)
    shape = (2 * MBN_N, MBN_G, MBN_G, MBN_G)
    share = np.repeat([0.7, 0.2], MBN_N)[:, None, None, None]
    mask = (rng.uniform(size=shape) < share).astype(np.float32)[..., None]
    x = rng.normal(1.0, 2.0, shape + (MBN_C,)).astype(np.float32)
    x[MBN_N:] += 1.5
    x *= mask
    params = [np.linspace(lo, hi, MBN_C).astype(np.float32)
              for lo, hi in ((0.5, 1.5), (-0.2, 0.3), (0.1, 0.4), (1.0, 3.0))]
    return x, mask, np.arange(MBN_C, dtype=np.float32), params


def stability_inputs():
    """A training forward's outputs over 2 STAB_B frames ('layer_xyz',
    'center_pred', 'mu', 'logvar') and their gt boxes: rank 0's frames
    hold more foreground points than rank 1's."""
    rng = np.random.default_rng(60)
    n = 2 * STAB_B
    xyz = rng.uniform([0, -10, -2], [20, 10, 1], (n, STAB_M, 3))
    gt = np.zeros((n, 3, 8))
    for b in range(n):
        k = 3 if b < STAB_B else 1
        gt[b, :k, :3] = xyz[b, rng.choice(STAB_M, k, replace=False)]
        gt[b, :k, 3:6] = rng.uniform([3, 2, 1.5], [6, 4, 2.5], (k, 3))
        gt[b, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        gt[b, :k, 7] = 1
    ret = {'layer_xyz': xyz,
           'center_pred': rng.normal(0, 0.5, (n, STAB_M, 3)),
           'mu': rng.normal(0, 0.3, (n, STAB_M, STAB_LATENT)),
           'logvar': rng.normal(0, 0.3, (n, STAB_M, STAB_LATENT))}
    return {k: v.astype(np.float32) for k, v in ret.items()}, \
        gt.astype(np.float32)


def stability_loss_model():
    """The tiny stability model whose parameters the loss's L2 term
    reads (seeded weights)."""
    model = GenerateCenter(zoo.tiny_stability_model_cfg())
    blocks.init_weights(model, torch.Generator().manual_seed(61))
    return model


def _direct_checks(rank, world, steps):
    """This rank's share of each direct check, inside a step of the
    ``steps`` group: values, gradients at its rows, parameter gradients
    summed over the ranks and the BatchNorm's running statistics."""
    out = {}
    logits, target = semantic_inputs()
    rows = slice(rank * SEM_P, (rank + 1) * SEM_P)
    x = _t(logits[rows]).requires_grad_()
    t = _t(target[rows])
    with parallel.step_group(steps):
        sem = loss_utils.cpgnet_criterion(x, t, valid=t >= 0)
        sem['loss'].backward()
    out['semantic'] = {'terms': {k: float(v) for k, v in sem.items()},
                       'grad': x.grad}
    x, mask, cot, (w, b, mean, var) = masked_bn_inputs()
    rows = slice(rank * MBN_N, (rank + 1) * MBN_N)
    bn = parta2_head.MaskedBatchNorm(MBN_C)
    with torch.no_grad():
        for buf, v in ((bn.weight, w), (bn.bias, b), (bn.running_mean, mean),
                       (bn.running_var, var)):
            buf.copy_(_t(v))
    xt = _t(x[rows]).permute(0, 4, 1, 2, 3).requires_grad_()
    with parallel.step_group(steps):
        y = bn.train()(xt, _t(mask[rows]).permute(0, 4, 1, 2, 3))
        (y * _t(cot)[:, None, None, None]).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads)
    out['masked_bn'] = {'y': y.detach().permute(0, 2, 3, 4, 1),
                        'dx': xt.grad.permute(0, 2, 3, 4, 1),
                        'dw': grads[0], 'db': grads[1],
                        'mean': bn.running_mean.clone(),
                        'var': bn.running_var.clone()}
    ret, gt = stability_inputs()
    rows = slice(rank * STAB_B, (rank + 1) * STAB_B)
    model = stability_loss_model()
    mine = {k: _t(v[rows]).requires_grad_(k != 'layer_xyz')
            for k, v in ret.items()}
    with parallel.step_group(steps):
        loss, tb = stability.generate_center_loss(model, mine,
                                                  _t(gt[rows]))
        loss.backward()
    params = [p.grad for p in model.parameters()]
    for g in params:
        dist.all_reduce(g)
    out['stability'] = {'tb': {k: float(v) for k, v in tb.items()},
                        'grads': {k: v.grad for k, v in mine.items()
                                  if v.requires_grad},
                        'params': params}
    return out


def zoo_suite(rank, world, out_dir):
    group = parallel.world_group()
    out = {'direct': _direct_checks(rank, world,
                                    parallel.new_step_group(group))}
    for name in (*ZOO, *ZOO_LOCAL):
        model, batch = zoo_case(ZOO_LOCAL.get(name, name))
        mine = parallel.local_rows(batch, rank, world)
        with zoo_fault(name, model, world):
            out[name] = run_steps(name, model, mine, group)
    for name in ZOO[rank::world]:
        model, batch = zoo_case(name)
        jittered = copy.deepcopy(model)
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in jittered.parameters():
                p.mul_(1 + ZOO_JITTER * torch.randn(p.shape, generator=gen))
        out[f'{name}_joined'] = run_steps(name, model, batch, None)
        out[f'{name}_jitter'] = run_steps(name, jittered, batch, None)
    return out


SUITES = {'train': train_suite, 'parallel': parallel_suite, 'zoo': zoo_suite}


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
