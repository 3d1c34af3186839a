"""The train and eval steps, each with SPSNet's stability preprocess
inside it, and the epoch loop (``spsnet_tpu/runtime/trainer.py:77-307``;
reference ``tools/train_utils/train_utils.py``): forward in train mode, the
detector's loss, backward, global-norm clip and the scheduled optimizer
step; forward in eval mode and the NMS; epoch-end checkpoints, auto-resume
and a graceful stop on SIGTERM/SIGUSR1. One process a device: given a
process group (``parallel.init_distributed``), the step runs any detector
of the registry under ``DistributedDataParallel`` and trains the joined
batch's objective (global BatchNorm statistics, loss normalizers, the
Lovasz order and draws, ``spsnet_torch.parallel``); the eval results of
the ranks merge on rank 0 (``merge_results_dist``).
"""
from __future__ import annotations

import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .. import parallel
from ..config import EDict
from ..models.blocks import init_weights
from ..models.detectors import resolve_device
from ..models.detectors.detector3d import post_processing
from ..stability.hook import apply_stability_hook
from ..stability.model import GenerateCenter
from ..utils.common import step_generator
from .checkpoint import CheckpointManager
from .optimization import build_optimizer

# the seeds of the per-step streams of the JAX train step
# (``spsnet_tpu/runtime/trainer.py:93-104``): RoI target sampling and the
# RoI towers' dropout
STREAMS = {'roi_sampling': 17, 'dropout': 23}


def step_rngs(step: int) -> dict:
    """The CPU generators of step ``step``'s streams, the counterparts of
    ``fold_in(PRNGKey(seed), step)``: {'roi_sampling': ..., 'dropout':
    ...} (``utils.common.step_generator``)."""
    return {name: step_generator(seed, step)
            for name, seed in STREAMS.items()}


def require_global_losses(model):
    """Raise unless every batch-level term of ``model``'s loss is global
    across the ranks of a data-parallel step: every class of the detector
    registry (``models.detectors``, PartA2_free's ``PartA2FreeNet`` and
    the AL stack's ``ALNet`` among them). Another module's loss is not
    known to be, and is refused."""
    from ..models import detectors
    classes = {*detectors._DETECTORS.values(), detectors.PartA2FreeNet}
    if type(model) in classes:
        return
    raise NotImplementedError(
        f'{type(model).__name__}: data parallel trains the detectors of the '
        f'registry ({", ".join(sorted(c.__name__ for c in classes))}), '
        'whose loss normalizers, BatchNorm statistics and draws are global '
        'across the ranks; this module is not one of them')


def _unused_parameters(model) -> bool:
    """Whether a step may leave parameters of ``model`` without a
    gradient, which DDP must then search for each step: the AL stack's
    semantic branch without 'sem_labels' (or its detection head with
    SEM_TASK). Every parameter of the other detectors gets a gradient."""
    from ..models.detectors import ALNet
    return isinstance(model, ALNet)


def make_train_step(model, optimizer, preprocess=None, group=None):
    """``step(batch) -> (loss, tb)``: one update of ``model`` from a batch
    dict ('points' (B, N, 3 + C), 'gt_boxes' (B, T, 8); a voxel detector's
    ``voxel_batch(mode='train')`` with the gt boxes) on its device. The
    optional ``preprocess`` (``make_stability_preprocess``) runs first,
    without gradients, its noise from a CPU ``torch.Generator`` seeded with
    the optimizer's update count (the JAX step's ``fold_in(PRNGKey(0),
    step)``). The model reads the step's RoI-sampling and dropout
    generators from ``batch['rngs']`` (``step_rngs`` of the update count).
    So a resumed run draws the same numbers. The loss and the tb terms come
    back as detached tensors on the device, so a step waits for nothing.

    With a process ``group`` (``parallel.world_group()``), ``batch`` is
    this rank's share of the joined batch (the same shape on every rank),
    the forward runs under ``DistributedDataParallel`` over ``group``
    (``broadcast_buffers=False``: global BatchNorm keeps every rank's
    buffers equal) and at world > 1 inside ``parallel.step_group`` over a
    group of its own: BatchNorm statistics, loss normalizers and draws are
    the joined batch's, each rank's loss is its share of the joined
    batch's loss, and the rank backpropagates ``world`` times it, so that
    DDP's mean of the gradients is the joined batch's gradient; the clip
    and the update then see it. The loss and tb terms returned are the
    joined batch's. At world > 1 ``require_global_losses`` must pass.
    DDP searches for parameters without a gradient only where a step may
    leave some (``_unused_parameters``)."""
    forward, collectives, world = model, None, 1
    if group is not None:
        world = dist.get_world_size(group)
        if world > 1:
            require_global_losses(model)
            collectives = parallel.new_step_group(group)
        forward = DistributedDataParallel(
            model, process_group=group, broadcast_buffers=False,
            find_unused_parameters=_unused_parameters(model))

    def train_step(batch):
        with parallel.step_group(collectives):
            if preprocess is not None:
                with torch.no_grad():
                    batch = preprocess(
                        batch, torch.Generator().manual_seed(optimizer.count))
            model.train()
            out = forward(dict(batch, rngs=step_rngs(optimizer.count)))
            loss, tb = model.loss(out)
            optimizer.zero_grad()
            (loss * world if world > 1 else loss).backward()
            optimizer.step()
            loss, tb = parallel.sum_terms(loss.detach(), tb)
        return loss, {k: v.detach() if torch.is_tensor(v) else v
                      for k, v in tb.items()}
    return train_step


def make_eval_step(model, post_cfg, preprocess=None, class_names=None):
    """``step(batch, generator=None) -> (dets, batch_box_preds)``: the
    optional ``preprocess`` (``make_stability_preprocess``; the noise of its
    ``random`` method from ``generator``, a seed-0 ``torch.Generator`` when
    None, as the JAX eval step uses ``PRNGKey(0)``), the forward in eval mode without gradients
    and the configured NMS (``post_processing``; ``class_names``, the
    config's CLASS_NAMES, for SECOND-IoU's score_by_class)."""
    def eval_step(batch, generator: torch.Generator | None = None):
        model.eval()
        with torch.no_grad():
            if preprocess is not None:
                if generator is None:
                    generator = torch.Generator().manual_seed(0)
                batch = preprocess(batch, generator)
            out = model(batch)
            return post_processing(out, post_cfg, class_names), \
                out['batch_box_preds']
    return eval_step


class StabilityPreprocess:
    """SPSNet's preprocess: the frozen ``GenerateCenter`` (``model``, in
    eval mode) gives the stds, then ``delete_number`` points per scene go
    (``stability.hook.apply_stability_hook``). ``preprocess(batch,
    generator)`` draws the (B, N) noise of the ``random`` method from
    ``generator``, a CPU ``torch.Generator``, so a seed gives the same noise
    on every device (in a data-parallel step, this rank's rows of the
    joined batch's noise, ``parallel.draw_rows``); the ``stability``
    method draws none."""

    def __init__(self, model, delete_number: int, method: str):
        self.model = model
        self.delete_number = delete_number
        self.method = method

    def __call__(self, batch, generator: torch.Generator):
        noise = None
        if self.method == 'random':
            points = batch['points']
            noise = parallel.draw_rows(
                lambda shape, g: torch.rand(shape, generator=g),
                points.shape[:2], generator).to(points.device)
        return apply_stability_hook(self.model, batch, noise,
                                    delete_number=self.delete_number,
                                    method=self.method)


def make_stability_preprocess(hook_cfg, device='cuda',
                              generator: torch.Generator | None = None):
    """The stability preprocess of ``MODEL.STABILITY_HOOK``
    (``spsnet_tpu/runtime/trainer.py:137-173``) on ``device``. With
    ``CKPT`` set, the generator's weights are the state dict at that path
    (written by the port with ``torch.save``); with ``CKPT`` null they are
    drawn from ``generator`` (seed 0 when None), which makes the deletion
    arbitrary but the path complete."""
    device = resolve_device(device)
    model = GenerateCenter(EDict(hook_cfg.MODEL))
    ckpt = hook_cfg.get('CKPT', None)
    if ckpt:
        model.load_state_dict(torch.load(ckpt, map_location='cpu',
                                         weights_only=True))
    else:
        init_weights(model, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return StabilityPreprocess(model, int(hook_cfg.get('DELETE_NUMBER', 500)),
                               str(hook_cfg.get('DELETE_METHOD', 'stability')))


def merge_results_dist(det_annos, group=None):
    """Every rank's eval results (a list of per-frame records) on rank 0
    in dataset order, None on the others (``spsnet_tpu/runtime/trainer.py:
    336-366``, over ``all_gather_object``): ``ShardedSampler`` hands rank
    i the indices i, i + P, ..., so a round-robin interleave restores the
    order; the longer ranks' tails follow. A world of one returns
    ``det_annos``."""
    parts = parallel.all_gather_host(det_annos, group)
    if len(parts) == 1:
        return det_annos
    if parallel.rank(group) != 0:
        return None
    merged = []
    for frames in zip(*parts):
        merged.extend(frames)
    for k in range(min(len(p) for p in parts), max(len(p) for p in parts)):
        merged.extend(p[k] for p in parts if k < len(p))
    return merged


def dedup_by_frame_id(det_annos):
    """``det_annos`` without the sampler's padding repeats: the first
    record of each 'frame_id' (``spsnet_tpu/runtime/trainer.py:310``)."""
    seen, out = set(), []
    for anno in det_annos:
        fid = str(anno.get('frame_id'))
        if fid not in seen:
            seen.add(fid)
            out.append(anno)
    return out


def device_batch(batch, device):
    """The numeric arrays of ``batch`` as tensors on ``device``; other
    entries (frame ids, metadata) stay on the host and are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and (np.issubdtype(v.dtype, np.number)
                                          or v.dtype == np.bool_):
            v = torch.from_numpy(v)
        if torch.is_tensor(v):
            out[k] = v.to(device, non_blocking=True)
    return out


class Trainer:
    """Trains ``model`` (on its device) with ``cfg.OPTIMIZATION``, behind
    the stability preprocess of ``cfg.MODEL.STABILITY_HOOK`` when the
    config has one (SPSNet); saves a checkpoint of the model, the optimizer
    and the step count at the end of each epoch into ``output_dir/ckpt``.
    With a process ``group`` each rank trains on its share of the batch
    (``make_train_step``; the loader's ``sampler``, a ``ShardedSampler``,
    moves to each epoch), rank 0 alone writes the checkpoints, of the
    model itself (no DDP ``module.`` prefix: a checkpoint resumes at any
    world size), and the others wait for it."""

    def __init__(self, cfg, model, output_dir, total_iters_each_epoch: int,
                 logger=None, group=None, sampler=None):
        self.cfg = cfg
        self.model = model
        self.logger = logger
        self.group, self.sampler = group, sampler
        self.rank = 0 if group is None else dist.get_rank(group)
        self.device = next(model.parameters()).device
        self.total_epochs = int(cfg.OPTIMIZATION.NUM_EPOCHS)
        self.total_iters_each_epoch = total_iters_each_epoch
        self.ckpt = CheckpointManager(
            Path(output_dir) / 'ckpt',
            max_to_keep=int(cfg.OPTIMIZATION.get('MAX_CKPT_SAVE_NUM', 20)))
        self.optimizer = build_optimizer(cfg.OPTIMIZATION, model.parameters(),
                                         total_iters_each_epoch,
                                         self.total_epochs)
        hook = cfg.get('MODEL', {}).get('STABILITY_HOOK', None)
        self.preprocess = None if hook is None else \
            make_stability_preprocess(hook, device=self.device)
        self.train_step = make_train_step(model, self.optimizer,
                                          self.preprocess, group)

    def state_dict(self):
        return {'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict()}

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint, if any: model, optimizer state and
        step count. Returns the epochs it completed (0 without one)."""
        state, step = self.ckpt.restore(map_location=self.device)
        if state is None:
            return 0
        self.model.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['optimizer'])
        if self.logger:
            self.logger.info('auto-resumed from epoch %d', step)
        return step

    def train(self, train_loader, start_epoch: int = 0, log_every: int = 50):
        """Epochs ``start_epoch`` .. NUM_EPOCHS - 1 over ``train_loader`` (an
        iterable of batch dicts). SIGTERM or SIGUSR1 stops the loop at the
        next step boundary without a checkpoint: checkpoint k means k epochs
        completed, so resume redoes the interrupted epoch; with a group of
        more than one rank, all stop when one has the signal. Returns the
        epochs completed."""
        stop = {'hit': False}

        def on_signal(signum, frame):
            stop['hit'] = True

        saved = []
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                saved.append((sig, signal.signal(sig, on_signal)))
            except ValueError:  # not the main thread
                pass
        try:
            for epoch in range(start_epoch, self.total_epochs):
                if self.sampler is not None:
                    self.sampler.set_epoch(epoch)
                t0 = time.perf_counter()
                for n_iter, batch in enumerate(train_loader, 1):
                    loss, _ = self.train_step(device_batch(batch,
                                                           self.device))
                    if self._any_rank(stop['hit']):
                        if self.logger:
                            self.logger.info(
                                'stop signal in epoch %d: exiting without '
                                'a checkpoint', epoch)
                        return epoch
                    if self.logger and n_iter % log_every == 0:
                        self.logger.info('epoch %d iter %d loss %.4f', epoch,
                                         n_iter, float(loss))
                if self.rank == 0:
                    self.ckpt.save(epoch + 1, self.state_dict())
                if self.group is not None:
                    dist.barrier(self.group)
                if self.logger:
                    self.logger.info('epoch %d done in %.1fs', epoch,
                                     time.perf_counter() - t0)
        finally:
            for sig, handler in saved:
                signal.signal(sig, handler)
        return self.total_epochs

    def _any_rank(self, hit: bool) -> bool:
        """``hit`` on any rank of the group (one all-reduce a step at world
        > 1), so that every rank stops at the same step."""
        if self.group is None or dist.get_world_size(self.group) == 1:
            return hit
        flag = torch.tensor([float(hit)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())
