"""The stability model's own train step (``tools/train_stability.py:81-97``;
reference ``stability_generate/train.py``): a training forward of
``GenerateCenter`` (BatchNorm on the batch's statistics, its running
statistics moved by flax's rule), ``generate_center_loss``, backward, and
the configured optimizer (``runtime/optimization.py``: the global-norm clip,
then ``adam_onecycle`` in ``tools/cfgs/stability/sf_unc.yaml``). Given a
process group, the step trains the joined batch's objective under
``DistributedDataParallel``, as ``runtime.trainer.make_train_step`` does
(the JAX step over ``shard_batch``, ``tools/train_stability.py:109``).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .. import parallel
from ..utils.common import step_generator as latent_generator
from .model import generate_center_loss


def make_stability_train_step(model, optimizer, seed: int, group=None):
    """``step(batch) -> (loss, tb)``: one update of the stability model
    ``model`` (a ``GenerateCenter`` on its device) from a batch dict
    ('points' (B, N, 3 + C), 'gt_boxes' (B, T, 8 or 10)) with
    ``optimizer`` (``runtime.optimization.build_optimizer``), its latent
    from ``latent_generator(seed, optimizer.count)``. The loss and the tb
    terms come back as detached tensors on the device, so a step waits for
    nothing.

    With a process ``group`` (``parallel.world_group()``), ``batch`` is
    this rank's share of the joined batch (the same shape on every rank)
    and the forward runs under ``DistributedDataParallel`` over ``group``
    (``broadcast_buffers=False``); at world > 1 inside
    ``parallel.step_group`` over a group of its own, BatchNorm statistics,
    the loss's counts and the latent draw are the joined batch's, the rank
    backpropagates ``world`` times its share of the joined loss, and the
    loss and tb terms returned are the joined batch's."""
    forward, collectives, world = model, None, 1
    if group is not None:
        world = dist.get_world_size(group)
        if world > 1:
            collectives = parallel.new_step_group(group)
        # every parameter gets a gradient each step
        forward = DistributedDataParallel(model, process_group=group,
                                          broadcast_buffers=False)

    def train_step(batch):
        with parallel.step_group(collectives):
            model.train()
            ret = forward(batch, latent_generator(seed, optimizer.count))
            loss, tb = generate_center_loss(model, ret, batch['gt_boxes'])
            optimizer.zero_grad()
            (loss * world if world > 1 else loss).backward()
            optimizer.step()
            loss, tb = parallel.sum_terms(loss.detach(), tb)
        return loss.detach(), {k: v.detach() for k, v in tb.items()}
    return train_step
