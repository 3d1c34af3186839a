"""Data parallel over ``torch.distributed``: joining the job, the rows of a
batch that a rank holds, and the collectives of the train step.

Counterpart of ``spsnet_tpu/parallel/mesh.py`` and
``spsnet_tpu/utils/jax_setup.py:11`` (``maybe_init_distributed``). The JAX
package runs one program over the global batch (GSPMD); the port runs one
process a device under ``DistributedDataParallel``. For a rank's step to
train the objective of the joined batch, three things inside it are
global, as they are in that one program:

- BatchNorm's statistics (``models.blocks``, through ``sum_over_ranks``);
- each batch-level loss normalizer (a count of positives, ``B``): the
  losses divide by ``global_sum`` of the rank's count;
- the random draws (the stability hook's noise, the RoI sampling, the
  dropout masks): each rank draws the joined batch's shape and keeps its
  own rows (``draw_rows``), so frame i gets the same numbers wherever it
  lands.

They take effect inside ``step_group(group)``, which the train step
enters at world > 1. Outside it, or at world 1, every function here acts
on the local batch alone, bit for bit as without a group. Every rank
holds the same local batch shape (``host_local_batch_size``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(device, backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); a ``file://`` store serves processes started by
    hand. The backend follows the device, ``nccl`` for CUDA and ``gloo``
    for the CPU, unless ``backend`` names another. A CUDA device without
    an index becomes ``cuda:LOCAL_RANK`` and is made current before the
    first collective; ``cuda`` without a card raises, as
    ``models.resolve_device`` does. Nothing here swaps the device or the
    backend on its own."""
    from ..models.detectors import resolve_device
    device = resolve_device(device)
    if rank is None:
        rank = int(os.environ['RANK'])
    if world_size is None:
        world_size = int(os.environ['WORLD_SIZE'])
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda', int(os.environ.get('LOCAL_RANK',
                                                             rank)))
        torch.cuda.set_device(device)
    if backend is None:
        backend = {'cuda': 'nccl', 'cpu': 'gloo'}[device.type]
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            rank=rank, world_size=world_size)
    return device


def world_group():
    """The default group of an initialized job (for ``make_train_step``
    and ``Trainer``)."""
    if not dist.is_initialized():
        raise RuntimeError('no process group: call init_distributed first')
    return dist.group.WORLD


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world(group=None) -> int:
    """The ranks in ``group`` (1 without a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def host_local_batch_size(global_batch: int) -> int:
    """The frames a rank loads of a global batch over the default group's
    ranks; raises when they do not divide it."""
    n = world()
    if global_batch % n:
        raise ValueError(f'global batch {global_batch} not divisible by '
                         f'{n} processes')
    return global_batch // n


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous block of the leading axis of each tensor
    or numeric array of ``batch``, as ``shard_batch`` places a global
    batch; a leading axis that ``world`` does not divide (a ragged eval
    tail) is replicated, and other entries pass through."""
    out = {}
    for k, v in batch.items():
        if (torch.is_tensor(v) or (isinstance(v, np.ndarray)
                                   and v.dtype != object)) and v.ndim >= 1 \
                and v.shape[0] % world == 0:
            n = v.shape[0] // world
            v = v[rank * n:(rank + 1) * n]
        out[k] = v
    return out


def all_gather_host(values: Any, group=None) -> list:
    """``values`` of every rank, in rank order (``all_gather_object``)."""
    n = world(group)
    if n == 1:
        return [values]
    out = [None] * n
    dist.all_gather_object(out, values, group=group)
    return out


def new_step_group(group):
    """A group of ``group``'s ranks for the step's own collectives (BN
    statistics, normalizers, the logged terms), so that their order never
    interleaves with DDP's bucket all-reduces on ``group``, which DDP
    launches from autograd hooks as gradients become ready. Every rank of
    the job calls it, in the same order."""
    return dist.new_group(dist.get_process_group_ranks(group),
                          backend=dist.get_backend(group))


class _Step:
    group = None
    rank = 0
    world = 1


@contextlib.contextmanager
def step_group(group):
    """Inside: BatchNorm takes the statistics of ``group``'s joined batch,
    ``global_sum`` sums over it and ``draw_rows`` draws its shape. None,
    or a group of one rank, changes nothing."""
    saved = (_Step.group, _Step.rank, _Step.world)
    if group is not None and dist.get_world_size(group) > 1:
        _Step.group, _Step.rank, _Step.world = \
            group, dist.get_rank(group), dist.get_world_size(group)
    try:
        yield
    finally:
        _Step.group, _Step.rank, _Step.world = saved


def step_world() -> int:
    """The ranks of the active step (1 outside ``step_group``)."""
    return _Step.world


def step_rank() -> int:
    """This rank's place in the active step (0 outside ``step_group``)."""
    return _Step.rank


def global_sum(t):
    """``t`` summed over the active step's ranks, detached: a count or a
    weight sum that normalizes a loss. ``t`` itself at world 1."""
    if _Step.world == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_Step.group)
    return t


def global_count(n: int) -> int:
    """A count that every rank holds alike (its batch size, its points):
    ``n`` times the active step's ranks."""
    return n * _Step.world


def global_mean(x):
    """The mean of ``x`` over the joined batch (each rank's share: its sum
    over the joined count); ``x.mean()`` at world 1."""
    if _Step.world == 1:
        return x.mean()
    return x.sum() / global_count(x.numel())


class _GroupSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: each
    rank's input then gets the gradient of every rank's loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over_ranks(t):
    """``t`` summed over the active step's ranks (inside a step of more
    than one rank), differentiably."""
    return _GroupSum.apply(t, _Step.group)


def draw_rows(draw, shape, generator):
    """``draw(shape, generator)``; at world > 1 inside ``step_group``, the
    draw of the joined batch (the leading axis, frame-major, ``world``
    times as long) and this rank's block of it, so that a frame's numbers
    do not depend on the rank that holds it."""
    if _Step.world == 1:
        return draw(tuple(shape), generator)
    n = shape[0]
    full = draw((n * _Step.world, *shape[1:]), generator)
    return full[_Step.rank * n:(_Step.rank + 1) * n]


def gather_rows(t):
    """The joined tensor of the active step's ranks along the leading axis,
    in rank order, detached; ``t`` itself at world 1. One all-reduce into
    a zero buffer of ``world`` blocks, each rank filling its own: gloo
    offers CUDA tensors only ``all_reduce`` and ``broadcast``."""
    if _Step.world == 1:
        return t
    n = t.shape[0]
    out = t.new_zeros((n * _Step.world, *t.shape[1:]))
    out[_Step.rank * n:(_Step.rank + 1) * n] = t.detach()
    dist.all_reduce(out, group=_Step.group)
    return out


def sum_terms(loss, tb: dict):
    """The joined batch's loss and tb terms from a rank's shares (each an
    additive part: its loss over the global normalizers, its local
    counts), in one all-reduce; unchanged at world 1."""
    if _Step.world == 1:
        return loss, tb
    keys = [k for k, v in tb.items() if torch.is_tensor(v)]
    parts = torch.stack([loss.detach().float().reshape(())] +
                        [tb[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(parts, group=_Step.group)
    out = dict(tb)
    out.update({k: parts[i + 1] for i, k in enumerate(keys)})
    return parts[0], out
