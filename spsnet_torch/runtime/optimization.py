"""Optimizers and LR/momentum schedules, as the JAX package builds them
with optax (``spsnet_tpu/runtime/optimization.py:16-94``; reference
``tools/train_utils/optimization/``).

``adam_onecycle`` is fastai's Adam with true weight decay under a cosine
one-cycle of LR and momentum: here ``torch.optim.AdamW`` (decoupled decay on
every parameter, beta2 0.99, eps 1e-8), whose ``lr`` and ``betas[0]`` are set
before each step from the schedules at the count of steps taken so far, as
``optax.inject_hyperparams`` evaluates them. ``adam`` and ``sgd`` take an
L2 term into the gradient under a step-decay LR. The gradients are clipped
to a global norm first, exactly as ``optax.clip_by_global_norm``.
``torch.optim.lr_scheduler.OneCycleLR`` is another curve and is not used.
"""
from __future__ import annotations

import math

import torch


def annealing_cos(start, end, pct):
    return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)


def onecycle_schedules(total_steps, lr_max, moms, div_factor, pct_start):
    """(lr_fn, mom_fn), each step -> value: the LR rises from
    ``lr_max / div_factor`` to ``lr_max`` over the first ``pct_start`` of
    the steps and falls to ``lr_max / div_factor / 1e4``; the momentum moves
    the other way between ``moms[0]`` and ``moms[1]``."""
    low_lr = lr_max / div_factor

    def phase(step, up, down):
        pct = min(max(step / max(total_steps, 1), 0.0), 1.0)
        if pct < pct_start:
            return annealing_cos(*up, pct / pct_start)
        return annealing_cos(*down, (pct - pct_start) / (1 - pct_start))

    def lr_fn(step):
        return phase(step, (low_lr, lr_max), (lr_max, low_lr / 1e4))

    def mom_fn(step):
        return phase(step, (moms[0], moms[1]), (moms[1], moms[0]))

    return lr_fn, mom_fn


def step_decay_schedule(optim_cfg, total_iters_each_epoch):
    """LambdaLR step decay (``optimization/__init__.py:44-51``): the LR times
    ``LR_DECAY`` at each epoch of ``DECAY_STEP_LIST``, held above
    ``LR_CLIP``."""
    decay_steps = [x * total_iters_each_epoch
                   for x in optim_cfg.DECAY_STEP_LIST]
    base_lr = float(optim_cfg.LR)

    def lr_fn(step):
        decay = 1.0
        for ds in decay_steps:
            if step >= ds:
                decay *= optim_cfg.LR_DECAY
        return base_lr * max(decay, optim_cfg.LR_CLIP / base_lr)

    return lr_fn


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float):
    """``optax.clip_by_global_norm`` in place: when the global L2 norm of
    ``grads`` is at least ``max_norm``, each becomes
    ``(g / norm) * max_norm``. Returns the norm (a 0-dim tensor; no host
    sync)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class ScheduledOptimizer:
    """A torch optimizer whose LR (and Adam's beta1) follow the schedules,
    stepped after a global-norm clip. ``step`` counts the updates; the count
    is part of ``state_dict``."""

    def __init__(self, inner, lr_fn, mom_fn, max_norm: float):
        self.inner, self.lr_fn, self.mom_fn = inner, lr_fn, mom_fn
        self.max_norm = max_norm
        self.params = [p for g in inner.param_groups for p in g['params']]
        self.count = 0
        self.grad_norm = None

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self):
        """Clip, set this step's hyperparameters, update. A parameter that
        got no gradient takes a zero one, so weight decay still reaches it
        as optax's does. ``grad_norm`` keeps the global norm before the
        clip (a 0-dim tensor on the device)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.grad_norm = clip_by_global_norm_([p.grad for p in self.params],
                                              self.max_norm)
        lr = self.lr_fn(self.count)
        for group in self.inner.param_groups:
            group['lr'] = lr
            if self.mom_fn is not None:
                group['betas'] = (self.mom_fn(self.count), group['betas'][1])
        self.inner.step()
        self.count += 1

    def state_dict(self):
        return {'optimizer': self.inner.state_dict(), 'count': self.count}

    def load_state_dict(self, state):
        self.inner.load_state_dict(state['optimizer'])
        self.count = int(state['count'])


def build_optimizer(optim_cfg, params, total_iters_each_epoch: int,
                    total_epochs: int) -> ScheduledOptimizer:
    """The configured optimizer (``OPTIMIZER``: adam_onecycle, adam, sgd)
    over ``params``, clipped to ``GRAD_NORM_CLIP`` (10 by default)."""
    params = [p for p in params if p.requires_grad]
    max_norm = float(optim_cfg.get('GRAD_NORM_CLIP', 10))
    wd = float(optim_cfg.WEIGHT_DECAY)
    name = optim_cfg.OPTIMIZER
    if name == 'adam_onecycle':
        lr_fn, mom_fn = onecycle_schedules(
            total_iters_each_epoch * total_epochs, float(optim_cfg.LR),
            [float(m) for m in optim_cfg.MOMS], float(optim_cfg.DIV_FACTOR),
            float(optim_cfg.PCT_START))
        inner = torch.optim.AdamW(params, lr=lr_fn(0),
                                  betas=(mom_fn(0), 0.99), eps=1e-8,
                                  weight_decay=wd)
        return ScheduledOptimizer(inner, lr_fn, mom_fn, max_norm)
    lr_fn = step_decay_schedule(optim_cfg, total_iters_each_epoch)
    if name == 'adam':
        inner = torch.optim.Adam(params, lr=lr_fn(0), weight_decay=wd)
    elif name == 'sgd':
        inner = torch.optim.SGD(params, lr=lr_fn(0),
                                momentum=float(optim_cfg.MOMENTUM),
                                weight_decay=wd)
    else:
        raise NotImplementedError(name)
    return ScheduledOptimizer(inner, lr_fn, None, max_norm)
