"""The stability model's own train step (``tools/train_stability.py:81-97``;
reference ``stability_generate/train.py``): a training forward of
``GenerateCenter`` (BatchNorm on the batch's statistics, its running
statistics moved by flax's rule), ``generate_center_loss``, backward, and
the configured optimizer (``runtime/optimization.py``: the global-norm clip,
then ``adam_onecycle`` in ``tools/cfgs/stability/sf_unc.yaml``).
"""
from __future__ import annotations

from ..utils.common import step_generator as latent_generator
from .model import generate_center_loss


def make_stability_train_step(model, optimizer, seed: int):
    """``step(batch) -> (loss, tb)``: one update of the stability model
    ``model`` (a ``GenerateCenter`` on its device) from a batch dict
    ('points' (B, N, 3 + C), 'gt_boxes' (B, T, 8 or 10)) with
    ``optimizer`` (``runtime.optimization.build_optimizer``), its latent
    from ``latent_generator(seed, optimizer.count)``. The loss and the tb
    terms come back as detached tensors on the device, so a step waits for
    nothing."""
    def train_step(batch):
        model.train()
        ret = model(batch, latent_generator(seed, optimizer.count))
        loss, tb = generate_center_loss(model, ret, batch['gt_boxes'])
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in tb.items()}
    return train_step
