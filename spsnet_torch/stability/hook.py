"""SPSNet's stability hook: the frozen stability model's stds, then the
deletion of ``delete_number`` points per scene.

Port of ``spsnet_tpu/stability/hook.py:63-132`` (reference
``backbones_2d/map_to_bev/PAGNet_encoding.py``). Every scene loses exactly
``delete_number`` points (500 in SPSNet.yaml):

- with more foreground points than that, the ``delete_number`` foreground
  points of LOWEST stds go (the reference keeps the highest-stds foreground,
  ``PAGNet_encoding.py:55``);
- else all foreground points go, and background points fill the rest.

One stable sort per scene does both: foreground keys are the stds (the
``random`` method: uniform noise), background keys 1e9. The JAX package
adds noise in [0, 1) to the background's 1e9, but the ulp of fp32 at 1e9 is
64, so every background key is exactly 1e9 there too, and the background
points that go are the lowest-indexed ones, in both packages: the sort must
be stable (``torch.argsort(..., stable=True)``, ``jnp.argsort``'s order),
on the card too. Only the ``random`` method reads noise: a (B, N) tensor in
[0, 1) that the caller draws.
"""
from __future__ import annotations

import torch

from .. import ops

_BIG = 1e9


def stability_delete_points(points, stds, fake_labels, noise=None,
                            delete_number: int = 500,
                            method: str = 'stability'):
    """
    Args:
        points: (B, N, C); stds: (B, N); fake_labels: (B, N) int (0 =
            background); noise: (B, N) float32 in [0, 1), read by the
            ``random`` method only.
        method: ``stability`` (the lowest-stds foreground first) or
            ``random`` (the foreground in noise order first).
    Returns:
        new_points (B, N - delete_number, C), keep_idx (B, N - delete_number)
        int64 indices into N, in ascending key order.
    """
    fg = fake_labels > 0
    if method == 'stability':
        key = torch.where(fg, stds, _BIG)
    elif method == 'random':
        if noise is None:
            raise ValueError('the random method needs noise')
        key = torch.where(fg, noise, _BIG)
    else:
        raise NotImplementedError(method)
    order = torch.argsort(key, dim=-1, stable=True)
    keep_idx = order[:, delete_number:]
    return ops.gather_points(points, keep_idx), keep_idx


def fake_labels_from_boxes(points, gt_boxes):
    """(B, N, 3 + C) points, (B, T, 8) gt boxes (class in the last column,
    zero rows as padding) -> (B, N) int64: the class of the first box that
    contains each point, 0 for none (``hook.py:105-116``)."""
    box_idx = ops.points_in_boxes(points[..., :3].contiguous(),
                                  gt_boxes[..., :7])
    cls = gt_boxes[..., -1].to(torch.int64).gather(1, box_idx.clamp(min=0))
    return torch.where(box_idx >= 0, cls, 0)


def apply_stability_hook(generator, batch, noise=None,
                         delete_number: int = 500,
                         method: str = 'stability'):
    """Run the frozen stability model ``generator`` (a ``GenerateCenter`` in
    eval mode) and the deletion; returns the batch with 'points' (B, N -
    delete_number, C) and 'stds' gathered to the kept points (and
    'fake_labels' / 'sem_labels' when present). The foreground comes from
    'fake_labels', else from 'gt_boxes'."""
    with torch.no_grad():
        stds = generator(batch)['stds']
    if 'fake_labels' in batch:
        fake_labels = batch['fake_labels']
    elif 'gt_boxes' in batch:
        fake_labels = fake_labels_from_boxes(batch['points'],
                                             batch['gt_boxes'])
    else:
        raise KeyError(
            'stability hook needs fake_labels or gt_boxes in the batch')
    new_points, keep_idx = stability_delete_points(
        batch['points'], stds, fake_labels, noise,
        delete_number=delete_number, method=method)
    out = dict(batch)
    out['points'] = new_points
    out['stds'] = stds.gather(1, keep_idx)
    for key in ('fake_labels', 'sem_labels'):
        if key in batch:
            out[key] = batch[key].gather(1, keep_idx)
    return out
