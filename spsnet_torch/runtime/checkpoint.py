"""Checkpoints: a ring buffer of ``torch.save`` files with auto-resume
(``spsnet_tpu/runtime/checkpoint.py:17-44``; reference
``train_utils.py:125-172``): epoch-granular saves, the oldest removed first
beyond ``max_to_keep``, and resume restores what was saved."""
from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r'checkpoint_epoch_(\d+)\.pth')


class CheckpointManager:

    def __init__(self, ckpt_dir, max_to_keep: int = 20):
        if max_to_keep < 1:
            raise ValueError(f'max_to_keep must be >= 1, got {max_to_keep}')
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> Path:
        return self.ckpt_dir / f'checkpoint_epoch_{step}.pth'

    def all_steps(self):
        """Saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.fullmatch, os.listdir(self.ckpt_dir)) if m)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> Path:
        """Write ``state`` as checkpoint ``step`` (atomically: a reader
        never sees half a file), then remove the oldest beyond
        ``max_to_keep``."""
        path = self.path(step)
        tmp = path.with_name(path.name + '.tmp')
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            self.path(old).unlink()
        return path

    def restore(self, step=None, map_location='cpu'):
        """(state, step) of checkpoint ``step`` (the latest when None), or
        (None, None) when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True), step
